"""Ellipse fit and abdominal circumference, host numpy.

Copy of the host half of ``att_aspp_unet_tpu/measure/ellipse.py``: the
Halir–Flusser direct least-squares fit over the mask's 4-neighbour boundary
pixels in float64 numpy, Ramanujan-II circumference, and the reference's
arc-length fallback for masks with fewer than 5 boundary pixels.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np


def ellipse_circumference(a: float, b: float) -> float:
    """Ramanujan's second approximation; a, b are SEMI-axes."""
    a, b = np.asarray(a), np.asarray(b)
    h = ((a - b) ** 2) / np.maximum((a + b) ** 2, 1e-12)
    return math.pi * (a + b) * (1.0 + 3.0 * h / (10.0 + np.sqrt(4.0 - 3.0 * h)))


def _fit_ellipse_np(mask: np.ndarray):
    """Halir–Flusser reduced fit over the 4-neighbour boundary-pixel set,
    in float64 numpy.

    Returns (cx, cy, major, minor, valid); axes are FULL lengths in pixels.
    """
    m = np.asarray(mask) > 0
    fp = np.pad(m, 1)
    interior = (fp[:-2, 1:-1] & fp[2:, 1:-1]
                & fp[1:-1, :-2] & fp[1:-1, 2:])
    ys, xs = np.nonzero(m & ~interior)
    n = xs.size
    if n < 5:
        return 0.0, 0.0, 0.0, 0.0, False
    x = xs.astype(np.float64)
    y = ys.astype(np.float64)
    cx = x.mean()
    cy = y.mean()
    u0 = x - cx
    v0 = y - cy
    s = math.sqrt(max(np.mean(u0 * u0 + v0 * v0), 1e-6))
    u = u0 / s
    v = v0 / s

    def msum(e1, e2):
        return float(np.sum(u ** e1 * v ** e2))

    S1 = np.array([[msum(4, 0), msum(3, 1), msum(2, 2)],
                   [msum(3, 1), msum(2, 2), msum(1, 3)],
                   [msum(2, 2), msum(1, 3), msum(0, 4)]])
    S2 = np.array([[msum(3, 0), msum(2, 1), msum(2, 0)],
                   [msum(2, 1), msum(1, 2), msum(1, 1)],
                   [msum(1, 2), msum(0, 3), msum(0, 2)]])
    S3 = np.array([[msum(2, 0), msum(1, 1), msum(1, 0)],
                   [msum(1, 1), msum(0, 2), msum(0, 1)],
                   [msum(1, 0), msum(0, 1), float(n)]])
    T = -np.linalg.solve(S3 + 1e-9 * np.eye(3), S2.T)
    R = S1 + S2 @ T
    C1inv = np.array([[0.0, 0.0, 0.5],
                      [0.0, -1.0, 0.0],
                      [0.5, 0.0, 0.0]])
    M = C1inv @ R

    lams, vecs = np.linalg.eig(M)
    real = np.abs(lams.imag) < 1e-8 * (1.0 + np.abs(lams.real))
    vr = vecs.real
    kappa = 4.0 * vr[0] * vr[2] - vr[1] ** 2
    kappa = np.where(real, kappa, -np.inf)
    best = int(np.argmax(kappa))
    if not (kappa[best] > 1e-12):
        return 0.0, 0.0, 0.0, 0.0, False
    a1 = vr[:, best]
    a2 = T @ a1
    A, B, C = a1
    D, E, F = a2

    den = 4.0 * A * C - B * B
    if abs(den) < 1e-12:
        den = 1e-12
    un = (B * E - 2.0 * C * D) / den
    vn = (B * D - 2.0 * A * E) / den
    mu = A * un * un + B * un * vn + C * vn * vn + D * un + E * vn + F

    half = (A + C) / 2.0
    delta = math.sqrt(((A - C) / 2.0) ** 2 + (B / 2.0) ** 2)

    def semi(l):
        l = l if abs(l) >= 1e-12 else 1e-12
        return math.sqrt(max(-mu / l, 0.0))

    semi_a = semi(half - delta)
    semi_b = semi(half + delta)
    major = 2.0 * max(semi_a, semi_b) * s
    minor = 2.0 * min(semi_a, semi_b) * s
    valid = (math.isfinite(major) and math.isfinite(minor) and minor > 0)
    return cx + un * s, cy + vn * s, major, minor, valid


def measure_ac_mm(mask: np.ndarray, spacing: Tuple[float, float]) -> float:
    """Abdominal circumference in mm of a single binary mask.

    Ellipse fit when ≥5 boundary pixels support it; otherwise the
    reference's fallback: traced-contour arc length × mean spacing.  Empty
    mask → 0.0.
    """
    m = np.asarray(mask)
    if (m > 0).sum() == 0:
        return 0.0
    # cv2 fits the LARGEST external contour; restrict to the largest
    # component so stray blobs don't perturb the fit (the refine pipeline
    # already guarantees a single component, this covers raw masks)
    from scipy import ndimage as ndi

    labels, n = ndi.label(m > 0, structure=np.ones((3, 3), np.uint8))
    if n > 1:
        sizes = np.bincount(labels.ravel())
        sizes[0] = 0
        m = (labels == sizes.argmax()).astype(np.uint8)
    cx, cy, major, minor, valid = _fit_ellipse_np(m)
    if valid:
        a_mm = major / 2.0 * float(spacing[0])
        b_mm = minor / 2.0 * float(spacing[1])
        return float(ellipse_circumference(a_mm, b_mm))
    from .contour import arc_length, trace_contour
    c = trace_contour(m)
    return arc_length(c, closed=True) * float(sum(spacing) / 2.0)
