"""Mask postprocess, frame ranking, selection and the AC of the plain
reference.

- closing (7x7 OpenCV ellipse: dilation with a background border, erosion
  with a foreground border) as footprint counts by ``F.conv2d`` in exact f32;
- connected components, the largest one and hole filling by SciPy
  (``ndimage.label`` 8-connected, ``binary_fill_holes`` 4-connected
  background), which labels in raster order as OpenCV and the port do;
- the candidate rank key (closed area plus 16 px per quarter-resolution cell
  that hole filling adds), refinement (largest component of at least
  max(20 px, 0.15 %) -> close -> fill), the top-5-by-area then
  traced-contour-circularity pick, and the Halir-Flusser ellipse AC with
  Ramanujan-II circumference.

The contour tracer and the ellipse fit are frozen copies of the port's host
numpy (``measure/contour.py`` without its native tracer,
``measure/ellipse.py``), which themselves copy the published pipeline's
OpenCV semantics.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from scipy import ndimage as ndi

CLOSE_KERNEL = 7


def structuring_ellipse(ksize: int) -> np.ndarray:
    """cv2.getStructuringElement(MORPH_ELLIPSE, (k, k))."""
    r = c = ksize // 2
    inv_r2 = 1.0 / (r * r) if r else 0.0
    el = np.zeros((ksize, ksize), np.uint8)
    for i in range(ksize):
        dy = i - r
        if abs(dy) <= r:
            dx = int(round(c * np.sqrt(max(r * r - dy * dy, 0) * inv_r2)))
            el[i, max(c - dx, 0):min(c + dx + 1, ksize)] = 1
    return el


def _count(x: torch.Tensor, fp: torch.Tensor, border: float) -> torch.Tensor:
    """Footprint counts of the 0/1 float stack ``x`` (N, H, W), the outside
    of the image read as ``border``."""
    k = fp.shape[-1] // 2
    xp = F.pad(x[:, None], (k, k, k, k), value=border)
    return F.conv2d(xp, fp[None, None])[:, 0]


def closing(masks: torch.Tensor, ksize: int = CLOSE_KERNEL) -> torch.Tensor:
    """cv2.morphologyEx(MORPH_CLOSE) of a 0/1 stack (N, H, W) -> bool."""
    fp = torch.as_tensor(structuring_ellipse(ksize), dtype=torch.float32,
                         device=masks.device)
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False     # exact integer counts
    try:
        m = (masks > 0).float()
        dil = _count(m, fp, 0.0) > 0.5
        bg = (~dil).float()
        return (_count(bg, fp, 0.0) < 0.5) & dil
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def maxpool4_same(m: np.ndarray) -> np.ndarray:
    """4x4 stride-4 max pool of (N, H, W) with XLA's "SAME" padding (the
    total pad splits low = total // 2, high = the rest)."""
    N, H, W = m.shape

    def pads(n):
        total = max((-(-n // 4) - 1) * 4 + 4 - n, 0)
        return total // 2, total - total // 2

    (pt, pb), (pl, pr) = pads(H), pads(W)
    mp = np.pad(m, ((0, 0), (pt, pb), (pl, pr)))
    Hp, Wp = mp.shape[1:]
    return mp.reshape(N, Hp // 4, 4, Wp // 4, 4).max(axis=(2, 4))


def rank_keys(binary: torch.Tensor, fill_proxy: bool = True) -> np.ndarray:
    """(N, H, W) 0/1 -> (N,) int64 key ~ each frame's area after
    refinement."""
    closed = closing(binary).cpu().numpy()
    raw = closed.reshape(closed.shape[0], -1).sum(1).astype(np.int64)
    if not fill_proxy:
        return raw
    pooled = maxpool4_same(closed)
    cells = pooled.reshape(pooled.shape[0], -1).sum(1)
    filled = np.array([ndi.binary_fill_holes(p).sum() for p in pooled])
    return raw + 16 * (filled - cells).astype(np.int64)


def rank(keys: np.ndarray, ids: np.ndarray) -> np.ndarray:
    """Positions in candidate order: descending key, the higher id first on
    ties."""
    return np.lexsort((-np.asarray(ids), -np.asarray(keys)))


def min_area(h: int, w: int, px: int = 20, frac: float = 0.0015) -> int:
    """max(px, floor of the f32 product frac * h * w)."""
    return max(int(px), int(np.floor(np.float32(frac) * np.float32(h)
                                     * np.float32(w))))


def largest_component(m: np.ndarray, min_px: int = 0) -> np.ndarray:
    """The largest 8-connected component (ties: the first in raster order),
    empty if it has fewer than ``min_px`` pixels."""
    labels, n = ndi.label(m > 0, structure=np.ones((3, 3), np.uint8))
    if n == 0:
        return np.zeros(m.shape, bool)
    sizes = np.bincount(labels.ravel())
    sizes[0] = 0
    best = int(sizes.argmax())
    if sizes[best] < max(int(min_px), 1):
        return np.zeros(m.shape, bool)
    return labels == best


def refine(binary: torch.Tensor) -> np.ndarray:
    """(K, H, W) 0/1 candidates -> refined (K, H, W) uint8."""
    H, W = binary.shape[-2:]
    host = binary.cpu().numpy()
    kept = np.stack([largest_component(m, min_area(H, W)) for m in host])
    closed = closing(torch.as_tensor(kept, device=binary.device)).cpu().numpy()
    out = np.stack([ndi.binary_fill_holes(c) for c in closed])
    out &= kept.reshape(len(kept), -1).any(1)[:, None, None]
    return out.astype(np.uint8)


# clockwise Moore neighbourhood starting at W (dx, dy) in (x, y) coords
_DIRS = [(-1, 0), (-1, -1), (0, -1), (1, -1), (1, 0), (1, 1), (0, 1), (-1, 1)]


def trace_contour(mask: np.ndarray) -> np.ndarray:
    """The outer border of the blob whose first pixel in raster order starts
    it, as (K, 2) (x, y) pixels in Moore-neighbour order (8-connected)."""
    m = (np.asarray(mask) > 0).astype(np.uint8)
    ys, xs = np.nonzero(m)
    if len(ys) == 0:
        return np.zeros((0, 2), np.int32)
    sy, sx = int(ys[0]), int(xs[0])

    H, W = m.shape

    def fg(x, y):
        return 0 <= x < W and 0 <= y < H and m[y, x]

    contour: List[Tuple[int, int]] = [(sx, sy)]
    cur = (sx, sy)
    backtrack = 0           # scan starts toward W (which is background for
    first_state = None      # the raster-first pixel)
    max_steps = int(8 * m.sum() + 8)

    for _ in range(max_steps):
        nxt = None
        for k in range(8):
            d = (backtrack + k) % 8
            dx, dy = _DIRS[d]
            if fg(cur[0] + dx, cur[1] + dy):
                nxt = (cur[0] + dx, cur[1] + dy)
                break
        if nxt is None:
            break                       # isolated single pixel
        # Jacob's criterion: stop when the start pixel is about to be left in
        # the same direction as the very first move
        if first_state is None:
            first_state = (cur, d)
        elif (cur, d) == first_state:
            break
        cur = nxt
        contour.append(cur)
        backtrack = (d + 5) % 8         # restart scan just past the back-pointer

    if len(contour) > 1 and contour[-1] == contour[0]:
        contour.pop()
    return np.array(contour, np.int32)


def arc_length(contour: np.ndarray, closed: bool = True) -> float:
    """cv2.arcLength: polyline length; √2 for diagonal unit steps."""
    c = np.asarray(contour, np.float64)
    if len(c) < 2:
        return 0.0
    seg = np.diff(np.vstack([c, c[:1]]) if closed else c, axis=0)
    return float(np.sqrt((seg ** 2).sum(axis=1)).sum())


def contour_area(contour: np.ndarray) -> float:
    """cv2.contourArea: shoelace polygon area of the pixel-coordinate ring."""
    c = np.asarray(contour, np.float64)
    if len(c) < 3:
        return 0.0
    x, y = c[:, 0], c[:, 1]
    return float(abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1))) / 2)


def circularity_score(mask: np.ndarray) -> float:
    """cv2-parity circularity 4π·A/P² of the traced external contour
    (``test_ablation.py:389-396``: A = cv2.contourArea shoelace, P =
    cv2.arcLength closed).  Single-blob semantics — callers rank masks that
    have already been refined to one component (``refine_mask``)."""
    c = trace_contour(mask)
    if len(c) == 0:
        return 0.0
    peri = arc_length(c, closed=True)
    if peri <= 1e-6:
        return 0.0
    return float(4.0 * np.pi * contour_area(c) / (peri * peri))


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
    c = trace_contour(m)
    return arc_length(c, closed=True) * float(sum(spacing) / 2.0)


def top_by_area(masks: np.ndarray, topk: int = 5) -> np.ndarray:
    """Indices of the ``topk`` largest masks, ``argsort()[::-1]`` order."""
    areas = (masks > 0).reshape(masks.shape[0], -1).sum(axis=1)
    return np.argsort(areas)[::-1][:max(1, min(topk, len(areas)))]


def select_best(masks: np.ndarray, topk: int = 5) -> Tuple[int, List[float]]:
    """(local index of the winner, circularity of each mask): the
    ``topk`` largest masks, the winner by circularity."""
    circ = [circularity_score(m) for m in masks]
    idx = top_by_area(masks, topk)
    return int(idx[int(np.argmax([circ[i] for i in idx]))]), circ
