"""Host-side contour tracing (Moore neighbourhood, 8-connected); a copy of
``att_aspp_unet_tpu/measure/contour.py``.

Produces the ordered external border pixel sequence equivalent to
``cv2.findContours(RETR_EXTERNAL, CHAIN_APPROX_NONE)`` output for a single
blob, plus the cv2-compatible ``arcLength`` (closed polyline length, diagonal
steps √2) and ``contourArea`` (shoelace).  Used for the reference's
``len(contour) < 5`` arc-length fallback (``…stage.py:370-374``) and as the
exact-perimeter oracle for the device Crofton estimate.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

# clockwise Moore neighbourhood starting at W (dx, dy) in (x, y) coords
_DIRS = [(-1, 0), (-1, -1), (0, -1), (1, -1), (1, 0), (1, 1), (0, 1), (-1, 1)]


def trace_contour(mask: np.ndarray) -> np.ndarray:
    """Trace the outer border of the largest-start blob in a binary mask.

    Returns an (K, 2) int array of (x, y) border pixels in traversal order.
    Starts at the first foreground pixel in raster order (the same start rule
    border-following algorithms use).  Empty mask → (0, 2).

    Pure Python pixel following (the JAX package's C++ tracer is not
    ported yet).
    """
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
