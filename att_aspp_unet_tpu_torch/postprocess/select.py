"""Reference-parity frame selection: top-K by area, winner by traced-contour
circularity.  Host numpy, a copy of ``select_best_frame_exact`` in
``att_aspp_unet_tpu/postprocess/select.py``."""

from __future__ import annotations

import numpy as np

from ..measure.contour import circularity_score


def select_best_frame_exact(mask_stack, topk: int = 5) -> int:
    """Top-``topk`` masks by pixel area, winner by 4*pi*A/P^2 of the traced
    external contour.  The candidate order is ``areas.argsort()[::-1]``
    exactly, including its higher-index-first tie order, and ties in the
    score keep the larger-area candidate."""
    ms = np.asarray(mask_stack)
    areas = (ms > 0).reshape(ms.shape[0], -1).sum(axis=1)
    k = max(1, min(topk, len(areas)))
    idx = np.argsort(areas)[::-1][:k]
    scores = [circularity_score(ms[i]) for i in idx]
    return int(idx[int(np.argmax(scores))])
