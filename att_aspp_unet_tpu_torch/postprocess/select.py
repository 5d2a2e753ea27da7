"""Frame selection.  Counterpart of
``att_aspp_unet_tpu/postprocess/select.py``: the max-area pick of the ROI
path (tensors, on the device) and the reference-parity top-K by area with the
winner by traced-contour circularity (host numpy)."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

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


def select_max_area_frame(masks: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, H, W) -> (mask2d uint8, frame): the first frame with the largest
    foreground area; frame = -1 and a zero mask when the whole stack is empty
    (the contract of ``select_fetal_abdomen_mask_and_frame``).  ``frame`` is
    a 0-d int64 tensor on the masks' device."""
    fg = masks > 0
    areas = fg.sum(dim=(-2, -1), dtype=torch.long)
    idx = torch.argmax(areas)
    empty = areas[idx] == 0
    frame = torch.where(empty, torch.full_like(idx, -1), idx)
    sel = fg.index_select(0, idx[None])[0] & ~empty
    return sel.to(torch.uint8), frame
