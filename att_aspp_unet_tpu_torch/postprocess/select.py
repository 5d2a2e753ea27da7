"""Frame selection.  Counterpart of
``att_aspp_unet_tpu/postprocess/select.py``: the max-area pick of the ROI
path (tensors, on the device), the reference-parity top-K by area with the
winner by traced-contour circularity (host numpy), and the Crofton
circularity estimate that the diagnostic outputs report."""

from __future__ import annotations

import math

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


def circularity(mask) -> torch.Tensor:
    """4*pi*A/P^2 per mask of a (..., H, W) stack in f32, 0 where empty, with
    the Crofton perimeter pi/4 x the number of exposed unit edges (the image
    border counts as background)."""
    m = (torch.as_tensor(mask) > 0).to(torch.float32)
    area = m.sum(dim=(-2, -1))
    edges = (torch.diff(m, dim=-1).abs().sum(dim=(-2, -1))
             + torch.diff(m, dim=-2).abs().sum(dim=(-2, -1))
             + m[..., :, 0].sum(-1) + m[..., :, -1].sum(-1)
             + m[..., 0, :].sum(-1) + m[..., -1, :].sum(-1))
    per = edges * (math.pi / 4.0)
    return torch.where(per > 1e-6, 4.0 * math.pi * area / (per * per),
                       torch.zeros_like(per))
