"""Mask refinement and the ROI path's postprocess.  Counterpart of
``att_aspp_unet_tpu/postprocess/refine.py``.

- ``refine_mask`` of the reference: drop components below max(20 px, 0.15 %
  of the image), keep the largest, 7x7-ellipse close, fill holes — batched
  over frames.  The JAX engine's bucket-padded refine (a compile-reuse measure
  on the TPU) is replaced by refining at the true size, which gives the same
  masks.
- ``postprocess_roi_stack``: threshold 0.05, the max-area frame, one 3x3
  dilation, its largest 8-connected component, zeros elsewhere.
- ``postprocess_softmax_stack``: the baseline's (C, N, H, W) softmax stack
  -> labels: soft threshold, argmax over the classes, the largest
  6-connected 3-D component of each class."""

from __future__ import annotations

import numpy as np
import torch

from .cc import largest_component
from .morphology import (binary_closing, binary_dilation, fill_holes,
                         structuring_ellipse)


def _refine_core(masks, min_area: int, close_kernel: int):
    kept = largest_component(masks, connectivity=8, min_area=min_area)
    closed = binary_closing(kept, structuring_ellipse(close_kernel))
    filled = fill_holes(closed)
    any_fg = kept.sum(dim=(-2, -1), keepdim=True) > 0
    return torch.where(any_fg, filled, torch.zeros_like(filled)).to(torch.uint8)


def refine_mask(masks: torch.Tensor, min_area_px: int = 20,
                min_area_frac: float = 0.0015,
                close_kernel: int = 7) -> torch.Tensor:
    """Refine binary masks (..., H, W)."""
    H, W = masks.shape[-2], masks.shape[-1]
    min_area = max(min_area_px, int(min_area_frac * H * W))
    return _refine_core(masks, min_area, close_kernel)


def min_area_f32(h: int, w: int, min_area_px: int,
                 min_area_frac: float) -> int:
    """The bucketed refine's minimum area: floor of the f32 product."""
    area = np.float32(min_area_frac) * np.float32(h) * np.float32(w)
    return max(int(min_area_px), int(np.floor(area)))


def refine_mask_true_size(masks: torch.Tensor, min_area_px: int,
                          min_area_frac: float,
                          close_kernel: int) -> torch.Tensor:
    """The JAX engine's refine (``_refine_mask_padded``) at the true size:
    the same masks, with its f32 minimum area."""
    H, W = masks.shape[-2], masks.shape[-1]
    return _refine_core(masks, min_area_f32(H, W, min_area_px, min_area_frac),
                        close_kernel)


def postprocess_roi_stack(prob: torch.Tensor,
                          threshold: float = 0.05) -> torch.Tensor:
    """ROI-path postprocess of an (N, H, W) probability stack -> (N, H, W)
    uint8 mask stack that is zero everywhere except the max-area frame (the
    first one on ties); an all-empty stack gives all zeros."""
    binary = (prob > float(np.float32(threshold))).to(torch.uint8)
    areas = binary.sum(dim=(-2, -1), dtype=torch.long)
    frame_idx = torch.argmax(areas)
    frame = binary.index_select(0, frame_idx[None])[0]
    big = largest_component(binary_dilation(frame, iterations=1),
                            connectivity=8)
    out = torch.zeros_like(binary)
    out.index_copy_(0, frame_idx[None], big[None])
    return out


def postprocess_softmax_stack(softmax: torch.Tensor, threshold: float = 0.5,
                              labels=(1, 2)) -> torch.Tensor:
    """(C, N, H, W) class probabilities -> (N, H, W) uint8 labels.

    Probabilities below ``threshold`` become 0, each pixel takes the class
    of its largest remaining value (the first class on ties, so a pixel with
    nothing left is background), and for each of ``labels`` in order only
    its largest 6-connected component over the whole (N, H, W) stack is
    kept."""
    sm = torch.where(softmax < float(np.float32(threshold)),
                     torch.zeros((), dtype=softmax.dtype,
                                 device=softmax.device), softmax)
    seg = torch.argmax(sm, dim=0).to(torch.uint8)
    del sm
    out = torch.zeros_like(seg)
    for lab in labels:
        keep = largest_component(seg == lab, connectivity=6, ndim=3)
        out.masked_fill_(keep.bool(), lab)
    return out
