"""Intensity-centroid ROI cropping and paste-back, batched.

Counterpart of ``att_aspp_unet_tpu/preprocess/roi.py`` (the reference's
``crop_roi_224``): threshold each frame at 1.2 x its mean, take the centroid
of the bright pixels (frame centre if none), cut a ``roi x roi`` window
clamped inside the frame.  The whole stack is one gather over index grids
built from the per-frame origins; the paste-back is one scatter.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def _window_index(origins: torch.Tensor, r_h: int, r_w: int, W: int
                  ) -> torch.Tensor:
    """(N, r_h * r_w) flat indices into an (H, W) frame of the windows whose
    top-left corners are ``origins`` (N, 2) = (y0, x0)."""
    dev = origins.device
    ys = origins[:, 0, None] + torch.arange(r_h, device=dev)[None, :]
    xs = origins[:, 1, None] + torch.arange(r_w, device=dev)[None, :]
    return (ys[:, :, None] * W + xs[:, None, :]).reshape(origins.shape[0], -1)


def crop_roi(frames: torch.Tensor, roi: int = 224
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Crop an (N, H, W) float stack to (N, roi, roi) around per-frame
    intensity centroids.  Returns (patches, origins), origins (N, 2) int64
    (y0, x0).  Frames smaller than ``roi`` are zero-padded bottom/right first.

    The centroid is ``floor(sum(y * m) / count)`` computed exactly, in
    int64 (the same on every device).  The JAX package sums in f32: on a
    562 x 744 frame its sums reach 2e8, and where the centroid lies within
    ~1e-4 of an integer its rounding can move an origin by one pixel
    (``tests/compare_roi_origins.py`` counts such frames).
    """
    N, H, W = frames.shape
    if H < roi or W < roi:
        frames = F.pad(frames, (0, max(0, roi - W), 0, max(0, roi - H)))
        N, H, W = frames.shape
    x = frames.to(torch.float32)
    thr = x.mean(dim=(-2, -1), keepdim=True) * 1.2
    m = x > thr
    rows = m.sum(dim=-1, dtype=torch.int64)                 # (N, H)
    cols = m.sum(dim=-2, dtype=torch.int64)                 # (N, W)
    cnt = rows.sum(dim=-1)
    den = cnt.clamp(min=1)
    any_fg = cnt > 0
    cy = torch.where(any_fg, (rows * torch.arange(H, device=x.device)).sum(
        dim=-1) // den, torch.full_like(cnt, H // 2))
    cx = torch.where(any_fg, (cols * torch.arange(W, device=x.device)).sum(
        dim=-1) // den, torch.full_like(cnt, W // 2))
    y0 = (cy - roi // 2).clamp(0, H - roi)
    x0 = (cx - roi // 2).clamp(0, W - roi)
    origins = torch.stack([y0, x0], dim=1)
    idx = _window_index(origins, roi, roi, W)
    patches = frames.reshape(N, H * W).gather(1, idx).reshape(N, roi, roi)
    return patches, origins


def paste_roi_probs(prob_roi: torch.Tensor, origins: torch.Tensor,
                    out_hw: Tuple[int, int]) -> torch.Tensor:
    """Paste (N, roi, roi) probability patches back into zero (N, H, W) maps
    at their per-frame origins; a patch larger than the frame is cut to it."""
    H, W = out_hw
    N, r, _ = prob_roi.shape
    r_h, r_w = min(r, H), min(r, W)
    org = torch.stack([origins[:, 0].clamp(0, max(H - r, 0)),
                       origins[:, 1].clamp(0, max(W - r, 0))], dim=1).long()
    idx = _window_index(org, r_h, r_w, W)
    canvas = torch.zeros((N, H * W), dtype=prob_roi.dtype,
                         device=prob_roi.device)
    canvas.scatter_(1, idx, prob_roi[:, :r_h, :r_w].reshape(N, -1))
    return canvas.reshape(N, H, W)
