"""Per-frame enhancement chain, batched over the sweep.

Counterpart of ``att_aspp_unet_tpu/preprocess/enhance.py``: for every frame
min-max normalise to uint8, CLAHE (clip 1.0, 8x8 tiles), 3x3 median; then
resize to the network size and scale to [0, 1].
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..ops.clahe import clahe
from ..ops.image import median3x3, minmax_normalize_u8, resize_bilinear


def enhance_frames(frames: torch.Tensor, clahe_clip: float = 1.0,
                   clahe_grid: Tuple[int, int] = (8, 8),
                   median_kernel: int = 3) -> torch.Tensor:
    """min-max -> CLAHE -> median-3 on a stack of frames; returns uint8.
    ``clahe_clip <= 0`` skips CLAHE."""
    u8 = minmax_normalize_u8(frames)
    if clahe_clip > 0:
        u8 = clahe(u8, clahe_clip, clahe_grid)
    if median_kernel == 3:
        u8 = median3x3(u8)
    elif median_kernel not in (0, 1):
        raise NotImplementedError(f"median kernel {median_kernel}")
    return u8


def preprocess_sweep(frames: torch.Tensor, img_size: Optional[int] = None,
                     clahe_clip: float = 1.0,
                     clahe_grid: Tuple[int, int] = (8, 8),
                     median_kernel: int = 3,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Enhance at native resolution, resize to (img_size, img_size) if
    given, scale to [0, 1].  Returns (N, S, S) in ``dtype``."""
    u8 = enhance_frames(frames, clahe_clip, clahe_grid, median_kernel)
    x = u8.to(torch.float32)
    if img_size is not None and tuple(u8.shape[-2:]) != (img_size, img_size):
        x = resize_bilinear(x, (img_size, img_size))
    return (x / 255.0).to(dtype)
