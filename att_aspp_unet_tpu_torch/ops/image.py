"""Batched image primitives on ``(..., H, W)`` tensors.

Counterpart of ``att_aspp_unet_tpu/ops/image.py``, with the same OpenCV
semantics and border modes:

- ``minmax_normalize_u8``  ~ ``cv2.normalize(..., 0, 255, NORM_MINMAX)``
- ``median3x3``            ~ ``cv2.medianBlur(k=3)``      (BORDER_REPLICATE)
- ``gaussian_blur``        ~ ``cv2.GaussianBlur((k,k),0)`` (BORDER_REFLECT_101)
- ``resize_bilinear``      ~ ``cv2.resize(INTER_LINEAR)`` (half-pixel centers)
- ``resize_nearest``       ~ ``jax.image.resize(method="nearest")``
- ``bin_counts``           ~ ``np.bincount(minlength=...)``
- ``sobel_gradients``      ~ the reference EdgeLoss's zero-padded Sobel pair
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def minmax_normalize_u8(frames: torch.Tensor) -> torch.Tensor:
    """Per-frame min-max rescale to [0, 255] -> uint8.  f32 arithmetic as the
    JAX package does it; ``torch.round`` rounds half to even like
    ``jnp.round``.  Constant frames map to 0."""
    x = frames.to(torch.float32)
    lo = x.amin(dim=(-2, -1), keepdim=True)
    hi = x.amax(dim=(-2, -1), keepdim=True)
    scale = torch.where(hi > lo, 255.0 / (hi - lo), torch.zeros_like(hi))
    y = (x - lo) * scale
    return torch.clamp(torch.round(y), 0, 255).to(torch.uint8)


def median3x3(frames: torch.Tensor) -> torch.Tensor:
    """3x3 median with replicated borders, as Paeth's median-of-9 network
    (19 min/max exchanges over nine shifted views)."""
    H, W = frames.shape[-2], frames.shape[-1]
    rows = torch.cat([frames[..., :1, :], frames, frames[..., -1:, :]], dim=-2)
    xp = torch.cat([rows[..., :1], rows, rows[..., -1:]], dim=-1)
    p = [xp[..., dy:dy + H, dx:dx + W] for dy in range(3) for dx in range(3)]

    def ex(i, j):
        a, b = p[i], p[j]
        p[i], p[j] = torch.minimum(a, b), torch.maximum(a, b)

    ex(1, 2); ex(4, 5); ex(7, 8)
    ex(0, 1); ex(3, 4); ex(6, 7)
    ex(1, 2); ex(4, 5); ex(7, 8)
    ex(0, 3); ex(5, 8); ex(4, 7)
    ex(3, 6); ex(1, 4); ex(2, 5)
    ex(4, 7); ex(4, 2); ex(6, 4)
    ex(4, 2)
    return p[4].contiguous()


# OpenCV's fixed small-Gaussian kernels used when sigma <= 0
_CV2_SMALL_GAUSSIAN = {
    1: np.array([1.0], np.float32),
    3: np.array([0.25, 0.5, 0.25], np.float32),
    5: np.array([0.0625, 0.25, 0.375, 0.25, 0.0625], np.float32),
    7: np.array([0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375,
                 0.03125], np.float32),
}


def gaussian_kernel1d(ksize: int, sigma: float = 0.0) -> np.ndarray:
    """1-D Gaussian kernel with OpenCV's defaulting rules."""
    if sigma <= 0 and ksize in _CV2_SMALL_GAUSSIAN:
        return _CV2_SMALL_GAUSSIAN[ksize]
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    r = (ksize - 1) / 2
    xs = np.arange(ksize) - r
    k = np.exp(-(xs ** 2) / (2 * sigma ** 2))
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(frames: torch.Tensor, ksize: int = 5,
                  sigma: float = 0.0) -> torch.Tensor:
    """Separable Gaussian blur, reflect-101 borders; f32 result (float
    inputs keep their dtype), summed tap by tap in the JAX order."""
    k = [float(v) for v in gaussian_kernel1d(ksize, sigma)]
    r = ksize // 2
    x = frames.to(torch.float32)
    lead = x.shape[:-2]
    H, W = x.shape[-2], x.shape[-1]
    x = x.reshape((-1, 1, H, W))
    xp = F.pad(x, (r, r, r, r), mode="reflect")[:, 0]
    # the taps are Python floats holding f32 values: the products are the f32
    # ones, and no constant has to be copied to the device
    rows = sum(k[i] * xp[:, i:i + H, :] for i in range(ksize))
    out = sum(k[j] * rows[:, :, j:j + W] for j in range(ksize))
    dt = frames.dtype if frames.dtype.is_floating_point else torch.float32
    return out.reshape(lead + (H, W)).to(dt)


def resize_bilinear(frames: torch.Tensor, out_hw: Tuple[int, int]
                    ) -> torch.Tensor:
    """Bilinear resize, half-pixel centers, no antialias — what
    ``jax.image.resize(method="linear", antialias=False)`` computes.  Its
    normalised triangle weights equal ``align_corners=False`` sampling with
    the source coordinate clamped to the image, for down- and upscaling."""
    lead = frames.shape[:-2]
    H, W = frames.shape[-2], frames.shape[-1]
    x = frames.to(torch.float32).reshape((-1, 1, H, W))
    if (H, W) != tuple(out_hw):
        x = F.interpolate(x, size=tuple(out_hw), mode="bilinear",
                          align_corners=False, antialias=False)
    dt = frames.dtype if frames.dtype.is_floating_point else torch.float32
    return x.reshape(lead + tuple(out_hw)).to(dt)


def nearest_source_index(n_in: int, n_out: int) -> np.ndarray:
    """Source index of every output position of a nearest-neighbour resize,
    as ``jax.image.resize(method="nearest")`` takes it: half-pixel centres,
    ``floor((i + 0.5) * n_in / n_out)`` in f32 (``F.interpolate(mode=
    "nearest")`` takes ``floor(i * n_in / n_out)`` instead).

    The f32 rounding decides positions where the quotient is an integer
    (224 -> 562: i = 140 gives exactly 56).  XLA folds the two constants of
    the jitted expression into one factor, ``n_in * (1 / n_out)``, and the
    JAX package's CPU results follow from that factor (there: 55), so it is
    computed the same way here."""
    f32 = np.float32
    factor = f32(n_in) * (f32(1.0) / f32(n_out))
    pos = (np.arange(n_out, dtype=f32) + f32(0.5)) * factor
    return np.minimum(np.floor(pos).astype(np.int64), n_in - 1)


def resize_nearest(frames: torch.Tensor, out_hw: Tuple[int, int]
                   ) -> torch.Tensor:
    """Nearest-neighbour resize of (..., H, W) (mask-safe: introduces no new
    values), one index gather per axis whose size changes."""
    H, W = frames.shape[-2], frames.shape[-1]
    out = frames
    if H != out_hw[0]:
        rows = torch.from_numpy(nearest_source_index(H, out_hw[0]))
        out = out.index_select(-2, rows.to(frames.device))
    if W != out_hw[1]:
        cols = torch.from_numpy(nearest_source_index(W, out_hw[1]))
        out = out.index_select(-1, cols.to(frames.device))
    return out


def bin_counts(idx: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Occurrences of each value 0..n_bins-1 in the int64 tensor ``idx``
    (``torch.bincount(idx, minlength=n_bins)``); negative values are not
    counted.  On a card ``torch.bincount`` reads the tensor's extremes back
    to size its output; ``torch.histc`` with given bounds runs the same
    histogram kernel on integers without reading anything, so the host does
    not wait, and ignores values below its range."""
    flat = idx.reshape(-1)
    if flat.is_cuda:
        return torch.histc(flat, bins=n_bins, min=0, max=n_bins)
    return torch.bincount(flat[flat >= 0], minlength=n_bins)


_SOBEL_X = ((1.0, 0.0, -1.0), (2.0, 0.0, -2.0), (1.0, 0.0, -1.0))
_SOBEL_Y = ((1.0, 2.0, 1.0), (0.0, 0.0, 0.0), (-1.0, -2.0, -1.0))


def sobel_gradients(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """3x3 Sobel gradient pair (gx, gy) in f32 with zero padding, on
    ``(..., H, W)`` inputs: the reference EdgeLoss's ``F.conv2d(p, k,
    padding=1)``, summed tap by tap in the JAX package's order."""
    lead = x.shape[:-2]
    H, W = x.shape[-2], x.shape[-1]
    xp = F.pad(x.to(torch.float32).reshape((-1, H, W)), (1, 1, 1, 1))

    def corr(k):
        return sum(k[i][j] * xp[:, i:i + H, j:j + W]
                   for i in range(3) for j in range(3))

    return (corr(_SOBEL_X).reshape(lead + (H, W)),
            corr(_SOBEL_Y).reshape(lead + (H, W)))
