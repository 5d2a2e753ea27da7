"""Binary morphology as footprint counts, with the reference's borders.

Counterpart of ``att_aspp_unet_tpu/postprocess/morphology.py``:

- ``binary_dilation``: outside the image is background (scipy default);
- ``binary_erosion`` (within closing): outside is foreground (OpenCV's
  replicated border, so a close never eats the image edge);
- ``fill_holes``: scipy ``binary_fill_holes`` (4-connected background):
  background not reachable from the border flips to foreground, found with
  the CC labeler's propagation (seeds = border background).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .cc import INF, fixed_point, make_propagate


def structuring_ellipse(ksize: int) -> np.ndarray:
    """cv2.getStructuringElement(MORPH_ELLIPSE, (k, k)) — row-span rule."""
    r = c = ksize // 2
    inv_r2 = 1.0 / (r * r) if r else 0.0
    el = np.zeros((ksize, ksize), np.uint8)
    for i in range(ksize):
        dy = i - r
        if abs(dy) <= r:
            dx = int(round(c * np.sqrt(max(r * r - dy * dy, 0) * inv_r2)))
            j1, j2 = max(c - dx, 0), min(c + dx + 1, ksize)
            el[i, j1:j2] = 1
    return el


def _footprint_correlate(x: torch.Tensor, footprint: np.ndarray,
                         pad_value: float = 0.0) -> torch.Tensor:
    """Correlate (..., H, W) float with a small 0/1 footprint."""
    kh, kw = footprint.shape
    ph, pw = kh // 2, kw // 2
    H, W = x.shape[-2], x.shape[-1]
    xp = F.pad(x, (pw, kw - 1 - pw, ph, kh - 1 - ph), value=pad_value)
    out = None
    for i in range(kh):
        for j in range(kw):
            if footprint[i, j]:
                term = xp[..., i:i + H, j:j + W]
                out = term if out is None else out + term
    return out


def binary_dilation(mask: torch.Tensor, footprint: np.ndarray = None,
                    iterations: int = 1) -> torch.Tensor:
    fp = np.ones((3, 3), np.uint8) if footprint is None else np.asarray(footprint)
    m = (mask > 0).to(torch.float32)
    for _ in range(iterations):
        m = (_footprint_correlate(m, fp) > 0).to(torch.float32)
    return m.to(torch.uint8)


def binary_erosion(mask: torch.Tensor, footprint: np.ndarray = None,
                   border_foreground: bool = True) -> torch.Tensor:
    fp = np.ones((3, 3), np.uint8) if footprint is None else np.asarray(footprint)
    bg = 1.0 - (mask > 0).to(torch.float32)
    cnt = _footprint_correlate(bg, fp, 0.0 if border_foreground else 1.0)
    return ((cnt == 0) & (mask > 0)).to(torch.uint8)


def binary_closing(mask: torch.Tensor, footprint: np.ndarray) -> torch.Tensor:
    """cv2.morphologyEx(MORPH_CLOSE): dilate then erode (OpenCV borders)."""
    return binary_erosion(binary_dilation(mask, footprint), footprint,
                          border_foreground=True)


def fill_holes(mask: torch.Tensor, max_iters: int = 64) -> torch.Tensor:
    fg = mask.bool()
    H, W = fg.shape[-2], fg.shape[-1]
    bg = ~fg
    border = torch.zeros((H, W), dtype=torch.bool, device=fg.device)
    border[0, :] = border[-1, :] = True
    border[:, 0] = border[:, -1] = True
    one = torch.ones((), dtype=torch.long, device=fg.device)
    seed = torch.where(bg & border, torch.zeros_like(one), one)
    seed = torch.where(bg, seed, torch.full_like(one, INF))
    vals = fixed_point(make_propagate(bg, 4), seed, max_iters)
    return (fg | (bg & (vals == 1))).to(torch.uint8)
