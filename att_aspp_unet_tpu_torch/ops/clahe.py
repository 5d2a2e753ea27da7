"""CLAHE (contrast-limited adaptive histogram equalisation) over a stack.

Counterpart of ``att_aspp_unet_tpu/ops/clahe.py`` (OpenCV
``createCLAHE(clipLimit, tileGridSize)`` semantics), batched over frames:

1. pad bottom/right with REFLECT_101 so H, W divide the tile grid;
2. per-tile 256-bin histograms;
3. clip at ``max(int(clip * tile_area / 256), 1)``, redistribute the excess
   the way OpenCV does, LUT = rint(CDF * 255 / tile_area);
4. interpolation on the dual grid: pixels regroup into (tiles+1)^2
   half-tile-shifted blocks, each with four fixed neighbouring tile LUTs and
   a fixed bilinear weight pattern; the per-block lookup and blend is kernel
   K2 (``ops/kernels/clahe_interp``).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from .image import bin_counts
from .kernels.clahe_interp import clahe_interp


def _reflect101_index(n: int, pad: int) -> np.ndarray:
    """Indices of a length-``n`` axis padded by ``pad`` at the end with
    reflect-101 (``np.pad(mode="reflect")``)."""
    return np.pad(np.arange(n), (0, pad), mode="reflect")


def _compute_luts(xe: torch.Tensor, tiles_y: int, tiles_x: int,
                  clip_limit: float) -> torch.Tensor:
    """(N, He, We) uint8 -> per-tile LUTs (N, tiles_y, tiles_x, 256) f32."""
    N, He, We = xe.shape
    th, tw = He // tiles_y, We // tiles_x
    tile_area = th * tw
    n_tiles = N * tiles_y * tiles_x

    tiles = xe.reshape(N, tiles_y, th, tiles_x, tw).permute(0, 1, 3, 2, 4)
    tiles = tiles.reshape(n_tiles, tile_area).long()
    tile_id = torch.arange(n_tiles, device=xe.device)[:, None] * 256
    hist = bin_counts(tiles + tile_id, n_tiles * 256).reshape(n_tiles, 256)

    clip = max(int(clip_limit * tile_area / 256), 1)
    clipped = torch.minimum(hist, torch.full_like(hist, clip))
    excess = (hist - clipped).sum(dim=1, keepdim=True)
    batch = excess // 256
    residual = excess % 256
    clipped = clipped + batch
    # residual: +1 at i = k*step for k < residual, step = max(256//residual, 1)
    step = torch.clamp(256 // torch.clamp(residual, min=1), min=1)
    idx = torch.arange(256, device=xe.device)[None, :]
    bonus = ((idx % step == 0) & (idx // step < residual)).long()
    clipped = clipped + torch.where(residual > 0, bonus, 0)

    lut_scale = float(np.float32(255.0 / tile_area))      # an f32 value
    cdf = torch.cumsum(clipped, dim=1).to(torch.float32)
    luts = torch.clamp(torch.round(cdf * lut_scale), 0, 255)
    return luts.reshape(N, tiles_y, tiles_x, 256)


def _fractional_weights(t: int) -> np.ndarray:
    """Position r in a dual-grid block of size t has
    ya = (r - t//2)/t + 0.5 (cv2's ``y * (1/t) - 0.5`` pattern)."""
    r = np.arange(t, dtype=np.float64)
    ya = (r - (t // 2)).astype(np.float32) * np.float32(1.0 / t) \
        + np.float32(0.5)
    return ya.astype(np.float32)


def corner_weights(th: int, tw: int) -> np.ndarray:
    """(th*tw, 4) f32 bilinear weights of the four corner LUTs."""
    ya = _fractional_weights(th)
    xa = _fractional_weights(tw)
    one = np.float32(1)
    w11 = ((one - ya)[:, None] * (one - xa)[None, :]).reshape(-1)
    w12 = ((one - ya)[:, None] * xa[None, :]).reshape(-1)
    w21 = (ya[:, None] * (one - xa)[None, :]).reshape(-1)
    w22 = (ya[:, None] * xa[None, :]).reshape(-1)
    return np.stack([w11, w12, w21, w22], axis=-1).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _grid_constants(H: int, W: int, tiles_y: int, tiles_x: int, device):
    """The index and weight tensors that depend only on the frame size and
    the grid, made once per size and device (an upload from host memory
    makes the host wait for the device, so none is left in the per-sweep
    path): reflect-101 row and column indices of the padded frame, the tile
    rows and columns of each dual-grid block's corners, the corner weights."""
    pad_h, pad_w = (-H) % tiles_y, (-W) % tiles_x
    th, tw = (H + pad_h) // tiles_y, (W + pad_w) // tiles_x
    By, Bx = tiles_y + 1, tiles_x + 1

    def dev(a):
        return torch.as_tensor(a, device=device)

    return (dev(_reflect101_index(H, pad_h)), dev(_reflect101_index(W, pad_w)),
            dev(np.clip(np.arange(-1, By), 0, tiles_y - 1)),
            dev(np.clip(np.arange(-1, Bx), 0, tiles_x - 1)),
            dev(corner_weights(th, tw)))


def clahe_tables(frames: torch.Tensor, clip_limit: float = 1.0,
                 grid: Tuple[int, int] = (8, 8)):
    """Steps 1-3 and the dual-grid regrouping: (N, H, W) uint8 ->
    ``(blocks, corner_luts, wts)``, the operands of kernel K2 — blocks
    (N, B, P) int32, corner LUTs (N, B, 256, 4) f32, weights (P, 4) f32."""
    tiles_y, tiles_x = int(grid[1]), int(grid[0])  # cv2 grid is (cols, rows)
    N, H, W = frames.shape
    dev = frames.device
    pad_h = (-H) % tiles_y
    pad_w = (-W) % tiles_x
    ri, ci, ry, rx, wts = _grid_constants(H, W, tiles_y, tiles_x, dev)
    xe = frames
    if pad_h or pad_w:
        xe = frames[:, ri][:, :, ci]
    th, tw = (H + pad_h) // tiles_y, (W + pad_w) // tiles_x

    luts = _compute_luts(xe, tiles_y, tiles_x, clip_limit)

    # dual-grid blocks: pad the top by th//2 (and the bottom to fill) so the
    # rows regroup into tiles_y + 1 uniform blocks with constant tile pairs
    pt, pl = th // 2, tw // 2
    By, Bx = tiles_y + 1, tiles_x + 1
    vp = torch.zeros((N, By * th, Bx * tw), dtype=torch.int32, device=dev)
    vp[:, pt:pt + H, pl:pl + W] = frames
    blocks = vp.reshape(N, By, th, Bx, tw).permute(0, 1, 3, 2, 4)
    blocks = blocks.reshape(N, By * Bx, th * tw).contiguous()

    # corner LUTs per block: block k uses tile rows clamp(k-1), clamp(k)
    lpad = luts[:, ry][:, :, rx]                      # (N, By+1, Bx+1, 256)
    corner = torch.stack([lpad[:, 0:By, 0:Bx], lpad[:, 0:By, 1:Bx + 1],
                          lpad[:, 1:By + 1, 0:Bx], lpad[:, 1:By + 1, 1:Bx + 1]],
                         dim=-1)                      # (N, By, Bx, 256, 4)
    corner = corner.reshape(N, By * Bx, 256, 4).contiguous()
    return blocks, corner, wts


def clahe_finish(out_blocks: torch.Tensor, hw: Tuple[int, int],
                 grid: Tuple[int, int] = (8, 8)) -> torch.Tensor:
    """Blended blocks (N, B, P) f32 -> the (N, H, W) uint8 frames."""
    tiles_y, tiles_x = int(grid[1]), int(grid[0])
    H, W = hw
    th, tw = -(-H // tiles_y), -(-W // tiles_x)
    By, Bx = tiles_y + 1, tiles_x + 1
    pt, pl = th // 2, tw // 2
    N = out_blocks.shape[0]
    out = out_blocks.reshape(N, By, Bx, th, tw).permute(0, 1, 3, 2, 4)
    out = out.reshape(N, By * th, Bx * tw)[:, pt:pt + H, pl:pl + W]
    return torch.clamp(torch.round(out), 0, 255).to(torch.uint8)


def clahe(frames: torch.Tensor, clip_limit: float = 1.0,
          grid: Tuple[int, int] = (8, 8)) -> torch.Tensor:
    """CLAHE on a stack of uint8 frames ``(..., H, W)`` -> uint8."""
    lead = frames.shape[:-2]
    H, W = frames.shape[-2], frames.shape[-1]
    x = frames.reshape((-1, H, W))
    out = clahe_interp(*clahe_tables(x, clip_limit, grid))
    return clahe_finish(out, (H, W), grid).reshape(lead + (H, W))
