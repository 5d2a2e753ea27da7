"""Image operations of the plain reference: min-max to uint8, CLAHE, the
3x3 median, the OpenCV small Gaussian blur and the half-pixel bilinear
resize, in plain PyTorch (no hand-written kernel: CLAHE's interpolation is
an index gather and a multiply-add chain).

A frozen copy of the port's plain versions (``ops/image.py``,
``ops/clahe.py``, ``ops/kernels/clahe_interp.py``'s
``clahe_interp_reference``), kept here so that a change to the program
cannot move the reference.  Their semantics are OpenCV's (``cv2.normalize``,
``createCLAHE(1.0, (8, 8))``, ``medianBlur(3)``, ``GaussianBlur((5, 5), 0)``,
``resize(INTER_LINEAR)``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

FP8_MAX = 448.0


def fake_fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under a per-tensor scale (the
    benchmark's lower-precision controls)."""
    s = t.abs().amax().clamp(min=1e-12) / FP8_MAX
    return (t / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def minmax_normalize_u8(frames: torch.Tensor) -> torch.Tensor:
    """Per-frame min-max rescale to [0, 255] -> uint8.  f32 arithmetic as the
    JAX package does it; ``torch.round`` rounds half to even like
    ``jnp.round``.  Constant frames map to 0.  The scale is a true f32
    division: PyTorch computes ``255.0 / t`` as ``255 * (1 / t)``, which is
    one ulp off for most ranges and moves pixels whose scaled value lies
    near a half."""
    x = frames.to(torch.float32)
    lo = x.amin(dim=(-2, -1), keepdim=True)
    hi = x.amax(dim=(-2, -1), keepdim=True)
    scale = torch.where(hi > lo, torch.full_like(hi, 255.0) / (hi - lo),
                        torch.zeros_like(hi))
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



def _fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """f32 ``a * b + c`` rounded once, as a fused multiply-add does.  The
    f64 product of two f32 values is exact; the f64 sum is exact too while
    the operands span at most 53 bits, which holds for integer LUT values
    <= 255 and CLAHE's corner weights."""
    f64 = torch.float64
    return (a.to(f64) * b.to(f64) + c.to(f64)).to(torch.float32)


def clahe_interp_reference(blocks: torch.Tensor, corner_luts: torch.Tensor,
                           wts: torch.Tensor) -> torch.Tensor:
    """Plain version: index gather of each pixel's four corner-LUT values,
    blended as ``fma(g3, w3, fma(g2, w2, fma(g1, w1, g0 * w0)))`` — the
    kernel's chain and the order the JAX package's XLA path evaluates
    ``sum(g * w, -1)`` in; values outside [0, 255] (padding) give 0."""
    valid = (blocks >= 0) & (blocks < 256)
    idx = blocks.clamp(0, 255).long()
    g = torch.gather(corner_luts, 2,
                     idx[..., None].expand(*idx.shape, 4))      # (N, B, P, 4)
    w = wts.to(torch.float32)
    out = g[..., 0] * w[:, 0]
    for c in (1, 2, 3):
        out = _fma_f32(g[..., c], w[:, c], out)
    return torch.where(valid, out, torch.zeros((), dtype=out.dtype,
                                               device=out.device))



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
    hist = torch.bincount((tiles + tile_id).reshape(-1),
                          minlength=n_tiles * 256).reshape(n_tiles, 256)

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
    """CLAHE on a stack of uint8 frames (N, H, W) -> uint8."""
    H, W = frames.shape[-2], frames.shape[-1]
    out = clahe_interp_reference(*clahe_tables(frames, clip_limit, grid))
    return clahe_finish(out, (H, W), grid)


def enhance(frames: torch.Tensor, clip: float = 1.0,
            grid: Tuple[int, int] = (8, 8)) -> torch.Tensor:
    """min-max -> CLAHE (skipped at ``clip <= 0``) -> 3x3 median, uint8."""
    u8 = minmax_normalize_u8(frames)
    if clip > 0:
        u8 = clahe(u8, clip, grid)
    return median3x3(u8)
