"""Training augmentation on the device, the counterpart of
``att_aspp_unet_tpu/train/augment.py``.

Train: hflip(.5) -> affine(scale .92-1.08, rot +-7 deg, translate 0-2 %,
p .7) -> elastic(alpha 8, sigma 3, p .25) as ONE inverse coordinate map (one
four-corner gather: bilinear for the image, nearest for the mask) -> gamma(.3)
-> brightness/contrast(.3) -> CLAHE(1, 8x8) -> median-3 -> [0, 1] float.
Eval: CLAHE -> median-3 -> float.  On a card the CLAHE blend is kernel K2
(``ops/kernels/clahe_interp``), in every train and eval step.

The JAX package draws its parameters with ``jax.random`` inside the step;
their numbers cannot be reproduced here.  So the draw is split from the
computation: :func:`sample_params` draws the same distributions from a CPU
``torch.Generator`` (the train loop seeds one from (seed, step), so a resumed
run repeats the stream and the card and the CPU see the same batch), and
:func:`augment_batch` is deterministic in those parameters.  The per-image
transform (:func:`image_transforms`) is computed on the host, so the card and
the CPU use the same matrices; the gamma curve is evaluated in f64 and
rounded to f32, so that both round it alike.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..config import AugmentConfig
from ..ops.clahe import clahe
from ..ops.image import gaussian_kernel1d, median3x3

F32 = torch.float32
# the columns of image_transforms' table after the six of the affine map
_GAMMA, _ALPHA, _BETA, _ELASTIC = 6, 7, 8, 9
# XLA evaluates ``x / 255.0`` as ``x * f32(1 / 255)``; so does this module
_INV_255 = 1.0 / 255.0


def sample_params(gen: torch.Generator, B: int, H: int, W: int,
                  cfg: AugmentConfig = AugmentConfig()
                  ) -> Dict[str, torch.Tensor]:
    """Per-image parameters of ``_sample_params`` (``augment.py:31-49``), each
    a (B,) CPU tensor (angle in radians), and ``noise``: the two uniform
    [-1, 1) fields of ``_elastic_field`` (``:76-94``), (B, 2, H, W) f32."""

    def bern(p):
        return torch.rand(B, generator=gen) < float(p)

    def unif(lo, hi):
        return lo + (hi - lo) * torch.rand(B, generator=gen)

    p = {
        "do_flip": bern(cfg.hflip_p),
        "do_affine": bern(cfg.affine_p),
        "scale": unif(*cfg.scale_range),
        "angle": unif(-cfg.rotate_deg, cfg.rotate_deg) * math.pi / 180.0,
        "tx": unif(-cfg.translate_frac, cfg.translate_frac),
        "ty": unif(-cfg.translate_frac, cfg.translate_frac),
        "do_gamma": bern(cfg.gamma_p),
        "gamma": unif(*cfg.gamma_range),
        "do_bc": bern(cfg.brightness_contrast_p),
        "brightness": unif(-cfg.brightness_limit, cfg.brightness_limit),
        "contrast": unif(-cfg.contrast_limit, cfg.contrast_limit),
        "do_elastic": bern(cfg.elastic_p),
    }
    p["noise"] = torch.rand((B, 2, H, W), generator=gen) * 2.0 - 1.0
    return p


def image_transforms(params: Dict[str, torch.Tensor], H: int, W: int
                     ) -> torch.Tensor:
    """(B, 10) f32 on the host: the dst -> src affine map [m00, m01, b0, m10,
    m11, b1] (centre-anchored scale + rotation + translation, optional
    hflip), then gamma, contrast factor alpha, brightness offset beta (u8
    scale) and the elastic switch, with the JAX package's f32 arithmetic."""
    on = params["do_affine"]
    s = torch.where(on, params["scale"], 1.0)
    a = torch.where(on, params["angle"], 0.0)
    tx = torch.where(on, params["tx"] * W, 0.0)
    ty = torch.where(on, params["ty"] * H, 0.0)
    flip = torch.where(params["do_flip"], -1.0, 1.0)
    cx, cy = (W - 1) / 2.0, (H - 1) / 2.0
    cos, sin = torch.cos(a), torch.sin(a)
    inv_s = 1.0 / s
    m00 = flip * inv_s * cos
    m01 = flip * inv_s * sin
    m10 = -inv_s * sin
    m11 = inv_s * cos
    ox = -(cx + tx)
    oy = -(cy + ty)
    b0 = m00 * ox + m01 * oy + cx
    b1 = m10 * ox + m11 * oy + cy
    g = torch.where(params["do_gamma"], params["gamma"], 1.0)
    alpha = 1.0 + torch.where(params["do_bc"], params["contrast"], 0.0)
    beta = torch.where(params["do_bc"], params["brightness"], 0.0) * 255.0
    use_el = params["do_elastic"].to(F32)
    return torch.stack([m00, m01, b0, m10, m11, b1, g, alpha, beta, use_el],
                       dim=1).to(F32)


def _smooth(fields: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian of (N, H, W) fields with reflect padding, summed
    tap by tap (rows, then columns) as ``_elastic_field`` does."""
    radius = max(int(4.0 * sigma), 1)
    ksz = 2 * radius + 1
    k = [float(v) for v in gaussian_kernel1d(ksz, sigma)]
    H, W = fields.shape[-2], fields.shape[-1]
    fp = F.pad(fields[:, None], (radius,) * 4, mode="reflect")[:, 0]
    rows = sum(k[i] * fp[:, i:i + H, :] for i in range(ksz))
    return sum(k[j] * rows[:, :, j:j + W] for j in range(ksz))


def warp_coords(table: torch.Tensor, noise: torch.Tensor,
                cfg: AugmentConfig):
    """Source coordinates (sy, sx), each (B, H, W) f32: the affine map of
    ``table`` plus, where switched on, the smoothed elastic displacement."""
    B, _, H, W = noise.shape
    dev = noise.device
    ys = torch.arange(H, dtype=F32, device=dev)[:, None].expand(H, W)
    xs = torch.arange(W, dtype=F32, device=dev)[None, :].expand(H, W)
    m = [table[:, i, None, None] for i in range(6)]
    sx = m[0] * xs + m[1] * ys + m[2]
    sy = m[3] * xs + m[4] * ys + m[5]
    d = _smooth(noise.reshape(B * 2, H, W), cfg.elastic_sigma)
    d = d.reshape(B, 2, H, W) * cfg.elastic_alpha
    use_el = table[:, _ELASTIC, None, None]
    return sy + use_el * d[:, 1], sx + use_el * d[:, 0]


def _round_half_away(s: torch.Tensor) -> torch.Tensor:
    """Round half away from zero (``map_coordinates(order=0)``), int32."""
    return torch.where(s >= 0, torch.floor(s + 0.5),
                       torch.ceil(s - 0.5)).to(torch.int32)


def warp_pair_batch(img: torch.Tensor, mask: torch.Tensor, sy: torch.Tensor,
                    sx: torch.Tensor):
    """Bilinear warp of ``img`` and nearest warp of ``mask`` (all (B, H, W)
    f32), constant 0 outside: ``map_coordinates(order=1 / 0)`` as four corner
    gathers of (img, mask) pairs, the nearest corner chosen among the four
    (``_warp_pair_batch``, ``augment.py:97-151``)."""
    B, H, W = img.shape
    pair = torch.stack([img, mask], dim=-1).reshape(B * H * W, 2)
    y0 = torch.floor(sy)
    x0 = torch.floor(sx)
    wy = (sy - y0)[..., None]
    wx = (sx - x0)[..., None]
    y0i = y0.to(torch.int32)
    x0i = x0.to(torch.int32)
    yr = _round_half_away(sy)
    xr = _round_half_away(sx)
    b = torch.arange(B, dtype=torch.int32, device=img.device)[:, None, None]

    def corner(dy, dx):
        yi = y0i + dy
        xi = x0i + dx
        valid = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        flat = (b * H + yi.clamp(0, H - 1)) * W + xi.clamp(0, W - 1)
        v = pair[flat.long()] * valid[..., None].to(img.dtype)
        return v, (yi == yr) & (xi == xr)

    (c00, n00), (c01, n01) = corner(0, 0), corner(0, 1)
    (c10, n10), (c11, n11) = corner(1, 0), corner(1, 1)
    warped = (c00 * (1 - wy) * (1 - wx) + c01 * (1 - wy) * wx +
              c10 * wy * (1 - wx) + c11 * wy * wx)
    near = torch.where(n00, c00[..., 1],
                       torch.where(n01, c01[..., 1],
                                   torch.where(n10, c10[..., 1],
                                               c11[..., 1])))
    return warped[..., 0], near


def apply_intensity(img: torch.Tensor, g: torch.Tensor, alpha: torch.Tensor,
                    beta: torch.Tensor) -> torch.Tensor:
    """Gamma then brightness/contrast on the u8 scale (albumentations'
    conventions); g / alpha / beta broadcast over the trailing (H, W)."""
    base = torch.clamp(img * _INV_255, 0.0, 1.0)
    img = torch.pow(base.double(), g.double()).to(F32) * 255.0
    return torch.clamp(img * alpha + beta, 0.0, 255.0)


def augment_batch(images_u8: torch.Tensor, masks_u8: torch.Tensor,
                  cfg: AugmentConfig = AugmentConfig(),
                  params: Optional[Dict[str, torch.Tensor]] = None,
                  train: bool = True):
    """(B, S, S) uint8 images + masks on the device -> x, y, each (B, 1, S, S)
    f32: x the enhanced image in [0, 1], y the mask in {0, 1}.  ``train``
    applies the geometric + intensity augmentation of ``params``
    (:func:`sample_params`); then CLAHE (if ``cfg.use_clahe``) + median-3."""
    if train:
        if params is None:
            raise ValueError("augment_batch(train=True) needs params from "
                             "sample_params")
        B, H, W = images_u8.shape
        dev = images_u8.device
        pin = dev.type == "cuda"
        table = image_transforms(params, H, W)
        noise = params["noise"]
        if pin:
            table, noise = table.pin_memory(), noise.pin_memory()
        table = table.to(dev, non_blocking=pin)
        noise = noise.to(dev, non_blocking=pin)
        sy, sx = warp_coords(table, noise, cfg)
        img, mask = warp_pair_batch(images_u8.to(F32), masks_u8.to(F32),
                                    sy, sx)
        col = [table[:, i, None, None] for i in (_GAMMA, _ALPHA, _BETA)]
        img = apply_intensity(img, *col)
        images_u8 = torch.round(img).to(torch.uint8)
        masks_u8 = (mask > 127).to(torch.uint8)
    else:
        masks_u8 = (masks_u8 > 127).to(torch.uint8)
    enhanced = median3x3(clahe(images_u8, 1.0, (8, 8))
                         if cfg.use_clahe else images_u8)
    x = (enhanced.to(F32) * _INV_255)[:, None]
    y = masks_u8.to(F32)[:, None]
    return x, y
