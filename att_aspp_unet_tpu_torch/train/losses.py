"""Loss zoo of the reference criterion builder, the counterpart of
``att_aspp_unet_tpu/train/losses.py``.

Inputs are NCHW: logits (B, 1, H, W), targets (B, 1, H, W) in {0, 1}.
Spatial reductions run per (sample, channel) over (H, W), then average.  The
positive-sample-only Dice / edge terms are masked means, not boolean
gathers, so no value crosses to the host.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..config import LossConfig
from ..ops.image import sobel_gradients

F32 = torch.float32


def _per_sample(x: torch.Tensor) -> torch.Tensor:
    """Sum over H, W keeping (B, C)."""
    return x.sum(dim=(2, 3))


def _masked_mean(per_sample_vals: torch.Tensor,
                 sample_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean over (B, C); with a (B,) mask, the mean over the selected samples
    only (0 when none is selected)."""
    if sample_mask is None:
        return per_sample_vals.mean()
    w = sample_mask.to(F32)[:, None]
    tot = (per_sample_vals * w).sum()
    cnt = w.sum() * per_sample_vals.shape[1]
    return tot / torch.clamp(cnt, min=1.0)


def dice_loss(logits, targets, smooth: float = 1.0, sample_mask=None):
    p = torch.sigmoid(logits.to(F32))
    t = targets.to(F32)
    num = 2.0 * _per_sample(p * t) + smooth
    den = _per_sample(p) + _per_sample(t) + smooth
    return _masked_mean(1.0 - num / den, sample_mask)


def tversky_loss(logits, targets, alpha: float = 0.7, beta: float = 0.3,
                 smooth: float = 1.0, sample_mask=None):
    p = torch.sigmoid(logits.to(F32))
    t = targets.to(F32)
    tp = _per_sample(p * t)
    fp = _per_sample(p * (1.0 - t))
    fn = _per_sample((1.0 - p) * t)
    tv = (tp + smooth) / (tp + alpha * fp + beta * fn + smooth)
    return _masked_mean(1.0 - tv, sample_mask)


def bce_with_logits(logits, targets, weight=None, sample_mask=None):
    l = logits.to(F32)
    t = targets.to(F32)
    # at l == 0 (a pixel whose features are all zero) the gradient follows
    # JAX's conventions: jnp.maximum splits it 0.5 / 0.5, jnp.abs takes +1
    abs_l = torch.where(l >= 0, l, -l)
    per = torch.maximum(l, l.new_zeros(())) - l * t + \
        torch.log1p(torch.exp(-abs_l))
    if weight is not None:
        per = per * weight
    if sample_mask is None:
        return per.mean()
    w = sample_mask.to(F32).reshape((-1,) + (1,) * (per.dim() - 1))
    tot = (per * w).sum()
    cnt = w.sum() * float(per[0].numel())
    return tot / torch.clamp(cnt, min=1.0)


def combo_loss(logits, targets, smooth: float = 1.0, sample_mask=None):
    """Dice + BCE (``ComboLoss``)."""
    return dice_loss(logits, targets, smooth, sample_mask) + \
        bce_with_logits(logits, targets)


def edge_loss(logits, targets, sample_mask=None):
    """L1 between the Sobel gradient magnitudes of sigmoid(pred) and the
    target."""
    p = torch.sigmoid(logits.to(F32))[:, 0]                   # (B, H, W)
    t = targets.to(F32)[:, 0]
    gxp, gyp = sobel_gradients(p)
    gxt, gyt = sobel_gradients(t)
    gp = torch.sqrt(gxp ** 2 + gyp ** 2 + 1e-8)
    gt = torch.sqrt(gxt ** 2 + gyt ** 2 + 1e-8)
    per_px = torch.where(gp >= gt, gp - gt, gt - gp)   # jnp.abs at 0: +1
    if sample_mask is None:
        return per_px.mean()
    w = sample_mask.reshape((-1, 1, 1)).to(F32)
    tot = (per_px * w).sum()
    cnt = w.sum() * per_px.shape[1] * per_px.shape[2]
    return tot / torch.clamp(cnt, min=1.0)


def iou_score(logits, targets, thr: float = 0.5):
    p = (torch.sigmoid(logits.to(F32)) > thr).to(F32)
    t = targets.to(F32)
    inter = _per_sample(p * t)
    union = _per_sample(p) + _per_sample(t) - inter
    return (inter / (union + 1e-7)).mean()


def build_criterion(cfg: LossConfig, stage: str = "main") -> Callable:
    """criterion(logits, targets) -> scalar tensor.

    Weighted BCE over every sample (empty-mask samples down-weighted by
    ``neg_bce_weight`` in the finetune stage) + Dice (combo: + BCE again) or
    Tversky and the Sobel edge loss over the positive samples only; both
    positive-only terms are 0 when the batch has no positive sample."""
    if cfg.loss_type == "combo":
        # the reference wiring: positives get BCE twice (ComboLoss on the
        # positive subset on top of the global weighted BCE)
        def base(l, t, m):
            return dice_loss(l, t, cfg.dice_smooth, m) + \
                bce_with_logits(l, t, sample_mask=m)
    elif cfg.loss_type == "tversky":
        def base(l, t, m):
            return tversky_loss(l, t, cfg.tversky_alpha, cfg.tversky_beta,
                                cfg.dice_smooth, m)
    else:
        raise ValueError(f"unknown loss_type {cfg.loss_type!r}")

    def criterion(logits, targets):
        l = logits.to(F32)
        t = targets.to(F32)
        is_empty = _per_sample(t)[:, 0] == 0                    # (B,)
        pos = ~is_empty
        weight = None
        if stage == "finetune":
            weight = torch.where(is_empty, cfg.neg_bce_weight,
                                 1.0)[:, None, None, None]
        bce = bce_with_logits(l, t, weight)
        any_pos = pos.any()
        zero = torch.zeros((), dtype=F32, device=l.device)
        d = torch.where(any_pos, base(l, t, pos), zero)
        e = zero
        if cfg.edge_weight > 0:
            e = torch.where(any_pos, edge_loss(l, t, pos) * cfg.edge_weight,
                            zero)
        return d + bce + e

    return criterion
