"""Loss zoo of the reference criterion builder, the counterpart of
``att_aspp_unet_tpu/train/losses.py``.

Inputs are NCHW: logits (B, 1, H, W), targets (B, 1, H, W) in {0, 1}.
Spatial reductions run per (sample, channel) over (H, W), then average.  The
positive-sample-only Dice / edge terms are masked means, not boolean
gathers, so no value crosses to the host.  Losses compute in f32 (f64 for
f64 logits).

Every batch mean is a ratio of sums, ``tot / max(cnt, 1)``.  Under a
data-parallel process group (``parallel/mesh.py``) each rank holds some rows
of the global batch, and both sums are summed over the ranks before the
division (and "any positive sample" is a global OR): averaging the ranks'
own ratios would weigh a rank with few positive samples as much as one with
many.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..config import LossConfig
from ..ops.image import sobel_gradients
from ..parallel.mesh import all_reduce_sum, group_size

F32 = torch.float32


def _ft(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.promote_types(x.dtype, F32))


def _ratio(tot: torch.Tensor, cnt: torch.Tensor) -> torch.Tensor:
    """``tot / max(cnt, 1)`` of the global batch."""
    if group_size() > 1:
        both = all_reduce_sum(torch.stack([tot, cnt.to(tot.dtype)]))
        tot, cnt = both[0], both[1]
    return tot / torch.clamp(cnt, min=1.0)


def _mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the global batch."""
    if group_size() == 1:
        return x.mean()
    return _ratio(x.sum(), x.new_full((), float(x.numel())))


def _per_sample(x: torch.Tensor) -> torch.Tensor:
    """Sum over H, W keeping (B, C)."""
    return x.sum(dim=(2, 3))


def _masked_mean(per_sample_vals: torch.Tensor,
                 sample_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean over (B, C); with a (B,) mask, the mean over the selected samples
    only (0 when none is selected)."""
    if sample_mask is None:
        return _mean(per_sample_vals)
    w = sample_mask.to(per_sample_vals.dtype)[:, None]
    tot = (per_sample_vals * w).sum()
    cnt = w.sum() * per_sample_vals.shape[1]
    return _ratio(tot, cnt)


def dice_loss(logits, targets, smooth: float = 1.0, sample_mask=None):
    p = torch.sigmoid(_ft(logits))
    t = targets.to(p.dtype)
    num = 2.0 * _per_sample(p * t) + smooth
    den = _per_sample(p) + _per_sample(t) + smooth
    return _masked_mean(1.0 - num / den, sample_mask)


def tversky_loss(logits, targets, alpha: float = 0.7, beta: float = 0.3,
                 smooth: float = 1.0, sample_mask=None):
    p = torch.sigmoid(_ft(logits))
    t = targets.to(p.dtype)
    tp = _per_sample(p * t)
    fp = _per_sample(p * (1.0 - t))
    fn = _per_sample((1.0 - p) * t)
    tv = (tp + smooth) / (tp + alpha * fp + beta * fn + smooth)
    return _masked_mean(1.0 - tv, sample_mask)


def bce_with_logits(logits, targets, weight=None, sample_mask=None):
    l = _ft(logits)
    t = targets.to(l.dtype)
    # at l == 0 (a pixel whose features are all zero) the gradient follows
    # JAX's conventions: jnp.maximum splits it 0.5 / 0.5, jnp.abs takes +1
    abs_l = torch.where(l >= 0, l, -l)
    per = torch.maximum(l, l.new_zeros(())) - l * t + \
        torch.log1p(torch.exp(-abs_l))
    if weight is not None:
        per = per * weight
    if sample_mask is None:
        return _mean(per)
    w = sample_mask.to(per.dtype).reshape((-1,) + (1,) * (per.dim() - 1))
    tot = (per * w).sum()
    cnt = w.sum() * float(per[0].numel())
    return _ratio(tot, cnt)


def combo_loss(logits, targets, smooth: float = 1.0, sample_mask=None):
    """Dice + BCE (``ComboLoss``)."""
    return dice_loss(logits, targets, smooth, sample_mask) + \
        bce_with_logits(logits, targets)


def edge_loss(logits, targets, sample_mask=None):
    """L1 between the Sobel gradient magnitudes of sigmoid(pred) and the
    target."""
    p = torch.sigmoid(_ft(logits))[:, 0]                      # (B, H, W)
    t = targets.to(p.dtype)[:, 0]
    gxp, gyp = sobel_gradients(p)
    gxt, gyt = sobel_gradients(t)
    gp = torch.sqrt(gxp ** 2 + gyp ** 2 + 1e-8)
    gt = torch.sqrt(gxt ** 2 + gyt ** 2 + 1e-8)
    per_px = torch.where(gp >= gt, gp - gt, gt - gp)   # jnp.abs at 0: +1
    if sample_mask is None:
        return _mean(per_px)
    w = sample_mask.reshape((-1, 1, 1)).to(per_px.dtype)
    tot = (per_px * w).sum()
    cnt = w.sum() * per_px.shape[1] * per_px.shape[2]
    return _ratio(tot, cnt)


def iou_score(logits, targets, thr: float = 0.5):
    logits = _ft(logits)
    p = (torch.sigmoid(logits) > thr).to(logits.dtype)
    t = targets.to(logits.dtype)
    inter = _per_sample(p * t)
    union = _per_sample(p) + _per_sample(t) - inter
    return _mean(inter / (union + 1e-7))


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
        l = _ft(logits)
        t = targets.to(l.dtype)
        is_empty = _per_sample(t)[:, 0] == 0                    # (B,)
        pos = ~is_empty
        weight = None
        if stage == "finetune":
            weight = torch.where(is_empty, cfg.neg_bce_weight,
                                 1.0)[:, None, None, None]
        bce = bce_with_logits(l, t, weight)
        if group_size() > 1:
            any_pos = all_reduce_sum(pos.sum().to(l.dtype)) > 0
        else:
            any_pos = pos.any()
        zero = torch.zeros((), dtype=l.dtype, device=l.device)
        d = torch.where(any_pos, base(l, t, pos), zero)
        e = zero
        if cfg.edge_weight > 0:
            e = torch.where(any_pos, edge_loss(l, t, pos) * cfg.edge_weight,
                            zero)
        return d + bce + e

    return criterion
