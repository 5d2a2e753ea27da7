"""The InstanceNorm of nnU-Net and Swin UNETR, and where nnU-Net's norm +
LeakyReLU runs.  Every bf16 norm of either network on a card is
``swin_ops.instance_norm_act``'s kernels; elsewhere each keeps the plain
arithmetic of its oracle (nnU-Net the JAX model's, Swin UNETR MONAI's)."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .swin_ops import instance_norm_act


class InstanceNorm(nn.Module):
    """nnU-Net's norm op (InstanceNorm2d, affine, eps 1e-5): per-sample,
    per-channel statistics of each (H, W) plane in f32, the affine transform
    in f32, then the cast to the input's dtype, as the JAX model computes it.
    To read the activation twice and write it once instead of the nine
    passes of that order, the statistics come from one pass each, read
    straight from the input (the mean, and the sum of squares with
    ``var = E[x^2] - mean^2``, where the JAX model takes the mean of squared
    deviations), and the folded affine ``x * s + (bias - mean * s)`` with
    ``s = rsqrt(var + eps) * weight`` writes the input's dtype directly.
    Both differ from the JAX order by f32 roundings of the statistics, far
    below a bf16 step while the planes' means are not orders of magnitude
    above their standard deviations."""

    def __init__(self, channels: int, eps: float = 1e-5, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels, device=device,
                                              dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(channels, device=device,
                                             dtype=dtype))

    @torch.no_grad()
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        f32 = torch.float32
        n = x.shape[2] * x.shape[3]
        mean = x.mean(dim=(2, 3), keepdim=True, dtype=f32)
        sq = torch.linalg.vector_norm(x, dim=(2, 3), keepdim=True, dtype=f32)
        var = sq.square_().div_(n).sub_(mean.square()).clamp_(min=0.0)
        scale = torch.rsqrt(var.add_(self.eps)).mul_(
            self.weight.to(f32)[:, None, None])
        shift = self.bias.to(f32)[:, None, None] - mean * scale
        return torch.addcmul(shift, x, scale, out=torch.empty_like(x))


def fused_norm_applies(y: torch.Tensor) -> bool:
    """Whether the norm + LeakyReLU of the conv output ``y`` goes through
    the kernels: every bf16 ``y`` on a card (they raise on channels or an
    affine they cannot take, so that no plan loses them unseen)."""
    return y.is_cuda and y.dtype == torch.bfloat16


def conv_norm_act(y: torch.Tensor, norm: InstanceNorm,
                  slope: float) -> torch.Tensor:
    """nnU-Net's ``LeakyReLU(slope)(norm(y))`` of a conv output: the kernels
    (f32 inside, one rounding) where :func:`fused_norm_applies`."""
    if fused_norm_applies(y):
        # a no-op where cuDNN kept the map channel-last, as it does for
        # the engine's channel-last model
        return instance_norm_act(
            y.contiguous(memory_format=torch.channels_last), norm, slope)
    return F.leaky_relu_(norm(y), slope)
