"""Train-mode building blocks of the Attention-ASPP-UNet, the counterparts of
``att_aspp_unet_tpu/nn/blocks.py``'s flax modules: ``ConvBNReLU``
(:115-141), ``ASPP`` (:185-245), ``AttentionGateV1`` (:247-276),
``AttentionGateV2`` (:278-300) and ``UpBlock`` (:302-344).

Every module and parameter carries the name of its flax counterpart
(``conv.kernel``, ``bn.scale``, ``Wg_conv``, ``branch1_conv``, ...), so a
state-dict key is the flax path joined by dots.  Parameters are f32
``nn.Parameter``s in PyTorch's layouts (conv kernels OIHW, the transposed
conv's kernel (in, out, kh, kw) and spatially flipped); each op computes in
the model's compute dtype, the parameters cast to it as flax casts them.
The convolutions are library calls: the JAX package runs them through XLA,
outside any Pallas kernel, and the fused kernel K1 folds BatchNorm into an
affine, which batch statistics do not allow.

BatchNorm is flax's, not ``nn.BatchNorm2d``: statistics in f32 as
``E[x^2] - mean^2`` clamped at 0, the running update ``0.9 old + 0.1
batch`` with the biased batch variance, eps 1e-5, the normalisation in f32
and its result cast to the compute dtype, written as flax writes it and
differentiated by autograd.  (PyTorch's fused batch-norm kernels, fed these
statistics, lost up to 2 % of the gradient of a BN whose per-channel sums
nearly cancel, where this formula stays within 4e-5 of the f64 gradient;
it costs some twenty elementwise passes per BN and step instead.)  Under a
data-parallel process group (``parallel/mesh.py``) the statistics are the
global batch's: each rank's sums of x and x^2 and its count are summed over
the ranks, differentiably, so that the running buffers agree on every rank
without a broadcast.  Dropout draws its keep mask from an explicit generator
(for the global batch, each rank keeping its rows) and scales the kept
values by 1 / (1 - rate).

Activations and conv kernels are channel-last in memory (the layout cuDNN's
bf16 convolutions take without a conversion); the one-channel input is
ambiguous, so each conv returns its result in that layout explicitly.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel.mesh import all_reduce_sum, group_size, shard_rows

F32 = torch.float32
MOMENTUM, EPSILON = 0.9, 1e-5
CL = torch.channels_last


def _kernel(*shape, device=None) -> nn.Parameter:
    return nn.Parameter(torch.zeros(*shape, dtype=F32, device=device)
                        .contiguous(memory_format=CL))


class Conv(nn.Module):
    """``nn.Conv`` / ``Conv3x3``: a k x k conv, stride 1, "SAME" padding
    (dilated by ``dilation``), optional bias; ``kernel`` is OIHW."""

    def __init__(self, cin: int, cout: int, k: int = 3, dilation: int = 1,
                 bias: bool = False, device=None):
        super().__init__()
        self.kernel = _kernel(cout, cin, k, k, device=device)
        self.bias = (nn.Parameter(torch.zeros(cout, dtype=F32, device=device))
                     if bias else None)
        self.dilation = dilation
        self.padding = dilation * (k // 2)

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, self.kernel.to(x.dtype), b, padding=self.padding,
                        dilation=self.dilation).contiguous(memory_format=CL)


class ConvTranspose(nn.Module):
    """``nn.ConvTranspose(features, (2, 2), strides=(2, 2))`` with bias;
    ``kernel`` is PyTorch's (in, out, 2, 2) layout of flax's spatially
    flipped HWIO kernel."""

    def __init__(self, cin: int, cout: int, device=None):
        super().__init__()
        self.kernel = _kernel(cin, cout, 2, 2, device=device)
        self.bias = nn.Parameter(torch.zeros(cout, dtype=F32, device=device))

    def forward(self, x):
        return F.conv_transpose2d(x, self.kernel.to(x.dtype),
                                  self.bias.to(x.dtype), stride=2
                                  ).contiguous(memory_format=CL)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over (N, H, W):
    batch statistics (and a running update) in training mode, the running
    ``mean`` / ``var`` in eval mode."""

    def __init__(self, c: int, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c, dtype=F32, device=device))
        self.bias = nn.Parameter(torch.zeros(c, dtype=F32, device=device))
        self.register_buffer("mean", torch.zeros(c, dtype=F32, device=device))
        self.register_buffer("var", torch.ones(c, dtype=F32, device=device))

    def forward(self, x):
        # the channel-last memory as (N, H, W, C): per-channel vectors
        # broadcast along the contiguous last dimension (vectorised kernels)
        xf = x.permute(0, 2, 3, 1).to(torch.promote_types(x.dtype, F32))
        if self.training:
            if group_size() > 1:
                # the global batch's statistics: sums and count over the
                # ranks, differentiable, then the same formula
                C = xf.shape[-1]
                cnt = xf.new_full((1,), xf.numel() // C)
                tot = all_reduce_sum(torch.cat([xf.sum(dim=(0, 1, 2)),
                                                (xf * xf).sum(dim=(0, 1, 2)),
                                                cnt]))
                mean, ex2 = tot[:C] / tot[-1], tot[C:2 * C] / tot[-1]
            else:
                mean = xf.mean(dim=(0, 1, 2))
                ex2 = (xf * xf).mean(dim=(0, 1, 2))
            # maximum, not clamp: a tie at 0 splits the gradient as
            # jnp.maximum's does
            var = torch.maximum(ex2 - mean * mean, xf.new_zeros(()))
            with torch.no_grad():
                self.mean.copy_(MOMENTUM * self.mean
                                + (1 - MOMENTUM) * mean.detach())
                self.var.copy_(MOMENTUM * self.var
                               + (1 - MOMENTUM) * var.detach())
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + EPSILON) * self.scale
        y = (xf - mean) * mul + self.bias
        return y.to(x.dtype).permute(0, 3, 1, 2)


def dropout(x, rate: float, training: bool,
            generator: Optional[torch.Generator]):
    """flax ``nn.Dropout``: keep with probability 1 - rate, kept values
    divided by it; the identity at eval or with rate 0."""
    if not training or rate == 0.0:
        return x
    keep_prob = 1.0 - rate
    # drawn for the global batch, this rank keeping its rows: a data-parallel
    # run draws the one-process run's mask
    shape = (x.shape[0] * group_size(),) + tuple(x.shape[1:])
    keep = shard_rows(torch.rand(shape, generator=generator,
                                 device=x.device)) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype,
                                                        device=x.device))


class ConvBNReLU(nn.Module):
    """Conv3x3 (pad 1, no bias) -> BatchNorm -> ReLU."""

    def __init__(self, cin: int, cout: int, device=None):
        super().__init__()
        self.conv = Conv(cin, cout, 3, device=device)
        self.bn = BatchNorm(cout, device=device)

    def forward(self, x):
        return torch.relu(self.bn(self.conv(x)))


class ASPP(nn.Module):
    """Five branches (1x1; 3x3 dilated 6 / 12 / 18; global pool -> 1x1 ->
    broadcast), each conv -> BN -> ReLU, concatenated, projected by 1x1 ->
    BN -> ReLU, then Dropout."""

    def __init__(self, cin: int, features: int,
                 rates: Sequence[int] = (6, 12, 18), dropout: float = 0.1,
                 device=None):
        super().__init__()
        self.rates = tuple(rates)
        self.rate = dropout
        kw = dict(device=device)
        self.branch0_conv = Conv(cin, features, 1, **kw)
        self.branch0_bn = BatchNorm(features, **kw)
        for i, r in enumerate(self.rates, start=1):
            setattr(self, f"branch{i}_conv", Conv(cin, features, 3, r, **kw))
            setattr(self, f"branch{i}_bn", BatchNorm(features, **kw))
        self.pool_conv = Conv(cin, features, 1, **kw)
        self.pool_bn = BatchNorm(features, **kw)
        self.project_conv = Conv((len(self.rates) + 2) * features, features,
                                 1, **kw)
        self.project_bn = BatchNorm(features, **kw)

    def forward(self, x, generator=None):
        feats = [torch.relu(self.branch0_bn(self.branch0_conv(x)))]
        for i in range(1, len(self.rates) + 1):
            h = getattr(self, f"branch{i}_conv")(x)
            feats.append(torch.relu(getattr(self, f"branch{i}_bn")(h)))
        p = x.to(F32).mean(dim=(2, 3), keepdim=True).to(x.dtype)
        p = torch.relu(self.pool_bn(self.pool_conv(p)))
        feats.append(p.expand_as(feats[0]))
        h = torch.relu(self.project_bn(self.project_conv(
            torch.cat(feats, dim=1))))
        return dropout(h, self.rate, self.training, generator)


class AttentionGateV1(nn.Module):
    """``x * a`` with ``a = sigmoid(BN(psi(relu(BN(Wg g) + BN(Wx x)))))``;
    returns ``(x * a, a)``."""

    def __init__(self, cg: int, cx: int, inter: int, device=None):
        super().__init__()
        kw = dict(device=device)
        self.Wg_conv = Conv(cg, inter, 1, **kw)
        self.Wg_bn = BatchNorm(inter, **kw)
        self.Wx_conv = Conv(cx, inter, 1, **kw)
        self.Wx_bn = BatchNorm(inter, **kw)
        self.psi_conv = Conv(inter, 1, 1, **kw)
        self.psi_bn = BatchNorm(1, **kw)

    def forward(self, g, x):
        hg = self.Wg_bn(self.Wg_conv(g))
        hx = self.Wx_bn(self.Wx_conv(x))
        a = torch.sigmoid(self.psi_bn(self.psi_conv(torch.relu(hg + hx))))
        return x * a, a


class AttentionGateV2(nn.Module):
    """``a = sigmoid(psi(relu(Wg g + Wx x)))`` (bias on psi, no BN); returns
    ``(x * a + x, a)``."""

    def __init__(self, cg: int, cx: int, inter: int, device=None):
        super().__init__()
        kw = dict(device=device)
        self.Wg = Conv(cg, inter, 1, **kw)
        self.Wx = Conv(cx, inter, 1, **kw)
        self.psi = Conv(inter, 1, 1, bias=True, **kw)

    def forward(self, g, x):
        a = torch.sigmoid(self.psi(torch.relu(self.Wg(g) + self.Wx(x))))
        return x * a + x, a


class UpBlock(nn.Module):
    """ConvTranspose 2x2 stride 2 of the gate signal, the skip through a v1
    (Fint = F / 2) or v2 (Fint = max(8, F / 4)) gate where ``use_att``,
    concat ``[skip, g]``, two ConvBNReLU.  Returns ``(h, psi)``."""

    def __init__(self, cin: int, features: int, use_att: bool,
                 gate_variant: str = "v1", device=None):
        super().__init__()
        kw = dict(device=device)
        self.up = ConvTranspose(cin, features, **kw)
        self.att = None
        if use_att and gate_variant == "v1":
            self.att = AttentionGateV1(features, features, features // 2, **kw)
        elif use_att:
            self.att = AttentionGateV2(features, features,
                                       max(8, features // 4), **kw)
        self.conv0 = ConvBNReLU(2 * features, features, **kw)
        self.conv1 = ConvBNReLU(features, features, **kw)

    def forward(self, g, x):
        g = self.up(g)
        if g.shape[-2:] != x.shape[-2:]:
            raise ValueError(f"up-sampled {tuple(g.shape[-2:])} against skip "
                             f"{tuple(x.shape[-2:])}: sides must be "
                             "multiples of 16")
        psi = None
        if self.att is not None:
            x, psi = self.att(g, x)
        h = self.conv1(self.conv0(torch.cat([x, g], dim=1)))
        return h, psi
