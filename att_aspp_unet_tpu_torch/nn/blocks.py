"""Eval-only building blocks of the Attention-ASPP-UNet: logical shape
(N, C, H, W), memory channel-last.

Counterpart of ``att_aspp_unet_tpu/nn/blocks.py`` for inference, built from
the BN-folded packed plan of ``att_aspp_unet_tpu/infer/fast_forward.py``
and extended to every variant of the model: v1 gates (BN folded) and v2
gates (no BN, a bias on psi, residual ``x*a + x``), and the single
ConvBNReLU bridge of ``--no_aspp``.  Every module holds its weights as
buffers in the model's compute dtype and its folded BatchNorm scale/bias
and conv biases in f32.

Precision follows the packed plan: in bf16 each op computes in f32 on the
bf16 operands and rounds its result to bf16; in f32 nothing is rounded (the
reference-precision mode the tests hold against the flax model).  Every
3x3 ConvBNReLU pair is one launch of kernel K1
(``ops/kernels/fused_conv.fused_double_cbr``); the ASPP branches, the
``--no_aspp`` bridge conv, the 1x1 convs and the transposed conv are plain
torch ops, as the JAX package left them to XLA.

Layout: every block takes and returns (N, C, H, W) tensors whose memory is
``torch.channels_last`` (NHWC strides), the layout K1 reads and writes, so
no pair pays a layout copy.  The 1x1 convs and the transposed conv are
matmuls over the last dimension of the NHWC view; pooling and concat keep
the format; the ASPP's exact-f32 dilated convs alone run on a contiguous
copy of the bridge tensor.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.kernels.fused_conv import (exact_f32, fused_double_cbr,
                                       prepack_pair)

F32 = torch.float32


def _affine(y, s, b):
    return y * s[None, :, None, None] + b[None, :, None, None]


def pointwise(x, w, s=None, b=None, relu=False, sigmoid=False):
    """1x1 conv (N,Ci,H,W) x (Ci,Co) in f32, optional scale ``s`` (folded
    BN) and bias ``b``, ReLU or sigmoid; result in x's dtype, channel-last in
    memory (a matmul over the last dimension of the NHWC view, returned as
    its NCHW view)."""
    y = x.permute(0, 2, 3, 1).to(F32) @ w.to(F32)
    if s is not None:
        y = y * s
    if b is not None:
        y = y + b
    if relu:
        y = torch.relu(y)
    if sigmoid:
        y = torch.sigmoid(y)
    return y.to(x.dtype).permute(0, 3, 1, 2)


class FusedCBRPair(nn.Module):
    """Two chained Conv3x3(pad 1, no bias) + folded BN + ReLU: one K1 launch.
    Weights packed (Cout, 9*Cin) in (ky, kx, ci) order; on a card they are
    put into the kernel's order once, at the first forward after they were
    loaded or changed."""

    def __init__(self, cin: int, cmid: int, cout: int, device=None,
                 dtype=torch.bfloat16):
        super().__init__()
        kw = dict(device=device)
        self.register_buffer("w1", torch.zeros(cmid, 9 * cin, dtype=dtype, **kw))
        self.register_buffer("s1", torch.ones(cmid, dtype=F32, **kw))
        self.register_buffer("b1", torch.zeros(cmid, dtype=F32, **kw))
        self.register_buffer("w2", torch.zeros(cout, 9 * cmid, dtype=dtype, **kw))
        self.register_buffer("s2", torch.ones(cout, dtype=F32, **kw))
        self.register_buffer("b2", torch.zeros(cout, dtype=F32, **kw))
        self._packed = None
        self._packed_of = None

    def packed(self):
        """The weights in the kernel's order, rebuilt only when ``w1`` or
        ``w2`` was replaced, moved or written to."""
        of = tuple((w.data_ptr(), w._version, w.device) for w in
                   (self.w1, self.w2))
        if self._packed_of != of:
            self._packed = prepack_pair(self.w1, self.w2)
            self._packed_of = of
        return self._packed

    def forward(self, x):
        packed = self.packed() if x.device.type == "cuda" else None
        return fused_double_cbr(x, self.w1, self.s1, self.b1, self.w2,
                                self.s2, self.b2, packed=packed)


class ConvBNReLU(nn.Module):
    """One Conv3x3(pad 1, no bias) + folded BN + ReLU: the bridge of the
    ``--no_aspp`` variant (its Dropout is the identity at eval).  A library
    convolution in the compute dtype (f32 accumulation), then the affine and
    ReLU in f32."""

    def __init__(self, cin: int, cout: int, device=None,
                 dtype=torch.bfloat16):
        super().__init__()
        kw = dict(device=device)
        # OIHW with channel-last strides, as the input's (a loaded state
        # dict is copied into these strides)
        self.register_buffer("w", torch.zeros(
            cout, cin, 3, 3, dtype=dtype, **kw).contiguous(
                memory_format=torch.channels_last))
        self.register_buffer("s", torch.ones(cout, dtype=F32, **kw))
        self.register_buffer("b", torch.zeros(cout, dtype=F32, **kw))

    def forward(self, x):
        with exact_f32():
            y = F.conv2d(x, self.w, padding=1)
        y = torch.relu(_affine(y.to(F32), self.s, self.b)).to(x.dtype)
        return y.contiguous(memory_format=torch.channels_last)


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling bridge: 1x1, three dilated 3x3
    (rates 6/12/18) and a global-pool branch, concatenated and projected by
    a 1x1 conv; each conv followed by folded BN + ReLU.  Dropout is the
    identity at eval."""

    def __init__(self, cin: int, features: int, rates: Sequence[int] = (6, 12, 18),
                 device=None, dtype=torch.bfloat16):
        super().__init__()
        self.rates = tuple(rates)
        kw = dict(device=device)

        def sb(name, c):
            self.register_buffer(f"{name}_s", torch.ones(c, dtype=F32, **kw))
            self.register_buffer(f"{name}_b", torch.zeros(c, dtype=F32, **kw))

        self.register_buffer("b0_w", torch.zeros(cin, features, dtype=dtype, **kw))
        sb("b0", features)
        for i in range(len(self.rates)):
            self.register_buffer(f"rate{i}_w", torch.zeros(
                features, cin, 3, 3, dtype=dtype, **kw))
            sb(f"rate{i}", features)
        self.register_buffer("pool_w", torch.zeros(cin, features, dtype=dtype, **kw))
        sb("pool", features)
        n_feats = (len(self.rates) + 2) * features
        self.register_buffer("proj_w", torch.zeros(n_feats, features, dtype=dtype, **kw))
        sb("proj", features)

    def forward(self, x):
        feats = [pointwise(x, self.b0_w, self.b0_s, self.b0_b, relu=True)]
        # NCHW for the exact-f32 dilated convs: on channel-last f32 input
        # without TF32, cuDNN falls to a direct kernel that took ~30x as long
        # on an NVIDIA H100 (PERF.md); the bridge tensor is the model's
        # smallest
        xf = x.to(F32).contiguous()
        for i, r in enumerate(self.rates):
            with exact_f32():
                y = F.conv2d(xf, getattr(self, f"rate{i}_w").to(F32),
                             padding=r, dilation=r)
            y = _affine(y, getattr(self, f"rate{i}_s"), getattr(self, f"rate{i}_b"))
            feats.append(torch.relu(y).to(x.dtype))
        m = xf.mean(dim=(2, 3), keepdim=True).to(x.dtype)
        p = pointwise(m, self.pool_w, self.pool_s, self.pool_b, relu=True)
        feats.append(p.expand_as(feats[0]))
        h = torch.cat(feats, dim=1)
        return pointwise(h, self.proj_w, self.proj_s, self.proj_b, relu=True)


class AttentionGateV1(nn.Module):
    """v1 gate: ``a = sigmoid(BN(psi(relu(BN(Wg g) + BN(Wx x)))))``; returns
    ``(x * a, a)``."""

    def __init__(self, cg: int, cx: int, inter: int, device=None,
                 dtype=torch.bfloat16):
        super().__init__()
        kw = dict(device=device)
        for name, ci, co in (("wg", cg, inter), ("wx", cx, inter),
                             ("psi", inter, 1)):
            self.register_buffer(f"{name}_w", torch.zeros(ci, co, dtype=dtype, **kw))
            self.register_buffer(f"{name}_s", torch.ones(co, dtype=F32, **kw))
            self.register_buffer(f"{name}_b", torch.zeros(co, dtype=F32, **kw))

    def forward(self, g, x):
        hg = pointwise(g, self.wg_w, self.wg_s, self.wg_b)
        hx = pointwise(x, self.wx_w, self.wx_s, self.wx_b)
        a = torch.relu(hg.to(F32) + hx.to(F32)).to(x.dtype)
        a = pointwise(a, self.psi_w, self.psi_s, self.psi_b, sigmoid=True)
        return x * a, a


class AttentionGateV2(nn.Module):
    """v2 gate: ``a = sigmoid(psi(relu(Wg g + Wx x)) + bias)``, no BN;
    returns ``(x * a + x, a)``."""

    def __init__(self, cg: int, cx: int, inter: int, device=None,
                 dtype=torch.bfloat16):
        super().__init__()
        kw = dict(device=device)
        self.register_buffer("wg_w", torch.zeros(cg, inter, dtype=dtype, **kw))
        self.register_buffer("wx_w", torch.zeros(cx, inter, dtype=dtype, **kw))
        self.register_buffer("psi_w", torch.zeros(inter, 1, dtype=dtype, **kw))
        self.register_buffer("psi_b", torch.zeros(1, dtype=F32, **kw))

    def forward(self, g, x):
        hg = pointwise(g, self.wg_w)
        hx = pointwise(x, self.wx_w)
        a = torch.relu(hg.to(F32) + hx.to(F32)).to(x.dtype)
        a = pointwise(a, self.psi_w, b=self.psi_b, sigmoid=True)
        xf = x.to(F32)
        return (xf * a.to(F32) + xf).to(x.dtype), a


class UpBlock(nn.Module):
    """Decoder stage: ConvTranspose 2x2 stride 2 of the gate signal, the
    skip through a v1 or v2 gate where ``use_att``, concat ``[skip, g]``, one
    fused CBR pair.  Returns ``(h, psi)``, psi None without a gate."""

    def __init__(self, cin: int, features: int, use_att: bool,
                 gate_variant: str = "v1", device=None, dtype=torch.bfloat16):
        super().__init__()
        kw = dict(device=device)
        # (u, v, ci, co), pre-flipped so out[2h+u, 2w+v] = x[h, w] @ k[u, v]
        self.register_buffer("up_k", torch.zeros(2, 2, cin, features, dtype=dtype, **kw))
        self.register_buffer("up_b", torch.zeros(features, dtype=F32, **kw))
        self.att = None
        if use_att and gate_variant == "v1":
            self.att = AttentionGateV1(features, features, features // 2,
                                       device=device, dtype=dtype)
        elif use_att:
            self.att = AttentionGateV2(features, features,
                                       max(8, features // 4),
                                       device=device, dtype=dtype)
        self.pair = FusedCBRPair(2 * features, features, features,
                                 device=device, dtype=dtype)

    def up(self, g):
        n, ci, h, w = g.shape
        o = self.up_k.shape[-1]
        k = self.up_k.to(F32).permute(2, 0, 1, 3).reshape(ci, 4 * o)
        t = (g.permute(0, 2, 3, 1).to(F32) @ k).reshape(n, h, w, 2, 2, o)
        t = (t + self.up_b).to(g.dtype)                # (n, h, w, u, v, o)
        t = t.permute(0, 1, 3, 2, 4, 5).reshape(n, 2 * h, 2 * w, o)
        return t.permute(0, 3, 1, 2)

    def forward(self, g, skip):
        g = self.up(g)
        psi = None
        if self.att is not None:
            skip, psi = self.att(g, skip)
        return self.pair(torch.cat([skip, g], dim=1)), psi
