"""Attention-ASPP-UNet eval forward as an ``nn.Module``, every variant.

Counterpart of ``att_aspp_unet_tpu/models/att_aspp_unet.py`` at inference,
run as the BN-folded packed plan of ``att_aspp_unet_tpu/infer/fast_forward.py``:
a 4-level encoder (base_c x {1, 2, 4, 8}) of fused CBR pairs, the bridge
(base_c x 16: ASPP, or one ConvBNReLU with ``use_aspp=False``), decoder
stages u4..u1 gated as :func:`gated` says (v1 gates on u4/u3/u2, v2 gates on
u4/u3 up to ``att_depth``, none with ``use_att=False``), and a 1x1 output
conv.  Weights come from the JAX package's variables through
``utils.convert.jax_variables_to_torch``.

With ``conv_lowering="int8"`` every 3x3 ConvBNReLU serves quantized, at the
JAX package's sites: the pairs d1..d4 and u4..u1 (:class:`Int8CBRPair`) and
the ``--no_aspp`` bridge conv (:class:`Int8ConvBNReLU`); everything else
stays in the compute dtype.  :meth:`AttentionASPPUNet.calibrate` is the
direct model's calibration forward.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import ModelConfig
from ..nn.blocks import (ASPP, ConvBNReLU, FusedCBRPair, Int8CBRPair,
                         Int8ConvBNReLU, UpBlock)
from ..nn.quant import conv_sites, tree_set

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def gated(cfg: ModelConfig, level: int) -> bool:
    """Whether decoder level ``level`` (4..1) carries a gate: v1 wiring gates
    u4/u3/u2, v2 wiring u4/u3 subject to ``att_depth``; none without
    ``use_att``."""
    if not cfg.use_att:
        return False
    if cfg.gate_variant == "v1":
        return level >= 2
    return level >= 3 and cfg.att_depth >= level


class AttentionASPPUNet(nn.Module):
    """Input (B, in_channels, S, S) with S a multiple of 16 -> logits
    (B, num_classes, S, S) f32.  Activations are channel-last in memory
    between the blocks (``nn/blocks.py``)."""

    def __init__(self, cfg: ModelConfig = ModelConfig(), device=None):
        super().__init__()
        if cfg.gate_variant not in ("v1", "v2"):
            raise ValueError(f"gate_variant {cfg.gate_variant!r}: expected "
                             "'v1' or 'v2'")
        self.cfg = cfg
        self.dtype = _DTYPES[cfg.compute_dtype]
        kw = dict(device=device, dtype=self.dtype)
        int8 = cfg.conv_lowering == "int8"
        pair = Int8CBRPair if int8 else FusedCBRPair
        c = cfg.base_c
        widths = {1: c, 2: 2 * c, 3: 4 * c, 4: 8 * c}
        cin = cfg.in_channels
        for lvl in (1, 2, 3, 4):
            setattr(self, f"d{lvl}", pair(cin, widths[lvl], widths[lvl], **kw))
            cin = widths[lvl]
        if cfg.use_aspp:
            self.bridge = ASPP(8 * c, 16 * c, cfg.aspp_rates, **kw)
        else:
            self.bridge_conv = (Int8ConvBNReLU if int8 else ConvBNReLU)(
                8 * c, 16 * c, **kw)
        g = 16 * c
        for lvl in (4, 3, 2, 1):
            setattr(self, f"u{lvl}", UpBlock(g, widths[lvl], gated(cfg, lvl),
                                             cfg.gate_variant, pair=pair,
                                             **kw))
            g = widths[lvl]
        self.register_buffer("out_w", torch.zeros(c, cfg.num_classes, **kw))
        self.register_buffer("out_b", torch.zeros(cfg.num_classes,
                                                  dtype=torch.float32,
                                                  device=device))

    @torch.no_grad()
    def forward(self, x: torch.Tensor, return_psi: bool = False):
        """Logits; with ``return_psi`` also ``[psi3, psi2]``, the (B, 1, S/8,
        S/8) and (B, 1, S/4, S/4) attention maps of u4 and u3 in the compute
        dtype, None for an ungated level (v1 also gates u2; as in the JAX
        model its map is not returned)."""
        S1, S2 = x.shape[-2], x.shape[-1]
        if S1 % 16 or S2 % 16:
            raise ValueError(f"input {S1}x{S2}: both sides must be multiples "
                             "of 16 (four 2x2 poolings)")
        # channel-last memory from here on (free for one input channel)
        x = x.to(self.dtype).contiguous(memory_format=torch.channels_last)
        x1 = self.d1(x)
        x2 = self.d2(F.max_pool2d(x1, 2))
        x3 = self.d3(F.max_pool2d(x2, 2))
        x4 = self.d4(F.max_pool2d(x3, 2))
        hb = F.max_pool2d(x4, 2)
        b = self.bridge(hb) if self.cfg.use_aspp else self.bridge_conv(hb)
        d, psi3 = self.u4(b, x4)
        d, psi2 = self.u3(d, x3)
        d, _ = self.u2(d, x2)
        d, _ = self.u1(d, x1)
        logits = d.permute(0, 2, 3, 1).float() @ self.out_w.float()
        logits = (logits + self.out_b).permute(0, 3, 1, 2)
        return (logits, [psi3, psi2]) if return_psi else logits

    def site_modules(self):
        """(module, its sites in the quant tree) of every 3x3 ConvBNReLU
        site, in forward order."""
        mods = [(getattr(self, f"d{lvl}"), 2) for lvl in (1, 2, 3, 4)]
        if not self.cfg.use_aspp:
            mods.append((self.bridge_conv, 1))
        mods += [(getattr(self, f"u{lvl}").pair, 2) for lvl in (4, 3, 2, 1)]
        sites = iter(conv_sites(self.cfg.use_aspp))
        return [(m, [next(sites) for _ in range(k)]) for m, k in mods]

    @torch.no_grad()
    def calibrate(self, x: torch.Tensor) -> dict:
        """The calibration forward of the int8 path on a direct model: one
        forward of ``x`` recording max |input| of every 3x3 ConvBNReLU conv
        (a pair's second conv through K1's calibration mode).  Returns the
        JAX ``quant`` collection's ``act_absmax`` tree (``d1_0/conv/
        act_absmax``, ...), one f32 tensor on x's device per site."""
        if self.cfg.conv_lowering != "direct":
            raise ValueError("calibrate runs on the direct model")
        mods = self.site_modules()
        for m, _ in mods:
            m.record = []
        try:
            self.forward(x)
            tree: dict = {}
            for m, sites in mods:
                (values,) = m.record
                for site, v in zip(sites, values):
                    tree_set(tree, site, "act_absmax", v)
        finally:
            for m, _ in mods:
                m.record = None
        return tree
