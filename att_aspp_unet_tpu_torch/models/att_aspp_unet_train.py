"""The Attention-ASPP-UNet as a trainable module, every variant: the
counterpart of the flax ``__call__`` of
``att_aspp_unet_tpu/models/att_aspp_unet.py`` (:75-175) in train and eval
mode, built from ``nn/train_blocks.py``.

``model.train()`` uses batch statistics (and updates the running ones) and
Dropout; ``model.eval()`` the running statistics.  The forward returns
``(logits f32, [psi3, psi2])`` as the flax model does (None for an ungated
level).  Serving runs the BN-folded eval model of ``att_aspp_unet.py`` with
kernel K1; ``utils/convert.py`` carries the weights between the two.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import ModelConfig
from ..nn.train_blocks import ASPP, Conv, ConvBNReLU, UpBlock, dropout
from .att_aspp_unet import _DTYPES, gated


class AttentionASPPUNetTrain(nn.Module):
    """Input (B, in_channels, S, S) with S a multiple of 16; f32 parameters,
    compute in ``cfg.compute_dtype``, activations channel-last in memory."""

    def __init__(self, cfg: ModelConfig = ModelConfig(), device=None):
        super().__init__()
        if cfg.gate_variant not in ("v1", "v2"):
            raise ValueError(f"gate_variant {cfg.gate_variant!r}: expected "
                             "'v1' or 'v2'")
        self.cfg = cfg
        # float64: reference-precision checks of the gradients
        self.dtype = dict(_DTYPES, float64=torch.float64)[cfg.compute_dtype]
        kw = dict(device=device)
        c = cfg.base_c
        widths = {1: c, 2: 2 * c, 3: 4 * c, 4: 8 * c}
        cin = cfg.in_channels
        for lvl in (1, 2, 3, 4):
            setattr(self, f"d{lvl}_0", ConvBNReLU(cin, widths[lvl], **kw))
            setattr(self, f"d{lvl}_1", ConvBNReLU(widths[lvl], widths[lvl],
                                                  **kw))
            cin = widths[lvl]
        if cfg.use_aspp:
            self.bridge = ASPP(8 * c, 16 * c, cfg.aspp_rates,
                               cfg.aspp_dropout, **kw)
        else:
            self.bridge_conv = ConvBNReLU(8 * c, 16 * c, **kw)
        g = 16 * c
        for lvl in (4, 3, 2, 1):
            setattr(self, f"u{lvl}", UpBlock(g, widths[lvl], gated(cfg, lvl),
                                             cfg.gate_variant, **kw))
            g = widths[lvl]
        self.out_conv = Conv(c, cfg.num_classes, 1, bias=True, **kw)

    def forward(self, x: torch.Tensor, generator: torch.Generator = None):
        """Logits (B, num_classes, S, S) f32 (f64 for an f64 model) and
        ``[psi3, psi2]``, the
        attention maps of u4 and u3.  ``generator`` (on the input's device)
        draws the Dropout masks in training mode."""
        S1, S2 = x.shape[-2], x.shape[-1]
        if S1 % 16 or S2 % 16:
            raise ValueError(f"input {S1}x{S2}: both sides must be multiples "
                             "of 16 (four 2x2 poolings)")
        x = x.to(self.dtype).contiguous(memory_format=torch.channels_last)
        x1 = self.d1_1(self.d1_0(x))
        x2 = self.d2_1(self.d2_0(F.max_pool2d(x1, 2)))
        x3 = self.d3_1(self.d3_0(F.max_pool2d(x2, 2)))
        x4 = self.d4_1(self.d4_0(F.max_pool2d(x3, 2)))
        hb = F.max_pool2d(x4, 2)
        if self.cfg.use_aspp:
            b = self.bridge(hb, generator)
        else:
            b = dropout(self.bridge_conv(hb), self.cfg.aspp_dropout,
                        self.training, generator)
        d, psi3 = self.u4(b, x4)
        d, psi2 = self.u3(d, x3)
        d, _ = self.u2(d, x2)
        d, _ = self.u1(d, x1)
        logits = self.out_conv(d)
        return logits.to(torch.promote_types(self.dtype, torch.float32)), \
            [psi3, psi2]
