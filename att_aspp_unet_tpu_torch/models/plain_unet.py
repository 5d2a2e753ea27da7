"""PlainConvUNet: the nnU-Net-style network of the baseline path.

Counterpart of ``att_aspp_unet_tpu/models/plain_unet.py``: an nnU-Net v2
``PlainConvUNet`` as planned in ``resources/nnUNet_results/.../plans.json``
(7 stages, base 32 features capped at 512, 2 convs per stage, stride-2
downsampling from stage 1 on, 2x2 transposed-conv decoder).  Each conv is
followed by InstanceNorm and LeakyReLU(0.01); only the full-resolution
segmentation head is built (inference never reads the deep-supervision
heads).

Parameters carry nnU-Net v2's names, so a ``checkpoint_final.pth`` loads with
``load_state_dict`` once its keys are normalised
(``utils/nnunet_import.py``):

- ``encoder.stages.{s}.0.convs.{c}.{conv,norm}.{weight,bias}``
- ``decoder.transpconvs.{i}.{weight,bias}``           (stage s = n - 2 - i)
- ``decoder.stages.{i}.convs.{c}.{conv,norm}.{weight,bias}``
- ``decoder.seg_layers.{n-2}.{weight,bias}``           (full-resolution head)

Conv weights are held in the compute dtype (the JAX model casts its f32
parameters to it at every use, which rounds the same way); InstanceNorm's
affine parameters stay in ``param_dtype``.  On a card the activations are
channel-last in memory; ``ops/kernels/instance_norm.py`` holds the norm.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import PlainUNetConfig
from ..ops.kernels.instance_norm import InstanceNorm, conv_norm_act

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
SLOPE = 0.01                  # nnU-Net's LeakyReLU


class ConvNormAct(nn.Module):
    """3x3 conv (padding 1, stride 1 or 2) -> InstanceNorm -> LeakyReLU(0.01)
    in the compute dtype.  The conv's bias is a per-channel constant that
    the norm's mean subtracts again, so the forward leaves it out (on a card
    PyTorch adds it in a pass of its own over the activation); the parameter
    stays, for the checkpoints' names."""

    def __init__(self, cin: int, cout: int, stride: int, device, dtype,
                 param_dtype):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 3, stride=stride, padding=1,
                              bias=True, device=device, dtype=dtype)
        self.norm = InstanceNorm(cout, device=device, dtype=param_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_norm_act(
            F.conv2d(x, self.conv.weight, None, self.conv.stride, 1),
            self.norm, SLOPE)


class StackedConvBlocks(nn.Module):
    def __init__(self, cin: int, cout: int, n_convs: int, first_stride: int,
                 **kw):
        super().__init__()
        self.convs = nn.ModuleList(
            [ConvNormAct(cin if c == 0 else cout, cout,
                         first_stride if c == 0 else 1, **kw)
             for c in range(n_convs)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv in self.convs:
            x = conv(x)
        return x


class PlainConvUNet(nn.Module):
    """Input (B, in_channels, H, W) with H, W multiples of 2**(n_stages-1)
    -> full-resolution logits (B, num_classes, H, W) f32."""

    def __init__(self, cfg: PlainUNetConfig = PlainUNetConfig(), device=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = _DTYPES[cfg.compute_dtype]
        kw = dict(device=device, dtype=self.dtype,
                  param_dtype=_DTYPES[cfg.param_dtype])
        n = cfg.n_stages
        feats = [min(cfg.base_c * 2 ** s, cfg.max_c) for s in range(n)]
        self.encoder = nn.Module()
        self.encoder.stages = nn.ModuleList()
        cin = cfg.in_channels
        for s in range(n):
            # nnU-Net wraps each encoder stage in a Sequential: ``stages.{s}.0``
            self.encoder.stages.append(nn.Sequential(StackedConvBlocks(
                cin, feats[s], cfg.conv_per_stage, 2 if s else 1, **kw)))
            cin = feats[s]
        self.decoder = nn.Module()
        self.decoder.transpconvs = nn.ModuleList()
        self.decoder.stages = nn.ModuleList()
        for i in range(n - 1):
            s = n - 2 - i
            self.decoder.transpconvs.append(nn.ConvTranspose2d(
                feats[s + 1], feats[s], 2, stride=2, device=device,
                dtype=self.dtype))
            self.decoder.stages.append(StackedConvBlocks(
                2 * feats[s], feats[s], cfg.conv_per_stage, 1, **kw))
        self.decoder.seg_layers = nn.ModuleDict({str(n - 2): nn.Conv2d(
            feats[0], cfg.num_classes, 1, device=device, dtype=self.dtype)})

    @classmethod
    def from_config(cls, cfg: PlainUNetConfig, device=None,
                    seed: int = 0) -> "PlainConvUNet":
        """The model on ``device`` with :func:`init_weights` of ``seed``."""
        return init_weights(cls(cfg, device=device), seed).eval()

    @property
    def head(self) -> nn.Conv2d:
        return self.decoder.seg_layers[str(self.cfg.n_stages - 2)]

    @torch.no_grad()
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        step = 2 ** (self.cfg.n_stages - 1)
        if x.shape[-2] % step or x.shape[-1] % step:
            raise ValueError(f"input {tuple(x.shape[-2:])}: both sides must "
                             f"be multiples of {step}")
        x = x.to(self.dtype)
        if x.is_cuda:
            x = x.contiguous(memory_format=torch.channels_last)
        skips = []
        for stage in self.encoder.stages:
            x = stage(x)
            skips.append(x)
        skips.pop()
        for up, stage in zip(self.decoder.transpconvs, self.decoder.stages):
            x = stage(torch.cat([up(x), skips.pop()], dim=1))
        return self.head(x).float()


def init_weights(model: PlainConvUNet, seed: int) -> PlainConvUNet:
    """Seeded initialisation with flax's default initialisers, drawn from a
    CPU generator so that every device gets the same numbers: conv and
    transposed-conv kernels LeCun-normal (truncated at two standard
    deviations, variance 1 / fan-in over the input channels and taps), biases
    0, InstanceNorm scale 1 and bias 0.  The numbers are not those of
    ``model.init(PRNGKey(seed))`` of the JAX package."""
    gen = torch.Generator().manual_seed(int(seed))
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d)):
                w = mod.weight
                # Conv2d (out, in, kh, kw); ConvTranspose2d (in, out, kh, kw)
                cin = w.shape[0] if isinstance(mod, nn.ConvTranspose2d) \
                    else w.shape[1]
                std = math.sqrt(1.0 / (cin * w.shape[2] * w.shape[3])) \
                    / 0.87962566103423978
                t = torch.empty(w.shape, dtype=torch.float32)
                nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                      generator=gen)
                w.copy_(t)
                mod.bias.zero_()
            elif isinstance(mod, InstanceNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
    return model
