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
channel-last in memory, and every bf16 map there goes through the port's
InstanceNorm + LeakyReLU kernels (``ops/kernels/swin_ops.py``: one
statistics pass, one pass that writes the activated map), which raise on a
map or an affine they cannot take; the CPU and f32 maps run
:class:`InstanceNorm` and ``leaky_relu_``.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import PlainUNetConfig
from ..ops.kernels.swin_ops import instance_norm_act
from ..utils.profiling import count

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
SLOPE = 0.01                  # nnU-Net's LeakyReLU


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


def fused_norm_applies(y: torch.Tensor, norm: InstanceNorm) -> bool:
    """Whether ``norm`` + LeakyReLU of the conv output ``y`` goes through
    the port's kernels: every bf16 ``y`` on a card, whatever its channels
    and ``norm``'s affine (the kernels' entry raises on what it cannot
    take, so that no plan loses them unseen).  The CPU and f32 maps, which
    the kernels do not compute, keep :class:`InstanceNorm`'s arithmetic."""
    return y.is_cuda and y.dtype == torch.bfloat16


class ConvNormAct(nn.Module):
    """3x3 conv (padding 1, stride 1 or 2) -> InstanceNorm -> LeakyReLU(0.01)
    in the compute dtype.  The conv's bias is a per-channel constant that
    the norm's mean subtracts again, so the forward leaves it out (on a card
    PyTorch adds it in a pass of its own over the activation); the parameter
    stays, for the checkpoints' names.  Where :func:`fused_norm_applies`,
    the norm and the activation are the port's kernels, which compute the
    affine and the LeakyReLU in f32 and round once to bf16, and each such
    call is counted as ``fused_instance_norms``."""

    def __init__(self, cin: int, cout: int, stride: int, device, dtype,
                 param_dtype):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 3, stride=stride, padding=1,
                              bias=True, device=device, dtype=dtype)
        self.norm = InstanceNorm(cout, device=device, dtype=param_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x, self.conv.weight, None, self.conv.stride, 1)
        if fused_norm_applies(y, self.norm):
            count("fused_instance_norms")
            # a no-op where cuDNN kept the map channel-last, as it does for
            # the engine's channel-last model
            return instance_norm_act(
                y.contiguous(memory_format=torch.channels_last), self.norm,
                SLOPE)
        return F.leaky_relu_(self.norm(y), SLOPE)


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
