"""SwinUNETR: the labeled path's transformer network.

Swin UNETR (Hatamizadeh et al., "Swin UNETR: Swin Transformers for Semantic
Segmentation of Brain Tumors in MRI Images", arXiv:2201.01266) as MONAI's
``monai.networks.nets.SwinUNETR`` builds it with ``spatial_dims=2``,
``normalize=True``, ``downsample="merging"`` and ``use_v2=False``:

- patch embedding: ``Conv2d(in, F, k=2, s=2)`` (bias, no norm);
- stage i = 0..3 at width C = F * 2**i: ``depths[i]`` Swin blocks, block j
  ``x += Attn_j(LN(x))`` then ``x += MLP(LN(x))`` with
  ``MLP = Linear(C, 4C) -> GELU (erf) -> Linear(4C, C)``.  ``Attn_j``
  zero-pads the normed map right and bottom to a multiple of the window,
  for odd j rolls it by (-3, -3) and adds the -100 region mask of the
  padded size, partitions it into 7x7 windows and computes
  ``softmax(q k^T / sqrt(16) + B[rel_index] + mask) v`` with the
  ``(13 * 13, heads)`` relative-position table B, projects, reverses the
  windows and the roll and crops.  Padded tokens take part as keys.  A side
  not longer than the window shrinks the window to it and drops the shift
  there, and the bias is then ``B[rel_index[:n, :n]]``, as in MONAI.  The
  stage ends in patch merging: ``cat(x[0::2, 0::2], x[1::2, 0::2],
  x[0::2, 1::2], x[1::2, 1::2]) -> LN(4C) -> Linear(4C, 2C, bias=False)``;
- the five hidden states (the embedding and each stage's output), each
  layer-normed over its channels without an affine;
- the decoder: ``UnetResBlock``s (conv3x3 -> IN -> LReLU -> conv3x3 -> IN,
  plus conv1x1 -> IN on the residual where the channels change, then
  LReLU; convs without bias) on the input and on hidden states 0, 1, 2, 4,
  then five up blocks (transposed conv k2 s2 without bias, concatenated
  with the skip, then a ``UnetResBlock(2 * out -> out)``) and a 1x1 head.

Parameters carry MONAI's names (``swinViT.layers1.0.blocks.0.attn.qkv``,
``encoder1.layer.conv1.conv``, ``decoder5.transp_conv.conv``, ``out.conv.conv``,
...), so a MONAI state dict loads with ``load_state_dict``; the
InstanceNorms are affine (MONAI's ``norm_name="instance"`` has none: a MONAI
state dict leaves them at 1 and 0, which computes the same).

Precision: weights and activations in the compute dtype, tokens in
(B, H, W, C) order, which is the channel-last memory of the conv decoder's
(B, C, H, W) tensors; LayerNorm, softmax and InstanceNorm accumulate in f32.
On a card the network runs in bf16 through the port's kernels: the
LayerNorms (a block's second one with the attention's residual add), the
InstanceNorms with their residual and LeakyReLU, and the first conv block's
two convs of the 1-channel input (``ops/kernels/swin_ops.py``), and the
window attention, one ``window_attn_fwd`` launch a
block that reads q, k and v from the projection of the map as it is and
writes the map, with no padded, rolled or windowed copy
(``ops/kernels/window_attn.py``).  On the CPU the same functions' plain
versions run.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import SwinUNETRConfig
from ..ops.kernels.instance_norm import InstanceNorm
from ..ops.kernels.swin_ops import instance_norm_act, layer_norm, stem_convs
from ..ops.kernels.window_attn import window_and_shift, window_attn
from ..utils.profiling import count, span

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
STRIDE = 32                  # the network's total stride: tiles divide by it
PATCH = 2                    # the patch embedding's kernel and stride
MLP_RATIO = 4
SLOPE = 0.01                 # the conv blocks' LeakyReLU
# InstanceNorm's affine and the relative-position tables stay in f32 in
# every compute dtype
PARAM_DTYPE = torch.float32


def check_tile(hw) -> None:
    """Raise unless both sides of a tile are multiples of the network's
    total stride."""
    if any(int(s) % STRIDE for s in hw):
        raise ValueError(f"SwinUNETR tile {tuple(int(s) for s in hw)}: both "
                         f"sides must be multiples of {STRIDE}")


def relative_position_index(window: int) -> torch.Tensor:
    """(window**2, window**2) index into the (2w - 1)**2 bias table, rows
    and columns in a window's row-major token order."""
    coords = torch.stack(torch.meshgrid(torch.arange(window),
                                        torch.arange(window), indexing="ij"))
    flat = coords.flatten(1)
    rel = (flat[:, :, None] - flat[:, None, :]).permute(1, 2, 0) + window - 1
    return rel[:, :, 0] * (2 * window - 1) + rel[:, :, 1]


class WindowAttention(nn.Module):
    """The qkv and output projections and the relative-position table of
    one Swin block (MONAI's ``WindowAttention``)."""

    def __init__(self, dim: int, heads: int, window: int, device, dtype):
        super().__init__()
        self.heads = heads
        self.relative_position_bias_table = nn.Parameter(torch.zeros(
            (2 * window - 1) ** 2, heads, device=device, dtype=PARAM_DTYPE))
        self.register_buffer("relative_position_index",
                             relative_position_index(window).to(device))
        self.qkv = nn.Linear(dim, 3 * dim, device=device, dtype=dtype)
        self.proj = nn.Linear(dim, dim, device=device, dtype=dtype)


class Mlp(nn.Module):
    """MONAI's ``MLPBlock`` (``linear1`` -> GELU (erf) -> ``linear2``)."""

    def __init__(self, dim: int, hidden: int, device, dtype):
        super().__init__()
        self.linear1 = nn.Linear(dim, hidden, device=device, dtype=dtype)
        self.linear2 = nn.Linear(hidden, dim, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear2(F.gelu(self.linear1(x)))


def norm(x: torch.Tensor, ln: Optional[nn.LayerNorm], residual:
         Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x + residual, its LayerNorm ``ln`` over the channels; no affine
    where ``ln`` is None)."""
    if ln is None:
        return layer_norm(x, None, None, 1e-5, residual)
    return layer_norm(x, ln.weight, ln.bias, ln.eps, residual)


class SwinBlock(nn.Module):
    """One Swin block on (B, H, W, C) tokens; ``shift`` 0 or window // 2."""

    def __init__(self, dim: int, heads: int, window: int, shift: int,
                 device, dtype):
        super().__init__()
        self.window, self.shift = window, shift
        self.norm1 = nn.LayerNorm(dim, device=device, dtype=dtype)
        self.attn = WindowAttention(dim, heads, window, device, dtype)
        self.norm2 = nn.LayerNorm(dim, device=device, dtype=dtype)
        self.mlp = Mlp(dim, MLP_RATIO * dim, device, dtype)

    def attend(self, x: torch.Tensor) -> torch.Tensor:
        """The attention branch on normed tokens (B, H, W, C): the qkv
        projection of the map, :func:`window_attn` (the padding, the roll,
        the windows, the bias and the region mask), the output
        projection."""
        B, H, W, C = x.shape
        ws, _ = window_and_shift((H, W), self.window, self.shift)
        Hp, Wp = H + (-H % ws[0]), W + (-W % ws[1])
        count("window_attn_calls")
        count("window_attn_tokens", B * Hp * Wp)
        count("window_attn_pad_tokens", B * (Hp * Wp - H * W))
        a = self.attn
        with span("window_attention"):
            qkv = F.linear(x, a.qkv.weight, a.qkv.bias)
            out = window_attn(qkv, a.qkv.bias, a.relative_position_bias_table,
                              a.relative_position_index, a.heads,
                              self.window, self.shift)
            return F.linear(out, a.proj.weight, a.proj.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, h = norm(x, self.norm1)
        x, h = norm(x, self.norm2, residual=self.attend(h))
        return x + self.mlp(h)


class PatchMerging(nn.Module):
    """(B, H, W, C) -> (B, H/2, W/2, 2C): MONAI's 2-D patch merging (an odd
    side padded by one zero row or column)."""

    def __init__(self, dim: int, device, dtype):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, device=device, dtype=dtype)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False,
                                   device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        H, W = x.shape[1:3]
        if H % 2 or W % 2:
            x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                       x[:, 1::2, 1::2]], -1)
        return self.reduction(norm(x, self.norm)[1])


class BasicLayer(nn.Module):
    """One stage: its blocks (unshifted, shifted, ...) and patch merging."""

    def __init__(self, dim: int, depth: int, heads: int, window: int,
                 device, dtype):
        super().__init__()
        self.blocks = nn.ModuleList([SwinBlock(
            dim, heads, window, 0 if j % 2 == 0 else window // 2, device,
            dtype) for j in range(depth)])
        self.downsample = PatchMerging(dim, device, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for blk in self.blocks:
            x = blk(x)
        return self.downsample(x)


class PatchEmbed(nn.Module):
    def __init__(self, cin: int, dim: int, patch: int, device, dtype):
        super().__init__()
        self.proj = nn.Conv2d(cin, dim, patch, stride=patch, device=device,
                              dtype=dtype)


class SwinTransformer(nn.Module):
    """MONAI's ``SwinTransformer`` (``swinViT``): the patch embedding and
    the four stages, under MONAI's names (``layers1.0`` ... ``layers4.0``)."""

    def __init__(self, cfg: SwinUNETRConfig, device, dtype):
        super().__init__()
        F0 = cfg.feature_size
        self.patch_embed = PatchEmbed(cfg.in_channels, F0, PATCH, device,
                                      dtype)
        for i, (depth, heads) in enumerate(zip(cfg.depths, cfg.num_heads)):
            setattr(self, f"layers{i + 1}", nn.ModuleList([BasicLayer(
                F0 * 2 ** i, depth, heads, cfg.window_size, device,
                dtype)]))
        self.n_stages = len(cfg.depths)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """(B, in, H, W) -> the five hidden states as (B, H', W', C')
        tokens, each layer-normed over C' without an affine."""
        pe = self.patch_embed.proj
        t = F.conv2d(x, pe.weight, pe.bias, pe.stride).permute(
            0, 2, 3, 1).contiguous()
        states = [t]
        for i in range(self.n_stages):
            t = getattr(self, f"layers{i + 1}")[0](t)
            states.append(t)
        return [norm(s, None)[1] for s in states]


class ConvLayer(nn.Module):
    """MONAI's ``Convolution`` with ``conv_only``: its conv as ``.conv``."""

    def __init__(self, cin: int, cout: int, k: int, device, dtype,
                 transposed: bool = False, bias: bool = False):
        super().__init__()
        cls = nn.ConvTranspose2d if transposed else nn.Conv2d
        kw = dict(stride=2) if transposed else dict(padding=k // 2)
        self.conv = cls(cin, cout, k, bias=bias, device=device, dtype=dtype,
                        **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


def _cl(t: torch.Tensor) -> torch.Tensor:
    """``t`` in channel-last memory on a card (the norms' kernels read it
    so; the convs give it so, and then this copies nothing)."""
    return t.contiguous(memory_format=torch.channels_last) if t.is_cuda \
        else t


class ResBlock(nn.Module):
    """MONAI's ``UnetResBlock`` (kernel 3, stride 1, instance norm)."""

    def __init__(self, cin: int, cout: int, device, dtype):
        super().__init__()
        self.conv1 = ConvLayer(cin, cout, 3, device, dtype)
        self.conv2 = ConvLayer(cout, cout, 3, device, dtype)
        self.norm1 = InstanceNorm(cout, device=device, dtype=PARAM_DTYPE)
        self.norm2 = InstanceNorm(cout, device=device, dtype=PARAM_DTYPE)
        if cin != cout:
            self.conv3 = ConvLayer(cin, cout, 1, device, dtype)
            self.norm3 = InstanceNorm(cout, device=device, dtype=PARAM_DTYPE)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[1] == 1 and hasattr(self, "conv3"):
            # the 1-channel input: both of its convs in one pass
            y, res = stem_convs(x, self.conv1.conv.weight,
                                self.conv3.conv.weight)
        else:
            y = _cl(self.conv1(x))
            res = _cl(self.conv3(x)) if hasattr(self, "conv3") else None
        out = _cl(self.conv2(instance_norm_act(y, self.norm1, SLOPE)))
        if res is None:
            return instance_norm_act(out, self.norm2, SLOPE, _cl(x))
        return instance_norm_act(out, self.norm2, SLOPE, res, self.norm3)


class BasicBlock(nn.Module):
    """MONAI's ``UnetrBasicBlock`` with ``res_block=True``: ``.layer``."""

    def __init__(self, cin: int, cout: int, device, dtype):
        super().__init__()
        self.layer = ResBlock(cin, cout, device, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layer(x)


class UpBlock(nn.Module):
    """MONAI's ``UnetrUpBlock``: transposed conv k2 s2, concat with the
    skip, ``UnetResBlock(2 * out -> out)``."""

    def __init__(self, cin: int, cout: int, device, dtype):
        super().__init__()
        self.transp_conv = ConvLayer(cin, cout, 2, device, dtype,
                                     transposed=True)
        self.conv_block = ResBlock(2 * cout, cout, device, dtype)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        return self.conv_block(torch.cat([self.transp_conv(x), skip], 1))


class OutBlock(nn.Module):
    def __init__(self, cin: int, cout: int, device, dtype):
        super().__init__()
        self.conv = ConvLayer(cin, cout, 1, device, dtype, bias=True)


class SwinUNETR(nn.Module):
    """Input (B, in_channels, H, W) with H, W multiples of 32 -> logits
    (B, num_classes, H, W) f32 (the labeled path checks its tile with
    :func:`check_tile` when it takes the model)."""

    def __init__(self, cfg: SwinUNETRConfig = SwinUNETRConfig(), device=None):
        super().__init__()
        if len(cfg.depths) != 4 or len(cfg.num_heads) != 4:
            raise ValueError("SwinUNETR has four stages: depths and "
                             "num_heads take four entries")
        self.cfg = cfg
        self.dtype = _DTYPES[cfg.compute_dtype]
        kw = dict(device=device, dtype=self.dtype)
        F0 = cfg.feature_size
        self.swinViT = SwinTransformer(cfg, **kw)
        self.encoder1 = BasicBlock(cfg.in_channels, F0, **kw)
        self.encoder2 = BasicBlock(F0, F0, **kw)
        self.encoder3 = BasicBlock(2 * F0, 2 * F0, **kw)
        self.encoder4 = BasicBlock(4 * F0, 4 * F0, **kw)
        self.encoder10 = BasicBlock(16 * F0, 16 * F0, **kw)
        self.decoder5 = UpBlock(16 * F0, 8 * F0, **kw)
        self.decoder4 = UpBlock(8 * F0, 4 * F0, **kw)
        self.decoder3 = UpBlock(4 * F0, 2 * F0, **kw)
        self.decoder2 = UpBlock(2 * F0, F0, **kw)
        self.decoder1 = UpBlock(F0, F0, **kw)
        self.out = OutBlock(F0, cfg.num_classes, device, self.dtype)

    @classmethod
    def from_config(cls, cfg: SwinUNETRConfig, device=None,
                    seed: int = 0) -> "SwinUNETR":
        """The model on ``device`` with :func:`init_weights` of ``seed``."""
        return init_weights(cls(cfg, device=device), seed).eval()

    @torch.no_grad()
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        check_tile(x.shape[-2:])
        x = x.to(self.dtype)
        if x.is_cuda:
            x = x.contiguous(memory_format=torch.channels_last)
        with span("swin_encoder"):
            # (B, h, w, C) tokens are the channel-last memory of (B, C, h, w)
            hs = [s.permute(0, 3, 1, 2) for s in self.swinViT(x)]
        with span("swin_decoder"):
            enc0 = self.encoder1(x)
            enc1 = self.encoder2(hs[0])
            enc2 = self.encoder3(hs[1])
            enc3 = self.encoder4(hs[2])
            dec = self.encoder10(hs[4])
            dec = self.decoder5(dec, hs[3])
            dec = self.decoder4(dec, enc3)
            dec = self.decoder3(dec, enc2)
            dec = self.decoder2(dec, enc1)
            dec = self.decoder1(dec, enc0)
            return self.out.conv(dec).float()


def init_weights(model: SwinUNETR, seed: int) -> SwinUNETR:
    """Seeded initialisation from a CPU generator, so that every device gets
    the same numbers: conv, transposed-conv and linear weights LeCun-normal
    (truncated at two standard deviations, variance 1 / fan-in), biases 0,
    the relative-position tables N(0, 1), LayerNorm and InstanceNorm scale
    1 and bias 0.  Not MONAI's initialisation (truncated normal of std 0.02
    for the linears and the tables): with it the attention logits are near
    0 and the softmax near uniform, which would not exercise the bias."""
    gen = torch.Generator().manual_seed(int(seed))
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                w = mod.weight
                fan_in = (w.shape[0] if isinstance(mod, nn.ConvTranspose2d)
                          else w.shape[1]) * math.prod(w.shape[2:])
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                t = torch.empty(w.shape, dtype=torch.float32)
                nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                      generator=gen)
                w.copy_(t)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, WindowAttention):
                t = mod.relative_position_bias_table
                t.copy_(torch.randn(t.shape, generator=gen))
            elif isinstance(mod, (nn.LayerNorm, InstanceNorm)):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
    return model
