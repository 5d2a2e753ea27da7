"""Swin UNETR 2-D in plain PyTorch, f32, for the benchmark's reference:
MONAI's ``monai.networks.nets.SwinUNETR`` with ``spatial_dims=2``,
``normalize=True``, ``downsample="merging"``, ``use_v2=False`` (Hatamizadeh
et al., arXiv:2201.01266), written out op by op as MONAI computes it:

- ``patch_embed``: Conv2d(in, F, 2, stride 2) with bias, no norm;
- per stage (width C = F * 2**i, ``heads[i]`` heads of 16 channels at
  F = 48): blocks ``x = x + attn(norm1(x)); x = x + mlp(norm2(x))``.  The
  attention zero-pads the normed map right and bottom to whole 7x7
  windows, rolls it by (-3, -3) in odd blocks, partitions it into windows,
  ``q = q * d**-0.5``, ``attn = q @ k^T + table[index[:n, :n]]`` (+ the
  -100 region mask of the padded map in odd blocks), softmax, ``@ v``,
  the projection, the windows reversed, the roll undone, the padding
  cropped.  A side not longer than the window takes it as its window with
  no shift (``get_window_size``).  Patch merging ``cat(x[0::2, 0::2],
  x[1::2, 0::2], x[0::2, 1::2], x[1::2, 1::2])`` -> LayerNorm(4C) ->
  Linear(4C, 2C, no bias) ends every stage;
- the five hidden states, each ``F.layer_norm`` over its channels;
- ``UnetResBlock`` (conv3x3 -> IN -> LeakyReLU(0.01) -> conv3x3 -> IN, the
  residual through conv1x1 -> IN where the channels change, add,
  LeakyReLU; convs without bias) as encoders 1-4 and 10, ``UnetrUpBlock``
  (ConvTranspose2d(k2, s2, no bias), cat with the skip, UnetResBlock) as
  decoders 5-1, and the 1x1 head with bias.

Departure from MONAI: the InstanceNorms are affine (``nn.InstanceNorm2d(
affine=True)``); MONAI's ``norm_name="instance"`` builds them without an
affine, which computes the same at scale 1 and bias 0.  Parameter names are
MONAI's, so one state dict fills this model and the program's.  No batching
trick: every tile goes through the ops above as given.

``quant="fp8"`` rounds the input and the weight of every conv, transposed
conv and linear to float8 e4m3 under a per-tensor scale (the benchmark's
lower-precision control); the rest stays f32.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .ops import fake_fp8


def window_and_shift(hw, window, shift):
    ws = [n if n <= window else window for n in hw]
    ss = [0 if n <= window else shift for n in hw]
    return ws, ss


def window_partition(x, ws):
    b, h, w, c = x.shape
    x = x.view(b, h // ws[0], ws[0], w // ws[1], ws[1], c)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(-1, ws[0] * ws[1], c)


def window_reverse(windows, ws, b, h, w):
    x = windows.view(b, h // ws[0], w // ws[1], ws[0], ws[1], -1)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(b, h, w, -1)


def compute_mask(hp, wp, ws, ss, device):
    img = torch.zeros((1, hp, wp, 1), device=device)
    cnt = 0
    for h in (slice(-ws[0]), slice(-ws[0], -ss[0]), slice(-ss[0], None)):
        for w in (slice(-ws[1]), slice(-ws[1], -ss[1]), slice(-ss[1], None)):
            img[:, h, w, :] = cnt
            cnt += 1
    win = window_partition(img, ws).squeeze(-1)
    mask = win.unsqueeze(1) - win.unsqueeze(2)
    return mask.masked_fill(mask != 0, -100.0).masked_fill(mask == 0, 0.0)


def relative_position_index(window):
    coords = torch.stack(torch.meshgrid(torch.arange(window),
                                        torch.arange(window), indexing="ij"))
    flat = torch.flatten(coords, 1)
    rel = (flat[:, :, None] - flat[:, None, :]).permute(1, 2, 0).contiguous()
    rel[:, :, 0] += window - 1
    rel[:, :, 1] += window - 1
    rel[:, :, 0] *= 2 * window - 1
    return rel.sum(-1)


class WindowAttention(nn.Module):
    def __init__(self, dim, heads, window, qkv_bias=True):
        super().__init__()
        self.heads = heads
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, heads))
        self.register_buffer("relative_position_index",
                             relative_position_index(window))
        self.qkv = nn.Linear(dim, dim * 3, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)


class Mlp(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.linear1 = nn.Linear(dim, hidden)
        self.linear2 = nn.Linear(hidden, dim)


class SwinBlock(nn.Module):
    def __init__(self, dim, heads, window, shift, mlp_ratio=4.0):
        super().__init__()
        self.window, self.shift = window, shift
        self.norm1 = nn.LayerNorm(dim)
        self.attn = WindowAttention(dim, heads, window)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))


class PatchMerging(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)


class BasicLayer(nn.Module):
    def __init__(self, dim, depth, heads, window):
        super().__init__()
        self.blocks = nn.ModuleList([
            SwinBlock(dim, heads, window, 0 if j % 2 == 0 else window // 2)
            for j in range(depth)])
        self.downsample = PatchMerging(dim)


class PatchEmbed(nn.Module):
    def __init__(self, cin, dim, patch):
        super().__init__()
        self.proj = nn.Conv2d(cin, dim, patch, stride=patch)


class SwinTransformer(nn.Module):
    def __init__(self, cin, F0, depths, heads, window, patch):
        super().__init__()
        self.patch_embed = PatchEmbed(cin, F0, patch)
        for i, (d, h) in enumerate(zip(depths, heads)):
            setattr(self, f"layers{i + 1}", nn.ModuleList(
                [BasicLayer(F0 * 2 ** i, d, h, window)]))


class _Conv(nn.Module):
    def __init__(self, cin, cout, k, transposed=False, bias=False):
        super().__init__()
        self.conv = (nn.ConvTranspose2d(cin, cout, k, stride=2, bias=bias)
                     if transposed else
                     nn.Conv2d(cin, cout, k, padding=k // 2, bias=bias))


class ResBlock(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv1 = _Conv(cin, cout, 3)
        self.conv2 = _Conv(cout, cout, 3)
        self.norm1 = nn.InstanceNorm2d(cout, affine=True)
        self.norm2 = nn.InstanceNorm2d(cout, affine=True)
        if cin != cout:
            self.conv3 = _Conv(cin, cout, 1)
            self.norm3 = nn.InstanceNorm2d(cout, affine=True)


class BasicBlock(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.layer = ResBlock(cin, cout)


class UpBlock(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.transp_conv = _Conv(cin, cout, 2, transposed=True)
        self.conv_block = ResBlock(2 * cout, cout)


class OutBlock(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv = _Conv(cin, cout, 1, bias=True)


class SwinUNETR(nn.Module):
    """(B, in_channels, H, W) with H, W multiples of 32 -> (B, classes, H, W)
    logits."""

    def __init__(self, in_channels: int = 1, num_classes: int = 3,
                 feature_size: int = 48,
                 depths: Sequence[int] = (2, 2, 2, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24),
                 window_size: int = 7, patch: int = 2,
                 quant: Optional[str] = None):
        super().__init__()
        self.quant = quant
        F0 = feature_size
        self.swinViT = SwinTransformer(in_channels, F0, depths, num_heads,
                                       window_size, patch)
        self.encoder1 = BasicBlock(in_channels, F0)
        self.encoder2 = BasicBlock(F0, F0)
        self.encoder3 = BasicBlock(2 * F0, 2 * F0)
        self.encoder4 = BasicBlock(4 * F0, 4 * F0)
        self.encoder10 = BasicBlock(16 * F0, 16 * F0)
        self.decoder5 = UpBlock(16 * F0, 8 * F0)
        self.decoder4 = UpBlock(8 * F0, 4 * F0)
        self.decoder3 = UpBlock(4 * F0, 2 * F0)
        self.decoder2 = UpBlock(2 * F0, F0)
        self.decoder1 = UpBlock(F0, F0)
        self.out = OutBlock(F0, num_classes)

    # ------------------------------------------------------ the ops

    def _q(self, t):
        return fake_fp8(t) if self.quant == "fp8" else t

    def _linear(self, lin: nn.Linear, x):
        return F.linear(self._q(x), self._q(lin.weight), lin.bias)

    def _conv(self, c: _Conv, x):
        m = c.conv
        if isinstance(m, nn.ConvTranspose2d):
            return F.conv_transpose2d(self._q(x), self._q(m.weight), m.bias,
                                      stride=2)
        return F.conv2d(self._q(x), self._q(m.weight), m.bias,
                        padding=m.padding)

    def _attention(self, a: WindowAttention, x, mask):
        b, n, c = x.shape
        qkv = self._linear(a.qkv, x).reshape(b, n, 3, a.heads, c // a.heads) \
            .permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        q = q * (c // a.heads) ** -0.5
        attn = q @ k.transpose(-2, -1)
        bias = a.relative_position_bias_table[
            a.relative_position_index.clone()[:n, :n].reshape(-1)] \
            .reshape(n, n, -1).permute(2, 0, 1).contiguous()
        attn = attn + bias.unsqueeze(0)
        if mask is not None:
            nw = mask.shape[0]
            attn = attn.view(b // nw, nw, a.heads, n, n) \
                + mask.to(attn.dtype).unsqueeze(1).unsqueeze(0)
            attn = attn.view(-1, a.heads, n, n)
        attn = torch.softmax(attn, dim=-1)
        x = (attn @ v).transpose(1, 2).reshape(b, n, c)
        return self._linear(a.proj, x)

    def _block(self, blk: SwinBlock, x):
        shortcut = x
        x = blk.norm1(x)
        b, h, w, c = x.shape
        ws, ss = window_and_shift((h, w), blk.window, blk.shift)
        pad_b = (ws[0] - h % ws[0]) % ws[0]
        pad_r = (ws[1] - w % ws[1]) % ws[1]
        x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
        _, hp, wp, _ = x.shape
        if any(i > 0 for i in ss):
            x = torch.roll(x, shifts=(-ss[0], -ss[1]), dims=(1, 2))
            mask = compute_mask(hp, wp, ws, ss, x.device)
        else:
            mask = None
        win = self._attention(blk.attn, window_partition(x, ws), mask)
        x = window_reverse(win.view(-1, ws[0] * ws[1], c), ws, b, hp, wp)
        if any(i > 0 for i in ss):
            x = torch.roll(x, shifts=(ss[0], ss[1]), dims=(1, 2))
        if pad_r > 0 or pad_b > 0:
            x = x[:, :h, :w, :].contiguous()
        x = shortcut + x
        y = self._linear(blk.mlp.linear1, blk.norm2(x))
        return x + self._linear(blk.mlp.linear2, F.gelu(y))

    def _merge(self, m: PatchMerging, x):
        _, h, w, _ = x.shape
        if h % 2 == 1 or w % 2 == 1:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                       x[:, 1::2, 1::2]], -1)
        return self._linear(m.reduction, m.norm(x))

    def _res(self, r: ResBlock, x):
        out = F.leaky_relu(r.norm1(self._conv(r.conv1, x)), 0.01)
        out = r.norm2(self._conv(r.conv2, out))
        res = r.norm3(self._conv(r.conv3, x)) if hasattr(r, "conv3") else x
        return F.leaky_relu(out + res, 0.01)

    def _up(self, u: UpBlock, x, skip):
        return self._res(u.conv_block,
                         torch.cat([self._conv(u.transp_conv, x), skip], 1))

    def hidden_states(self, x):
        """The five hidden states (B, C, H, W), layer-normed over C."""
        vit = self.swinViT
        pe = vit.patch_embed.proj
        t = F.conv2d(self._q(x), self._q(pe.weight), pe.bias,
                     stride=pe.stride).permute(0, 2, 3, 1)
        states = [t]
        for i in range(4):
            layer = getattr(vit, f"layers{i + 1}")[0]
            for blk in layer.blocks:
                t = self._block(blk, t)
            t = self._merge(layer.downsample, t)
            states.append(t)
        return [F.layer_norm(s, s.shape[-1:]).permute(0, 3, 1, 2)
                for s in states]

    @torch.no_grad()
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        hs = self.hidden_states(x)
        enc0 = self._res(self.encoder1.layer, x)
        enc1 = self._res(self.encoder2.layer, hs[0])
        enc2 = self._res(self.encoder3.layer, hs[1])
        enc3 = self._res(self.encoder4.layer, hs[2])
        dec4 = self._res(self.encoder10.layer, hs[4])
        dec3 = self._up(self.decoder5, dec4, hs[3])
        dec2 = self._up(self.decoder4, dec3, enc3)
        dec1 = self._up(self.decoder3, dec2, enc2)
        dec0 = self._up(self.decoder2, dec1, enc1)
        out = self._up(self.decoder1, dec0, enc0)
        return self._conv(self.out.conv, out)
