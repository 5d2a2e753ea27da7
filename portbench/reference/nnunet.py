"""The nnU-Net v2 ``2d`` baseline in plain PyTorch, f32, for the benchmark's
reference: the PlainConvUNet of a plan (3x3 conv with bias -> InstanceNorm2d
(affine, eps 1e-5) -> LeakyReLU(0.01) per conv, stride-2 convs from stage 1
on, 2x2 stride-2 transposed convs, the full-resolution 1x1 head), nnU-Net's
sliding-window predictor (half-overlapping tiles, Gaussian importance map
with sigma 1/8 of the tile, the four mirror views averaged, softmax), and the
container's postprocess: probabilities under 0.5 cleared, the argmax class,
the largest 6-connected 3-D component of classes 1 and 2 (SciPy), and the
reference's class-1-then-class-2 frame ladder.

Parameter names are nnU-Net's, so one state dict fills this model and the
program's.  ``quant="fp8"`` fake-quantizes the input and the weight of every
conv to float8 e4m3 with a per-tensor scale (the benchmark's lower-precision
control); the rest stays f32.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from scipy import ndimage as ndi
from torch import nn

from .ops import fake_fp8


class _Conv(nn.Module):
    def __init__(self, cin, cout, stride):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 3, stride=stride, padding=1)
        self.norm = nn.InstanceNorm2d(cout, eps=1e-5, affine=True)


class _Stack(nn.Module):
    def __init__(self, cin, cout, n, stride):
        super().__init__()
        self.convs = nn.ModuleList([_Conv(cin if c == 0 else cout, cout,
                                          stride if c == 0 else 1)
                                    for c in range(n)])


class PlainConvUNet(nn.Module):
    def __init__(self, feats: List[int], n_conv: int, num_classes: int,
                 in_channels: int = 1, quant: Optional[str] = None):
        super().__init__()
        self.quant = quant
        n = len(feats)
        self.encoder = nn.Module()
        self.encoder.stages = nn.ModuleList()
        cin = in_channels
        for s in range(n):
            self.encoder.stages.append(nn.Sequential(
                _Stack(cin, feats[s], n_conv, 2 if s else 1)))
            cin = feats[s]
        self.decoder = nn.Module()
        self.decoder.transpconvs = nn.ModuleList()
        self.decoder.stages = nn.ModuleList()
        for i in range(n - 1):
            s = n - 2 - i
            self.decoder.transpconvs.append(
                nn.ConvTranspose2d(feats[s + 1], feats[s], 2, stride=2))
            self.decoder.stages.append(_Stack(2 * feats[s], feats[s], n_conv,
                                              1))
        self.decoder.seg_layers = nn.ModuleDict(
            {str(n - 2): nn.Conv2d(feats[0], num_classes, 1)})

    @property
    def head(self) -> nn.Conv2d:
        return self.decoder.seg_layers[str(len(self.encoder.stages) - 2)]

    def _q(self, t):
        return fake_fp8(t) if self.quant == "fp8" else t

    def _stack(self, st: _Stack, x):
        for c in st.convs:
            x = F.conv2d(self._q(x), self._q(c.conv.weight), c.conv.bias,
                         c.conv.stride, 1)
            x = F.leaky_relu(c.norm(x), 0.01)
        return x

    @torch.no_grad()
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skips = []
        for stage in self.encoder.stages:
            x = self._stack(stage[0], x)
            skips.append(x)
        skips.pop()
        for up, st in zip(self.decoder.transpconvs, self.decoder.stages):
            u = F.conv_transpose2d(self._q(x), self._q(up.weight), up.bias,
                                   stride=2)
            x = self._stack(st, torch.cat([u, skips.pop()], dim=1))
        return F.conv2d(self._q(x), self._q(self.head.weight), self.head.bias)


def tile_starts(image: int, tile: int, step: float) -> List[int]:
    """nnU-Net's rule: ceil((image - tile) / (tile * step)) + 1 evenly
    spaced starts over [0, image - tile], rounded half to even."""
    if image <= tile:
        return [0]
    num = int(math.ceil((image - tile) / (tile * step))) + 1
    actual = (image - tile) / (num - 1)
    return [int(round(i * actual)) for i in range(num)]


def gaussian_map(th: int, tw: int, sigma_scale: float = 1.0 / 8
                 ) -> np.ndarray:
    ys = (np.arange(th) - (th - 1) / 2.0) / (th * sigma_scale)
    xs = (np.arange(tw) - (tw - 1) / 2.0) / (tw * sigma_scale)
    g = np.exp(-0.5 * ys[:, None] ** 2) * np.exp(-0.5 * xs[None, :] ** 2)
    g = (g / g.max()).astype(np.float32)
    return np.maximum(g, g[g > 0].min())


@torch.no_grad()
def sliding_window(model: nn.Module, frames: torch.Tensor,
                   tile: Tuple[int, int], step: float = 0.5,
                   frames_per_batch: int = 4) -> torch.Tensor:
    """(N, H, W) frames in [0, 1] -> (N, C, H, W) softmax probabilities.
    Each forward runs the four mirror views of one tile of
    ``frames_per_batch`` frames."""
    N, H, W = frames.shape
    th, tw = tile
    ph, pw = max(0, th - H), max(0, tw - W)
    top, left = ph // 2, pw // 2
    x = F.pad(frames.float(), (left, pw - left, top, ph - top))
    Hp, Wp = x.shape[-2:]
    starts = [(y0, x0) for y0 in tile_starts(Hp, th, step)
              for x0 in tile_starts(Wp, tw, step)]
    g = torch.from_numpy(gaussian_map(th, tw)).to(frames.device)
    den = torch.zeros((Hp, Wp), device=frames.device)
    for y0, x0 in starts:
        den[y0:y0 + th, x0:x0 + tw] += g
    views = ((), (-1,), (-2,), (-2, -1))
    out = []
    for a in range(0, N, frames_per_batch):
        xb = x[a:a + frames_per_batch]
        B = xb.shape[0]
        acc = None
        for y0, x0 in starts:
            p = xb[:, None, y0:y0 + th, x0:x0 + tw]
            y = model(torch.cat([torch.flip(p, v) if v else p
                                 for v in views]))
            logits = sum(torch.flip(y[k * B:(k + 1) * B], v) if v
                         else y[:B] for k, v in enumerate(views))
            logits = logits / 4.0 * g
            if acc is None:
                acc = torch.zeros((B, logits.shape[1], Hp, Wp),
                                  device=frames.device)
            acc[:, :, y0:y0 + th, x0:x0 + tw] += logits
        prob = torch.softmax(acc / den, dim=1)
        out.append(prob[:, :, top:top + H, left:left + W])
    return torch.cat(out)


def labels_3d(softmax: torch.Tensor, threshold: float = 0.5) -> np.ndarray:
    """(N, C, H, W) probabilities -> (N, H, W) uint8 labels: values under
    ``threshold`` cleared, the first largest class, then for classes 1 and 2
    only their largest 6-connected component over the volume."""
    sm = torch.where(softmax < threshold, torch.zeros_like(softmax), softmax)
    seg = torch.argmax(sm, dim=1).to(torch.uint8).cpu().numpy()
    out = np.zeros_like(seg)
    structure = ndi.generate_binary_structure(3, 1)
    for lab in (1, 2):
        lbl, n = ndi.label(seg == lab, structure=structure)
        if n == 0:
            continue
        sizes = np.bincount(lbl.ravel())
        sizes[0] = 0
        out[lbl == int(sizes.argmax())] = lab
    return out


def frame_ladder(labels: np.ndarray) -> Tuple[int, np.ndarray]:
    """The reference's frame pick: per frame the class-1 area is tried first
    and wins if it beats the running best, class 2 only otherwise; -1 when
    every frame is empty.  Returns (frame, per-frame max(a1, a2))."""
    a1 = (labels == 1).reshape(labels.shape[0], -1).sum(1)
    a2 = (labels == 2).reshape(labels.shape[0], -1).sum(1)
    largest, frame = 0, -1
    for f in range(labels.shape[0]):
        if a1[f] > largest:
            largest, frame = int(a1[f]), f
        elif a2[f] > largest:
            largest, frame = int(a2[f]), f
    return frame, np.maximum(a1, a2)
