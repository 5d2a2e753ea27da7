"""The Attention-ASPP-UNet (v1 gates, ASPP bridge) in plain PyTorch, f32,
for the benchmark's reference.

The modules are a frozen copy of the repository's PyTorch oracle of the
published architecture (``tests/torch_ref.py``: the reference pipeline's
``attention_aspp_unet_pipeline_stage.py`` model, with its state-dict keys),
evaluated with BatchNorm's running statistics.  :func:`load_npz` fills it
from a flat-npz weight archive in the JAX layout (``params/<module>/...``,
``batch_stats/...``; kernels HWIO, transposed-conv kernels as flax applies
them), the same raw file the program reads.  ``quant="fp8"`` rounds the
input and the weight of every conv and transposed conv to float8 e4m3 under
a per-tensor scale (the benchmark's lower-precision control); BatchNorm,
the gates' products, the pooling and the resizes stay f32.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from .ops import fake_fp8


class ConvBNReLU(nn.Module):
    def __init__(self, cin, cout, k=3):
        super().__init__()
        self.block = nn.Sequential(
            nn.Conv2d(cin, cout, k, padding=k // 2, bias=False),
            nn.BatchNorm2d(cout),
            nn.ReLU(inplace=True),
        )

    def forward(self, x):
        return self.block(x)


class ASPP(nn.Module):
    def __init__(self, cin, cout, rates=(6, 12, 18)):
        super().__init__()
        branches = [nn.Sequential(nn.Conv2d(cin, cout, 1, bias=False),
                                  nn.BatchNorm2d(cout), nn.ReLU(inplace=True))]
        for r in rates:
            branches.append(nn.Sequential(
                nn.Conv2d(cin, cout, 3, padding=r, dilation=r, bias=False),
                nn.BatchNorm2d(cout), nn.ReLU(inplace=True)))
        self.blocks = nn.ModuleList(branches)
        self.pool = nn.Sequential(nn.AdaptiveAvgPool2d(1),
                                  nn.Conv2d(cin, cout, 1, bias=False),
                                  nn.BatchNorm2d(cout), nn.ReLU(inplace=True))
        self.project = nn.Sequential(nn.Conv2d(cout * 5, cout, 1, bias=False),
                                     nn.BatchNorm2d(cout), nn.ReLU(inplace=True),
                                     nn.Dropout(0.1))

    def forward(self, x):
        h, w = x.shape[2:]
        outs = [b(x) for b in self.blocks]
        pooled = F.interpolate(self.pool(x), (h, w), mode="bilinear",
                               align_corners=False)
        outs.append(pooled)
        return self.project(torch.cat(outs, dim=1))


class AttentionGateV1(nn.Module):
    def __init__(self, fg, fl, fint):
        super().__init__()
        self.Wg = nn.Sequential(nn.Conv2d(fg, fint, 1, bias=False),
                                nn.BatchNorm2d(fint))
        self.Wx = nn.Sequential(nn.Conv2d(fl, fint, 1, bias=False),
                                nn.BatchNorm2d(fint))
        self.psi = nn.Sequential(nn.Conv2d(fint, 1, 1, bias=False),
                                 nn.BatchNorm2d(1), nn.Sigmoid())
        self.relu = nn.ReLU(inplace=True)

    def forward(self, g, x):
        return x * self.psi(self.relu(self.Wg(g) + self.Wx(x)))


class UpBlockV1(nn.Module):
    def __init__(self, cin, cout, use_att=True):
        super().__init__()
        self.up = nn.ConvTranspose2d(cin, cout, 2, 2)
        self.att = AttentionGateV1(cout, cout, cout // 2) if use_att else None
        self.conv = nn.Sequential(ConvBNReLU(cin, cout), ConvBNReLU(cout, cout))

    def forward(self, g, x):
        g = self.up(g)
        if g.shape[-2:] != x.shape[-2:]:
            g = F.interpolate(g, size=x.shape[-2:], mode="bilinear",
                              align_corners=False)
        if self.att is not None:
            x = self.att(g, x)
        return self.conv(torch.cat([x, g], dim=1))


class AttentionASPPUNetV1(nn.Module):
    """v1 wiring: gates on u4/u3/u2, u1 plain, ASPP bridge."""

    def __init__(self, in_channels=1, num_classes=1, base_c=8):
        super().__init__()
        c = base_c
        self.d1 = nn.Sequential(ConvBNReLU(in_channels, c), ConvBNReLU(c, c))
        self.p1 = nn.MaxPool2d(2)
        self.d2 = nn.Sequential(ConvBNReLU(c, c * 2), ConvBNReLU(c * 2, c * 2))
        self.p2 = nn.MaxPool2d(2)
        self.d3 = nn.Sequential(ConvBNReLU(c * 2, c * 4), ConvBNReLU(c * 4, c * 4))
        self.p3 = nn.MaxPool2d(2)
        self.d4 = nn.Sequential(ConvBNReLU(c * 4, c * 8), ConvBNReLU(c * 8, c * 8))
        self.p4 = nn.MaxPool2d(2)
        self.bridge = ASPP(c * 8, c * 16)
        self.u4 = UpBlockV1(c * 16, c * 8)
        self.u3 = UpBlockV1(c * 8, c * 4)
        self.u2 = UpBlockV1(c * 4, c * 2)
        self.u1 = UpBlockV1(c * 2, c, use_att=False)
        self.out_conv = nn.Conv2d(c, num_classes, 1)

    def forward(self, x):
        x1 = self.d1(x)
        x2 = self.d2(self.p1(x1))
        x3 = self.d3(self.p2(x2))
        x4 = self.d4(self.p3(x3))
        b = self.bridge(self.p4(x4))
        d = self.u4(b, x4)
        d = self.u3(d, x3)
        d = self.u2(d, x2)
        d = self.u1(d, x1)
        return self.out_conv(d)


def _rules(c_levels=(1, 2, 3, 4), rates=3):
    """(torch prefix, flax path, kind) of every module of the v1 model."""
    rules = []

    def cbr(tp, fp):
        rules.append((f"{tp}.block.0", f"{fp}/conv", "conv"))
        rules.append((f"{tp}.block.1", f"{fp}/bn", "bn"))

    for i in c_levels:
        cbr(f"d{i}.0", f"d{i}_0")
        cbr(f"d{i}.1", f"d{i}_1")
    for b in range(rates + 1):
        rules.append((f"bridge.blocks.{b}.0", f"bridge/branch{b}_conv", "conv"))
        rules.append((f"bridge.blocks.{b}.1", f"bridge/branch{b}_bn", "bn"))
    rules += [("bridge.pool.1", "bridge/pool_conv", "conv"),
              ("bridge.pool.2", "bridge/pool_bn", "bn"),
              ("bridge.project.0", "bridge/project_conv", "conv"),
              ("bridge.project.1", "bridge/project_bn", "bn")]
    for lvl in (4, 3, 2, 1):
        rules.append((f"u{lvl}.up", f"u{lvl}/up", "convT"))
        if lvl >= 2:
            for name in ("Wg", "Wx", "psi"):
                rules.append((f"u{lvl}.att.{name}.0",
                              f"u{lvl}/att/{name}_conv", "conv"))
                rules.append((f"u{lvl}.att.{name}.1",
                              f"u{lvl}/att/{name}_bn", "bn"))
        cbr(f"u{lvl}.conv.0", f"u{lvl}/conv0")
        cbr(f"u{lvl}.conv.1", f"u{lvl}/conv1")
    rules.append(("out_conv", "out_conv", "conv"))
    return rules


def load_npz(path, base_c: int, device, quant: Optional[str] = None
             ) -> AttentionASPPUNetV1:
    """The f32 model on ``device`` from a flat-npz archive in the JAX
    layout; with ``quant="fp8"`` its convs in float8 (:func:`quantize_fp8`)."""
    with np.load(Path(path)) as z:
        flat = {k: z[k].astype(np.float32) for k in z.files}
    sd = {}
    for tp, fp, kind in _rules():
        p = f"params/{fp}"
        if kind == "bn":
            sd[f"{tp}.weight"] = flat[f"{p}/scale"]
            sd[f"{tp}.bias"] = flat[f"{p}/bias"]
            sd[f"{tp}.running_mean"] = flat[f"batch_stats/{fp}/mean"]
            sd[f"{tp}.running_var"] = flat[f"batch_stats/{fp}/var"]
            continue
        k = flat[f"{p}/kernel"]
        # flax applies a transposed conv's kernel flipped: PyTorch's
        # (in, out, kh, kw) holds it the other way round
        sd[f"{tp}.weight"] = (k[::-1, ::-1].transpose(2, 3, 0, 1)
                              if kind == "convT" else k.transpose(3, 2, 0, 1))
        if f"{p}/bias" in flat:
            sd[f"{tp}.bias"] = flat[f"{p}/bias"]
    model = AttentionASPPUNetV1(1, 1, base_c=base_c)
    state = {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in sd.items()}
    missing, unexpected = model.load_state_dict(state, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise ValueError(f"reference weights: missing {missing}, "
                         f"unexpected {unexpected}")
    model = model.to(device).eval()
    if quant == "fp8":
        quantize_fp8(model)
    elif quant is not None:
        raise ValueError(f"unknown quant {quant!r}")
    return model


def quantize_fp8(model: nn.Module) -> None:
    """Rounds every conv's and transposed conv's weight to float8 e4m3 in
    place, and its input on each call."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            m.weight.data = fake_fp8(m.weight.data)
            m.register_forward_pre_hook(
                lambda _, args: (fake_fp8(args[0]),) + tuple(args[1:]))


@torch.no_grad()
def probs(model: nn.Module, x: torch.Tensor, tta: bool, batch: int = 8
          ) -> torch.Tensor:
    """(N, S, S) frames in [0, 1] -> (N, S, S) sigmoid probabilities; with
    ``tta`` the logits are averaged over the frame and its horizontal flip."""
    out = []
    for i in range(0, x.shape[0], batch):
        xb = x[i:i + batch, None].float()
        logits = model(xb)
        if tta:
            logits = (logits + torch.flip(model(torch.flip(xb, (-1,))),
                                          (-1,))) / 2.0
        out.append(torch.sigmoid(logits)[:, 0])
    return torch.cat(out)
