"""Synthetic fetal-ultrasound sweeps made on the device from a seed.

The distributions of ``tools/synthetic.make_sweep`` / ``make_frame`` of the
port (speckle with a coarse gain field and depth falloff, one or two partial
distractor arcs, the abdomen rim with its quality ramp, rim gaps, the darker
interior with its echo blob, the transducer fan, additive noise), drawn with
a ``torch.Generator`` on the device and computed for a block of frames at a
time.  The numbers differ from the host generator's (another random stream);
the distributions are the same.  One quality ramp per sweep: the rim is
clearest at a peak frame drawn in [0.3 n, 0.7 n) and fades with the distance
from it; frames whose quality falls under 0.25 hold no abdomen.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

BLOCK = 24          # frames computed at once


def sub_seed(seed: int, k: int) -> int:
    """The seed of sweep ``k`` of a run: distinct for each (seed, k)."""
    return (int(seed) * 1_000_003 + 7919 * (k + 1)) % (2 ** 62)


def _uniform(gen, n, lo, hi, dev):
    return lo + (hi - lo) * torch.rand(n, generator=gen, device=dev,
                                       dtype=torch.float64)


def _ellipse_field(yy, xx, cy, cx, ry, rx, ang):
    """Normalised elliptical distance, 1.0 on the rim; parameters (F,)."""
    c = torch.cos(ang)[:, None, None]
    s = torch.sin(ang)[:, None, None]
    dy = yy[None] - cy[:, None, None]
    dx = xx[None] - cx[:, None, None]
    u = (c * dy + s * dx) / ry[:, None, None]
    v = (-s * dy + c * dx) / rx[:, None, None]
    return torch.sqrt(u * u + v * v)


def _fan_mask(yy, xx, H: int, W: int) -> torch.Tensor:
    ay, ax = -0.25 * H, W / 2.0
    ang = torch.atan2(xx - ax, yy - ay)
    r = torch.hypot(yy - ay, xx - ax)
    return ((ang.abs() < 0.62) & (r > 0.22 * H) & (r < 1.45 * H)).float()


def make_sweep(n: int, H: int, W: int, seed: int, device
               ) -> Tuple[torch.Tensor, int]:
    """One sweep: ((n, H, W) uint8 on ``device``, its peak frame)."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    lo, hi = int(0.3 * n), int(0.7 * n)
    best = int(torch.randint(lo, max(hi, lo + 1), (1,), generator=gen,
                             device=dev).item())
    i = torch.arange(n, device=dev, dtype=torch.float64)
    q = torch.clamp(1.0 - (i - best).abs() / max(n * 0.25, 1), min=0.0)
    positive = q >= 0.25

    u = lambda a, b: _uniform(gen, n, a, b, dev)   # noqa: E731
    n_dist = torch.randint(1, 3, (n,), generator=gen, device=dev)
    dist = [dict(cy=u(0.15 * H, 0.85 * H), cx=u(0.2 * W, 0.8 * W),
                 ry=u(0.1, 0.3) * H, rx=u(0.15, 0.4) * W, ang=u(0, math.pi),
                 cut=u(0.3, 0.7) * H) for _ in range(2)]
    ry = u(0.14, 0.24) * H
    ring = dict(cy=u(0.38 * H, 0.62 * H), cx=u(0.38 * W, 0.62 * W), ry=ry,
                rx=ry * u(0.85, 1.35), ang=u(0, math.pi),
                rim_w=u(0.035, 0.06))
    n_gaps = torch.round((1.0 - q) * 3).long()
    gaps = [(u(-math.pi, math.pi), u(0.15, 0.5)) for _ in range(3)]

    yy, xx = torch.meshgrid(torch.arange(H, device=dev, dtype=torch.float32),
                            torch.arange(W, device=dev, dtype=torch.float32),
                            indexing="ij")
    fan = _fan_mask(yy, xx, H, W)
    depth = (1.0 - 0.45 * torch.arange(H, device=dev, dtype=torch.float32)
             / H)[:, None]
    ch, cw = H // 16 + 1, W // 16 + 1
    out = torch.empty((n, H, W), dtype=torch.uint8, device=dev)
    f32 = torch.float32
    for a in range(0, n, BLOCK):
        sl = slice(a, min(a + BLOCK, n))
        F_ = sl.stop - sl.start
        fine = 0.35 * torch.sqrt(-2.0 * torch.log1p(-torch.rand(
            (F_, H, W), generator=gen, device=dev)))
        coarse = torch.rand((F_, 1, ch, cw), generator=gen, device=dev)
        c = torch.nn.functional.interpolate(coarse, size=(H, W),
                                            mode="bilinear",
                                            align_corners=True)[:, 0]
        img = 22.0 + 95.0 * fine * (0.5 + 0.9 * c) * depth
        del fine, c
        for j, d in enumerate(dist):
            p = {k: v[sl].to(f32) for k, v in d.items()}
            field = _ellipse_field(yy, xx, p["cy"], p["cx"], p["ry"],
                                   p["rx"], p["ang"])
            arc = torch.exp(-((field - 1.0) ** 2) / (2 * 0.03 ** 2))
            arc = arc * (yy[None] < p["cut"][:, None, None])
            on = (n_dist[sl] > j).to(f32)[:, None, None]
            img = img + 60.0 * arc * on
        p = {k: v[sl].to(f32) for k, v in ring.items()}
        qs = q[sl].to(f32)[:, None, None]
        pos = positive[sl][:, None, None]
        field = _ellipse_field(yy, xx, p["cy"], p["cx"], p["ry"], p["rx"],
                               p["ang"])
        rim_w = p["rim_w"][:, None, None]
        rim = torch.exp(-((field - 1.0) ** 2) / (2 * rim_w ** 2))
        theta = torch.atan2(yy[None] - p["cy"][:, None, None],
                            xx[None] - p["cx"][:, None, None])
        for g, (g0, gw) in enumerate(gaps):
            g0s = g0[sl].to(f32)[:, None, None]
            gws = gw[sl].to(f32)[:, None, None]
            wrapped = torch.remainder(theta - g0s + math.pi,
                                      2 * math.pi) - math.pi
            cut = 1.0 - 0.9 * torch.exp(-(wrapped ** 2) / (2 * gws ** 2))
            on = (n_gaps[sl] > g)[:, None, None]
            rim = torch.where(on, rim * cut, rim)
        ring_img = img + (35.0 + 105.0 * qs) * rim
        interior = field < 1.0 - 2 * rim_w
        ring_img = torch.where(interior, ring_img * 0.55, ring_img)
        blob = _ellipse_field(yy, xx, p["cy"] + 0.3 * p["ry"], p["cx"],
                              0.18 * p["ry"], 0.18 * p["rx"],
                              torch.zeros_like(p["ry"]))
        ring_img = ring_img + 50.0 * qs * torch.exp(-(blob ** 2) / 2.0)
        img = torch.where(pos, ring_img, img)
        del field, rim, theta, ring_img, blob
        img = img * fan + 4.0 * torch.randn((F_, H, W), generator=gen,
                                            device=dev)
        out[sl] = torch.clamp(img, 0, 255).to(torch.uint8)
    return out, best

