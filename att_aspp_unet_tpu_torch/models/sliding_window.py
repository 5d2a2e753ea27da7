"""Sliding-window tiled inference with Gaussian weighting and mirror TTA.

Counterpart of ``att_aspp_unet_tpu/models/sliding_window.py`` (nnU-Net's
predictor with ``tile_step_size=0.5, use_gaussian=True,
use_mirroring=True``):

- frames smaller than the patch are zero-padded symmetrically, the odd row
  or column going to the bottom or right;
- tile starts follow nnU-Net's step rule (:func:`compute_tile_starts`), tiles
  ordered row-major within a frame and frame-major over the stack;
- the tiles run through the network ``tile_batch`` at a time; with mirror
  TTA each micro-batch runs as the views [x, flip W, flip H, flip HW] (one
  forward of 4 x ``tile_batch`` patches with ``mirror_batch``, four forwards
  otherwise), combined as ``(l0 + l1' + l2' + l3') / 4``;
- every tile's logits, weighted by the Gaussian importance map, are added
  into the frame's accumulator, which is then divided by the summed weights;
  softmax in f32 over the classes; the padding is cropped.

The JAX function holds the logits of every tile before it accumulates them
(about 10 GB for an 840-frame case).  Here each micro-batch is added into
the accumulator as soon as it is computed.  A frame's tiles come in
ascending order (tiles are frame-major and micro-batches run in order), so
every pixel sums its tiles in the JAX function's order.  The last
micro-batch runs short instead of zero-padded: the network works on each
patch alone (InstanceNorm), so padding patches change nothing.
"""

from __future__ import annotations

import math
from typing import Callable, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def compute_tile_starts(image_size: int, tile_size: int,
                        step_frac: float) -> List[int]:
    """nnU-Net's step rule: ``ceil((image - tile) / (tile * step)) + 1``
    evenly spaced starts over [0, image - tile], rounded half to even
    (Python's ``round``)."""
    if image_size <= tile_size:
        return [0]
    target = tile_size * step_frac
    num = int(math.ceil((image_size - tile_size) / target)) + 1
    actual = (image_size - tile_size) / (num - 1)
    return [int(round(i * actual)) for i in range(num)]


def gaussian_importance_map(tile_hw: Tuple[int, int],
                            sigma_scale: float = 1.0 / 8) -> np.ndarray:
    """Centre-peaked Gaussian tile weight, built in f64, normalised to a
    maximum of 1, cast to f32 and clamped to its smallest positive value."""
    th, tw = tile_hw
    cy, cx = (th - 1) / 2.0, (tw - 1) / 2.0
    sy, sx = th * sigma_scale, tw * sigma_scale
    ys = (np.arange(th) - cy) / sy
    xs = (np.arange(tw) - cx) / sx
    g = np.exp(-0.5 * ys[:, None] ** 2) * np.exp(-0.5 * xs[None, :] ** 2)
    g = (g / g.max()).astype(np.float32)
    return np.maximum(g, g[g > 0].min())


def _forward_tta(model: Callable, x: torch.Tensor, use_mirroring: bool,
                 mirror_batch: bool) -> torch.Tensor:
    """(B, 1, th, tw) patches -> (B, C, th, tw) f32 logits, averaged over
    the mirror views."""
    if not use_mirroring:
        return model(x).float()
    views = ((-1,), (-2,), (-2, -1))
    if mirror_batch:
        B = x.shape[0]
        out = model(torch.cat([x] + [torch.flip(x, v) for v in views])).float()
        logits = out[:B]
        for k, v in enumerate(views, 1):
            logits = logits + torch.flip(out[k * B:(k + 1) * B], v)
        return logits / 4.0
    logits = model(x).float()
    for v in views:
        logits = logits + torch.flip(model(torch.flip(x, v)).float(), v)
    return logits / 4.0


@torch.no_grad()
def sliding_window_predict(model: Callable, frames: torch.Tensor,
                           tile_hw: Tuple[int, int] = (448, 576),
                           step_frac: float = 0.5,
                           use_gaussian: bool = True,
                           use_mirroring: bool = True,
                           tile_batch: int = 8,
                           mirror_batch: bool = False) -> torch.Tensor:
    """Tiled prediction over a stack of frames.

    ``model`` maps (B, 1, h, w) to logits (B, C, h, w); ``frames`` is
    (N, H, W), single-channel, in [0, 1].  Returns the class probabilities
    (N, C, H, W) f32 on the frames' device."""
    N, H, W = frames.shape
    th, tw = tile_hw
    pad_h, pad_w = max(0, th - H), max(0, tw - W)
    top, left = pad_h // 2, pad_w // 2
    x = frames.to(torch.float32)
    if pad_h or pad_w:
        x = F.pad(x, (left, pad_w - left, top, pad_h - top))
    Hp, Wp = x.shape[-2:]
    starts = [(y0, x0) for y0 in compute_tile_starts(Hp, th, step_frac)
              for x0 in compute_tile_starts(Wp, tw, step_frac)]
    T = len(starts)
    dev = frames.device
    w = torch.from_numpy(gaussian_importance_map((th, tw)) if use_gaussian
                         else np.ones((th, tw), np.float32)).to(dev)
    den = torch.zeros((Hp, Wp), dtype=torch.float32, device=dev)
    for y0, x0 in starts:
        den[y0:y0 + th, x0:x0 + tw] += w

    def tile(k):
        y0, x0 = starts[k % T]
        return x[k // T, y0:y0 + th, x0:x0 + tw]

    acc = None
    for k0 in range(0, N * T, tile_batch):
        k1 = min(k0 + tile_batch, N * T)
        batch = torch.stack([tile(k) for k in range(k0, k1)])[:, None]
        logits = _forward_tta(model, batch, use_mirroring, mirror_batch) * w
        if acc is None:
            acc = torch.zeros((N, logits.shape[1], Hp, Wp),
                              dtype=torch.float32, device=dev)
        for t, (y0, x0) in enumerate(starts):
            # the frames of this micro-batch that have tile t: a run of
            # frames, at every T-th position of the batch
            n0 = max(0, -(-(k0 - t) // T))
            n1 = (k1 - 1 - t) // T + 1
            if n1 > n0:
                i0 = n0 * T + t - k0
                acc[n0:n1, :, y0:y0 + th, x0:x0 + tw] += \
                    logits[i0:i0 + (n1 - n0 - 1) * T + 1:T]
        del batch, logits
    probs = torch.softmax(acc.div_(den), dim=1)
    del acc
    if pad_h or pad_w:
        probs = probs[:, :, top:top + H, left:left + W].contiguous()
    return probs
