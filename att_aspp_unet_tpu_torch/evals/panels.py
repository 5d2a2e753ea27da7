"""Diagnostic figures and tables of the predict CLI (a copy of
``att_aspp_unet_tpu/evals/panels.py``):

- ``save_attention_panel``: a 2x4 sheet per image: raw frame, probability
  overlay, psi-map overlay, mask overlay on row 1; the no-attention model's
  counterparts on row 2;
- ``save_topk_candidates``: the top-K area candidate frames with probability
  and mask overlays, circularity and area per candidate, the selected frame
  highlighted;
- ``write_slice_metrics_csv``: per-slice area and circularity of a predicted
  sweep.

Host numpy and PIL (imported inside the functions), no matplotlib: the jet
colormap is matplotlib's own lookup table, rebuilt here, so the attention
panel has the JAX package's pixels; the top-K sheet is drawn with PIL on a
grid of its own (the JAX package draws it with matplotlib's pyplot).
"""

from __future__ import annotations

import csv
from pathlib import Path
from typing import Sequence

import numpy as np


# matplotlib's "jet": (x, y0, y1) break points of each channel
_JET = (((0.0, 0, 0), (0.35, 0, 0), (0.66, 1, 1), (0.89, 1, 1),
         (1.0, 0.5, 0.5)),
        ((0.0, 0, 0), (0.125, 0, 0), (0.375, 1, 1), (0.64, 1, 1),
         (0.91, 0, 0), (1.0, 0, 0)),
        ((0.0, 0.5, 0.5), (0.11, 1, 1), (0.34, 1, 1), (0.65, 0, 0),
         (1.0, 0, 0)))
_LUT_N = 256


def _segment_lut(data, n: int = _LUT_N) -> np.ndarray:
    """The n-entry table that matplotlib's ``LinearSegmentedColormap``
    builds from one channel's break points."""
    a = np.array(data, dtype=float)
    x, y0, y1 = a[:, 0] * (n - 1), a[:, 1], a[:, 2]
    xind = (n - 1) * np.linspace(0, 1, n)
    ind = np.searchsorted(x, xind)[1:-1]
    distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    lut = np.concatenate([[y1[0]], distance * (y0[ind] - y1[ind - 1])
                          + y1[ind - 1], [y0[-1]]])
    return np.clip(lut, 0.0, 1.0)


def _lut_index(p: np.ndarray) -> np.ndarray:
    """Table index of a [0, 1] map, as matplotlib's colormap call takes it."""
    xa = np.array(p, copy=True)
    xa *= _LUT_N
    xa[xa == _LUT_N] = _LUT_N - 1
    return xa.astype(int)


def _colorize(prob: np.ndarray) -> np.ndarray:
    """Jet colourisation of a [0, 1] map -> uint8 RGB."""
    p = np.clip(np.nan_to_num(np.squeeze(prob), nan=0.0), 0.0, 1.0)
    lut = np.stack([_segment_lut(ch) for ch in _JET], axis=-1)
    return (lut[_lut_index(p)] * 255).astype(np.uint8)


def _overlay(gray: np.ndarray, color_rgb: np.ndarray,
             alpha: float = 0.5) -> np.ndarray:
    base = np.stack([gray] * 3, axis=-1).astype(np.float32)
    return ((1 - alpha) * base + alpha * color_rgb.astype(np.float32)
            ).astype(np.uint8)


def save_attention_panel(case_id: str, raw_u8: np.ndarray,
                         prob_att: np.ndarray, psi_att: np.ndarray,
                         mask_att: np.ndarray, prob_noatt: np.ndarray,
                         mask_noatt: np.ndarray, out_dir) -> Path:
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    raw_rgb = np.stack([raw_u8] * 3, axis=-1)

    def mask_rgb(m):
        return np.stack([(m > 0) * 255] * 3, axis=-1).astype(np.uint8)

    row1 = np.hstack([
        raw_rgb,
        _overlay(raw_u8, _colorize(prob_att)),
        _overlay(raw_u8, _colorize(_resize_like(psi_att, raw_u8))),
        _overlay(raw_u8, mask_rgb(mask_att), 0.4),
    ])
    blank = np.full_like(raw_rgb, 255)
    row2 = np.hstack([
        raw_rgb,
        _overlay(raw_u8, _colorize(prob_noatt)),
        blank,
        _overlay(raw_u8, mask_rgb(mask_noatt), 0.4),
    ])
    panel = np.vstack([row1, row2])

    from PIL import Image

    out = out_dir / f"{case_id}_panel.png"
    Image.fromarray(panel).save(out)
    return out


def _resize_like(m: np.ndarray, ref: np.ndarray) -> np.ndarray:
    m = np.squeeze(np.asarray(m, np.float32))
    if m.shape == ref.shape:
        return m
    from PIL import Image

    return np.asarray(Image.fromarray(m).resize(
        (ref.shape[1], ref.shape[0]), Image.BILINEAR))


def save_topk_candidates(imgs_u8: np.ndarray, probs: np.ndarray,
                         masks: np.ndarray, topk_idx: Sequence[int],
                         best_idx: int, ac_mm: float, out_png) -> None:
    """A 2 x K sheet: per candidate the frame with its probabilities (jet,
    alpha 0.35) above the frame with its mask (matplotlib's "spring":
    magenta background, yellow mask, alpha 0.35), titled with the frame index,
    circularity and area; the selected frame framed in lime."""
    from PIL import Image, ImageDraw

    from ..postprocess import circularity

    K = len(topk_idx)
    H, W = imgs_u8.shape[-2:]
    title_h, pad, border = 28, 6, 3
    head = 22
    sheet = np.full((head + 2 * (title_h + H + pad), K * (W + pad) + pad, 3),
                    255, np.uint8)
    titles = []
    for j, idx in enumerate(topk_idx):
        gray = imgs_u8[idx]
        m = masks[idx] > 0
        circ = float(circularity(masks[idx][None])[0])
        spring = np.where(m[..., None], np.uint8([255, 255, 0]),
                          np.uint8([255, 0, 255]))
        cells = (_overlay(gray, _colorize(probs[idx]), 0.35),
                 _overlay(gray, spring, 0.35))
        x0 = pad + j * (W + pad)
        for r, cell in enumerate(cells):
            y0 = head + r * (title_h + H + pad) + title_h
            if idx == best_idx:
                sheet[y0 - border:y0 + H + border,
                      x0 - border:x0 + W + border] = (0, 255, 0)
            sheet[y0:y0 + H, x0:x0 + W] = cell
        titles.append((x0, f"s{idx}  circ={circ:.2f}", f"area={int(m.sum())}"))
    img = Image.fromarray(sheet)
    draw = ImageDraw.Draw(img)
    draw.text((pad, 4), f"Top-{K} candidates; best = s{best_idx}; "
              f"AC = {ac_mm:.1f} mm", fill=(0, 0, 0))
    for x0, line1, line2 in titles:
        draw.text((x0, head), line1, fill=(0, 0, 0))
        draw.text((x0, head + 12), line2, fill=(0, 0, 0))
    Path(out_png).parent.mkdir(parents=True, exist_ok=True)
    img.save(out_png)


def write_slice_metrics_csv(masks: np.ndarray, out_csv, case_id: str = ""
                            ) -> None:
    """Per-slice area (px) and circularity of a (N, H, W) mask stack."""
    from ..postprocess import circularity

    circs = circularity(masks).numpy()
    with open(out_csv, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["case_id", "slice_idx", "area_px", "circularity"])
        for i, m in enumerate(masks):
            w.writerow([case_id, i, int((m > 0).sum()), f"{circs[i]:.6f}"])
