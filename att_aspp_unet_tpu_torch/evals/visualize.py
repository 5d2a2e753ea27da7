"""Worst-case error visualisation (a copy of the JAX package's
``evals/visualize.py``; PIL and matplotlib are imported where they draw).

The reference's ``vis_error_analysis.py`` equivalents without OpenCV: Dice
scatter + ΔDice histogram from ``seg_eval.csv``, and per-case RGB overlays of
GT (red) / baseline-only (green) / new-only (blue) with translucent fill and
a traced border stroke, for the top-N worst ΔDice cases.
"""

from __future__ import annotations

import csv
from pathlib import Path
from typing import Optional

import numpy as np

from ..io import read_gray_png
from .seg_metrics import index_dir
from .table import pyplot

COL_NEW = (0, 0, 255)       # blue: new-only
COL_BASE = (0, 255, 0)      # green: base-only
COL_GT = (255, 0, 0)        # red: GT


def _border(mask: np.ndarray, thickness: int = 2) -> np.ndarray:
    """Mask pixels within ``thickness`` of the background (contour stroke)."""
    from scipy import ndimage as ndi

    m = mask.astype(bool)
    inner = ndi.binary_erosion(m, iterations=thickness, border_value=1)
    return (m & ~inner)


def overlay_and_border(img_rgb: np.ndarray, mask_bin: np.ndarray,
                       color, alpha: float = 0.35,
                       thickness: int = 2) -> np.ndarray:
    m = mask_bin.astype(bool)
    if m.any():
        img_rgb[m] = (img_rgb[m] * (1 - alpha) +
                      np.array(color) * alpha).astype(np.uint8)
        img_rgb[_border(mask_bin, thickness)] = color
    return img_rgb


def read_seg_eval(csv_path: Path):
    with open(csv_path, newline="") as f:
        return list(csv.DictReader(f))


def plot_dice_summary(rows, out_dir: Path) -> None:
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    plt = pyplot([out_dir / "dice_scatter.png", out_dir / "dice_diff_hist.png"])
    if plt is None:
        return
    dice_new = np.array([float(r["dice_new"]) for r in rows])
    dice_base = np.array([float(r["dice_base"]) for r in rows])
    diff = np.array([float(r["dice_diff"]) for r in rows])

    plt.figure(figsize=(5, 5))
    plt.scatter(dice_base, dice_new, alpha=0.7)
    plt.plot([0, 1], [0, 1], "--", color="grey")
    plt.xlabel("Dice (Base)")
    plt.ylabel("Dice (New)")
    plt.title("Dice scatter")
    plt.savefig(out_dir / "dice_scatter.png", dpi=300, bbox_inches="tight")
    plt.close()

    plt.figure(figsize=(5, 4))
    plt.hist(diff, bins=20, color="steelblue")
    plt.axvline(0, color="red", ls="--")
    plt.xlabel("Dice(New) − Dice(Base)")
    plt.title("Dice difference histogram")
    plt.savefig(out_dir / "dice_diff_hist.png", dpi=300, bbox_inches="tight")
    plt.close()


def render_worst_cases(seg_eval_csv: Path, gt_dir: Path, base_dir: Path,
                       new_dir: Path, out_dir: Path,
                       img_dir: Optional[Path] = None, top: int = 10,
                       alpha: float = 0.35, edge: int = 2,
                       new_suffix: str = "_mask", log=print) -> int:
    from PIL import Image

    rows = read_seg_eval(seg_eval_csv)
    if not rows:
        raise SystemExit("seg_eval.csv is empty")
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    plot_dice_summary(rows, out_dir)

    diff = np.array([float(r["dice_diff"]) for r in rows])
    worst = np.argsort(diff)[:top]

    gt_idx = index_dir(gt_dir)
    base_idx = index_dir(base_dir)
    new_idx = index_dir(new_dir, suffix_strip=new_suffix)
    img_idx = index_dir(img_dir) if img_dir else {}

    rendered = 0
    for rank, i in enumerate(worst, 1):
        cid = rows[i]["case"]
        if cid not in gt_idx or cid not in base_idx or cid not in new_idx:
            log(f"  skip {cid}")
            continue
        gt = read_gray_png(gt_idx[cid])
        pb = read_gray_png(base_idx[cid])
        pn = read_gray_png(new_idx[cid])
        h, w = gt.shape
        if cid in img_idx:
            bg = read_gray_png(img_idx[cid])
            if bg.shape != (h, w):
                bg = np.asarray(Image.fromarray(bg).resize((w, h),
                                                           Image.BILINEAR))
        else:
            bg = np.zeros((h, w), np.uint8)
        canvas = np.stack([bg] * 3, axis=-1)

        m_gt = (gt > 0).astype(np.uint8)
        m_new_only = ((pn > 0) & (gt == 0)).astype(np.uint8)
        m_base_only = ((pb > 0) & (gt == 0)).astype(np.uint8)

        canvas = overlay_and_border(canvas, m_new_only, COL_NEW, alpha, edge)
        canvas = overlay_and_border(canvas, m_base_only, COL_BASE, alpha, edge)
        canvas = overlay_and_border(canvas, m_gt, COL_GT, alpha, edge)

        out_path = out_dir / f"{rank:02d}_{cid[:8]}_overlay.png"
        Image.fromarray(canvas).save(out_path)
        log(f"  {rank:02d}. {cid} → {out_path.name}")
        rendered += 1
    return rendered
