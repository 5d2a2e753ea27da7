"""Segmentation evaluation: GT vs baseline vs new model (a copy of the JAX
package's ``evals/seg_metrics.py`` with its pandas frame replaced by row
dicts).

Covers the metrics and statistics of the reference's
``eval_segmentation_batch.py`` — Dice, IoU, HD95 (boundary + Euclidean
distance transform, 95th percentile), per-metric summary stats, improve
ratio, Wilcoxon signed-rank significance, best/worst listings, the
``seg_eval.csv`` contract and optional distribution plots.  One confusion
pass feeds both overlap scores, and reporting is a generic paired comparison
over metric columns.

The ``seg_eval.csv`` column layout is a contract shared with
``evals.visualize`` and ``evals.reports.seg_eval_summary``:
``case,dice_new,iou_new,hd95_new_px,dice_base,iou_base,hd95_base_px,
dice_diff,iou_diff,hd95_diff``.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
from scipy import ndimage as ndi
from scipy import stats as ss

from ..io import read_gray_png
from .table import Row, column, pyplot, write_csv

IMG_EXTS = {".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff"}
_UUID36 = re.compile(r"^([0-9a-f-]{36})", re.I)

# (column stem, pretty name, unit, higher is better)
METRICS = (("dice", "Dice", "", True),
           ("iou", "IoU", "", True),
           ("hd95", "HD95", "px", False))

# the frame's columns and the seg_eval.csv header written for them
EVAL_COLUMNS = ("case", "dice_new", "iou_new", "hd95_new",
                "dice_base", "iou_base", "hd95_base",
                "dice_diff", "iou_diff", "hd95_diff")
EVAL_HEADER = ("case", "dice_new", "iou_new", "hd95_new_px",
               "dice_base", "iou_base", "hd95_base_px",
               "dice_diff", "iou_diff", "hd95_diff")


# --------------------------------------------------------------- indexing

def case_id(stem: str) -> str:
    """Leading 36-char UUID of a filename stem (the reference's case key)."""
    m = _UUID36.match(stem)
    if not m:
        raise ValueError(f"no 36-char UUID prefix in {stem!r}")
    return m.group(1).lower()


def index_dir(root: Path, suffix_strip: str = "") -> Dict[str, Path]:
    """Recursively map case-UUID → image path for one mask directory."""
    root = Path(root)
    if not root.exists():
        return {}
    return {case_id(p.stem.replace(suffix_strip, "")): p
            for p in sorted(root.rglob("*"))
            if p.suffix.lower() in IMG_EXTS}


# --------------------------------------------------------------- metrics

def confusion_counts(pred, gt) -> Tuple[int, int, int]:
    """(intersection, |pred|, |gt|) — the sufficient statistics for every
    overlap score."""
    p = np.asarray(pred) > 0
    g = np.asarray(gt) > 0
    return int((p & g).sum()), int(p.sum()), int(g.sum())


def dice(pred, gt, eps: float = 1e-7) -> float:
    inter, np_, ng = confusion_counts(pred, gt)
    return float((2 * inter + eps) / (np_ + ng + eps))


def iou(pred, gt, eps: float = 1e-7) -> float:
    inter, np_, ng = confusion_counts(pred, gt)
    return float((inter + eps) / (np_ + ng - inter + eps))


_CROSS = np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]], np.uint8)


def _surface(mask: np.ndarray) -> np.ndarray:
    """Boundary pixels: mask minus its cross-erosion (image border counts as
    foreground, matching cv2.erode's replicated border)."""
    m = np.asarray(mask) > 0
    return m & ~ndi.binary_erosion(m, structure=_CROSS, border_value=1)


def hd95(pred, gt) -> float:
    """95th-percentile symmetric surface distance in pixels.  NaN when either
    mask is empty (the reference skips those pairs the same way)."""
    p, g = np.asarray(pred) > 0, np.asarray(gt) > 0
    if not p.any() or not g.any():
        return float("nan")
    sp, sg = _surface(p), _surface(g)
    to_g = ndi.distance_transform_edt(~sg)[sp]    # pred-surface → gt-surface
    to_p = ndi.distance_transform_edt(~sp)[sg]
    return float(max(np.percentile(to_g, 95), np.percentile(to_p, 95)))


def score_pair(pred, gt) -> Dict[str, float]:
    """All per-case metrics for one (prediction, GT) pair."""
    inter, np_, ng = confusion_counts(pred, gt)
    eps = 1e-7
    return {"dice": float((2 * inter + eps) / (np_ + ng + eps)),
            "iou": float((inter + eps) / (np_ + ng - inter + eps)),
            "hd95": hd95(pred, gt)}


# --------------------------------------------------------------- statistics

def _significance_stars(p: float) -> str:
    for thr, mark in ((0.001, "***"), (0.01, "**"), (0.05, "*")):
        if p < thr:
            return mark
    return "n.s."


def _stats(v: np.ndarray) -> dict:
    """pandas' summary of the non-NaN values (NaN for none)."""
    s = v[~np.isnan(v)]
    if s.size == 0:
        return {"mean": np.nan, "std": 0.0, "median": np.nan, "min": np.nan,
                "max": np.nan}
    return {"mean": s.mean(), "std": s.std(ddof=1) if len(s) > 1 else 0.0,
            "median": np.median(s), "min": s.min(), "max": s.max()}


def paired_comparison(new_vals, base_vals, higher_is_better: bool = True
                      ) -> dict:
    """Summary stats + improve ratio + Wilcoxon signed-rank for one metric."""
    nv = np.asarray(list(new_vals), dtype=float)
    bv = np.asarray(list(base_vals), dtype=float)
    wins = (nv > bv) if higher_is_better else (nv < bv)
    _, p = ss.wilcoxon(nv, bv, alternative="two-sided")
    return {"new": _stats(nv), "base": _stats(bv),
            "improved": int(wins.sum()), "n": len(nv),
            "wilcoxon_p": float(p), "stars": _significance_stars(float(p))}


def show_metric(name: str, new_vals, base_vals, unit: str = "",
                higher_is_better: bool = True, log=print) -> dict:
    """Log one paired comparison; returns the summary dict."""
    c = paired_comparison(new_vals, base_vals, higher_is_better)
    fmt = ("{mean:.4f} ± {std:.4f} | median {median:.4f} | "
           "min {min:.4f} | max {max:.4f}")
    log(f"\n=== {name} {unit}".rstrip())
    log("  new model : " + fmt.format(**c["new"]))
    log("  baseline  : " + fmt.format(**c["base"]))
    pct = 100.0 * c["improved"] / c["n"]
    log(f"  improved on {c['improved']} of {c['n']} cases ({pct:.1f}%)")
    log(f"  Wilcoxon signed-rank p = {c['wilcoxon_p']:.4g} [{c['stars']}]")
    return {"new_mean": c["new"]["mean"], "base_mean": c["base"]["mean"],
            "improve_ratio": pct, "wilcoxon_p": c["wilcoxon_p"],
            "stars": c["stars"]}


# ----------------------------------------------------------- evaluation

def evaluate_cases(gt_dir: Path, base_dir: Path, new_dir: Path,
                   new_suffix: str = "_mask", log=print) -> List[Row]:
    """Per-case metric rows for every UUID present in all three dirs."""
    gt_idx = index_dir(gt_dir)
    base_idx = index_dir(base_dir)
    new_idx = index_dir(new_dir, suffix_strip=new_suffix)

    records = []
    for cid, gt_path in gt_idx.items():
        if cid not in base_idx or cid not in new_idx:
            log(f"{cid}: missing prediction, skipped")
            continue
        gt_mask = read_gray_png(gt_path)
        row = {"case": cid}
        for tag, path in (("new", new_idx[cid]), ("base", base_idx[cid])):
            scores = score_pair(read_gray_png(path), gt_mask)
            row.update({f"{m}_{tag}": scores[m] for m, *_ in METRICS})
        records.append(row)
    return records


def evaluate_directories(gt_dir: Path, base_dir: Path, new_dir: Path,
                         out_csv: Optional[Path] = None,
                         new_suffix: str = "_mask",
                         plot_dir: Optional[Path] = None,
                         log=print) -> List[tuple]:
    """Full evaluation: per-case metrics, paired statistics, best/worst
    cases, ``seg_eval.csv`` and optional plots.  Returns the CSV rows."""
    rows = evaluate_cases(gt_dir, base_dir, new_dir, new_suffix, log)
    if not rows:
        raise SystemExit("No matching cases between GT/base/new directories")

    for stem, pretty, unit, hib in METRICS:
        show_metric(pretty, column(rows, f"{stem}_new"),
                    column(rows, f"{stem}_base"), unit,
                    higher_is_better=hib, log=log)

    order = np.argsort(-column(rows, "dice_new"), kind="stable")
    by_dice = [rows[i] for i in order]
    for title, part in (("best", by_dice[:5]), ("worst", by_dice[-5:])):
        log(f"\n{title} 5 cases by new-model Dice:")
        for r in part:
            log(f"  {r['case'][:8]}  new={r['dice_new']:.4f}  "
                f"base={r['dice_base']:.4f}")

    for r in rows:
        for stem, *_ in METRICS:
            r[f"{stem}_diff"] = r[f"{stem}_new"] - r[f"{stem}_base"]

    if out_csv:
        out_csv = Path(out_csv)
        out_csv.parent.mkdir(parents=True, exist_ok=True)
        write_csv(out_csv, EVAL_COLUMNS, rows, header=EVAL_HEADER)
        log(f"\nwrote {out_csv}")

    if plot_dir:
        save_distribution_plots(rows, Path(plot_dir), log)
    return [tuple(r[c] for c in EVAL_COLUMNS) for r in rows]


def save_distribution_plots(rows: List[Row], plot_dir: Path,
                            log=print) -> None:
    """Histogram + box plot per metric (base vs new)."""
    plot_dir = Path(plot_dir)
    plt = pyplot([plot_dir / f"{stem}_{kind}.png" for stem, *_ in METRICS
                  for kind in ("hist", "box")])
    if plt is None:
        return
    plot_dir.mkdir(parents=True, exist_ok=True)
    for stem, pretty, _, _ in METRICS:
        base = column(rows, f"{stem}_base")
        new = column(rows, f"{stem}_new")
        base, new = base[~np.isnan(base)], new[~np.isnan(new)]
        for kind in ("hist", "box"):
            fig, ax = plt.subplots()
            if kind == "hist":
                ax.hist([base, new], label=["Base", "New"], bins=20,
                        alpha=0.6)
                ax.legend()
                ax.set_xlabel(pretty)
            else:
                ax.boxplot([base, new], tick_labels=["Base", "New"])
                ax.set_ylabel(pretty)
            ax.set_title(f"{pretty} {kind}")
            fig.savefig(plot_dir / f"{stem}_{kind}.png", dpi=200)
            plt.close(fig)
    log(f"plots saved to {plot_dir}")
