"""Threshold calibration (counterpart of ``att_aspp_unet_tpu/infer/calibrate.py``).

Sweep probability thresholds over a val set of PNGs, pick the argmax of the
mean Dice and write ``thr.json``.  The val set is grouped by native
resolution: each group's probabilities come from one ``predict_full`` and its
(images x thresholds) Dice surface from one reduction, so the work is one
forward per image, never one per threshold.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..config import Config
from ..io import read_gray_png, write_json


def dice_curve(probs: torch.Tensor, gt: torch.Tensor,
               thresholds: torch.Tensor) -> torch.Tensor:
    """Per-threshold Dice of one (H, W) probability map vs binary GT."""
    return dice_curves(probs[None], gt[None], thresholds)[0]


def dice_curves(probs: torch.Tensor, gts: torch.Tensor,
                thresholds: torch.Tensor) -> torch.Tensor:
    """(n, H, W) probabilities x (n, H, W) GT -> (n, n_thr) f32 Dice
    surface, in one reduction."""
    g = (gts > 0).to(torch.float32)
    m = (probs[:, None] > thresholds[None, :, None, None]).to(torch.float32)
    inter = (m * g[:, None]).sum(dim=(-2, -1))
    return 2.0 * inter / (m.sum(dim=(-2, -1)) + g.sum(dim=(-2, -1))[:, None]
                          + 1e-7)


def calibrate(cfg: Config, variables: dict, val_dir: Path, output_dir: Path,
              device="cuda", log=print, engine=None) -> dict:
    """Scan thresholds over ``<val_dir>/images/*.png`` against the masks of
    the same names in ``<val_dir>/masks``; write ``<output_dir>/thr.json``
    (and with ``cfg.calibrate.with_ci`` the CSVs and plots).  ``engine``
    serves with an existing :class:`AttAsppEngine` instead of building one.

    TTA comes from ``cfg.predict.tta_hflip``, which defaults to off; the
    ``calibrate`` CLI turns it on, as the reference's calibrate ran it."""
    from .engine import AttAsppEngine

    ccfg = cfg.calibrate
    if engine is None:
        engine = AttAsppEngine(cfg, variables, device=device)
    val_dir = Path(val_dir)
    imgs = sorted((val_dir / "images").glob("*.png"))
    if not imgs:
        raise FileNotFoundError(f"no PNGs under {val_dir / 'images'}")

    thrs = np.linspace(ccfg.thr_lo, ccfg.thr_hi, ccfg.thr_steps)
    thrs_t = torch.as_tensor(thrs, dtype=torch.float32).to(engine.device)

    frames = [read_gray_png(ip) for ip in imgs]
    gts = [read_gray_png(val_dir / "masks" / ip.name) > 127 for ip in imgs]
    groups: Dict[Tuple[int, int], List[int]] = {}
    for i, f in enumerate(frames):
        groups.setdefault(f.shape, []).append(i)

    curves = np.empty((len(imgs), len(thrs)), np.float64)
    for idxs in groups.values():
        probs = engine.predict_full(np.stack([frames[i] for i in idxs]))
        gt = torch.as_tensor(np.stack([gts[i] for i in idxs])).to(engine.device)
        curves[idxs] = dice_curves(probs, gt, thrs_t).cpu().numpy()
    means = curves.mean(axis=0)
    best_idx = int(np.argmax(means))
    best_thr = float(thrs[best_idx])

    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    write_json(output_dir / "thr.json", {"best_thr": best_thr}, indent=2)
    log(f"Calibrated thr={best_thr:.3f} (mean Dice {means[best_idx]:.4f})")

    if ccfg.with_ci:
        _write_ci_outputs(thrs, curves, output_dir, log)
    return {"best_thr": best_thr, "thresholds": thrs, "mean_dice": means,
            "curves": curves}


def _write_ci_outputs(thrs: np.ndarray, curves: np.ndarray, out_dir: Path,
                      log=print) -> None:
    """Per-threshold mean / std / median and a t-distribution 95 % CI:
    ``calibrate_curve.csv``, the per-image ``calibrate_raw.csv``, and two
    plots when matplotlib can draw them."""
    import csv

    from scipy import stats

    n = curves.shape[0]
    means = curves.mean(axis=0)
    stds = curves.std(axis=0, ddof=1) if n > 1 else np.zeros_like(means)
    medians = np.median(curves, axis=0)
    half = stats.t.ppf(0.975, max(n - 1, 1)) * stds / np.sqrt(max(n, 1))

    with open(out_dir / "calibrate_curve.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["thr", "mean_dice", "std", "median", "ci95_lo", "ci95_hi"])
        for i, t in enumerate(thrs):
            w.writerow([f"{t:.4f}", f"{means[i]:.6f}", f"{stds[i]:.6f}",
                        f"{medians[i]:.6f}", f"{means[i]-half[i]:.6f}",
                        f"{means[i]+half[i]:.6f}"])
    with open(out_dir / "calibrate_raw.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["image_idx"] + [f"thr_{t:.4f}" for t in thrs])
        for i, row in enumerate(curves):
            w.writerow([i] + [f"{v:.6f}" for v in row])

    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError as e:
        log(f"plotting skipped: {e}")
        return
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.plot(thrs, means, marker="o", label="mean Dice")
    ax.fill_between(thrs, means - half, means + half, alpha=0.3,
                    label="95% CI")
    ax.set_xlabel("threshold")
    ax.set_ylabel("Dice")
    ax.legend()
    fig.savefig(out_dir / "calibrate_curve.png", dpi=200, bbox_inches="tight")
    plt.close(fig)

    fig, ax = plt.subplots(figsize=(6, 4))
    ax.boxplot(list(curves.T), positions=np.round(thrs, 3), widths=0.01)
    ax.set_xlabel("threshold")
    ax.set_ylabel("per-image Dice")
    fig.savefig(out_dir / "calibrate_box.png", dpi=200, bbox_inches="tight")
    plt.close(fig)
