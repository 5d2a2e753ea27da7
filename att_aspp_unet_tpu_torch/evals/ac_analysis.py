"""Abdominal-circumference agreement analysis (GT vs model predictions); a
copy of the JAX package's ``evals/ac_analysis.py`` with its pandas frames
replaced by row tables (``evals/table.py``) that write the same files.

Capability parity with the reference's ``analyze_ac.py`` — sweep-aware
matching of per-sweep ground-truth AC values against per-frame predictions,
per-model error metrics (MAE/RMSE/MAPE/Pearson-r), paired significance tests
between two models, and agreement plots:

* the wide GT table is parsed column-by-column with a regex (no ``melt``);
* error metrics live in one declarative ``ERROR_METRICS`` table evaluated
  over NumPy arrays (the same shape as ``seg_metrics.METRICS``);
* paired statistics are a reusable ``paired_tests`` helper;
* plotting walks a figure-spec table instead of inline plt calls.

File contracts kept verbatim: ``merged_ac_values.csv`` (error columns
``abs_err/sq_err/ape_%`` as the reference writes them, plus a signed
``err_mm``), ``metrics.csv`` (rows = model in alphabetical order, columns
``MAE_mm/RMSE_mm/MAPE_pct/Corr_r``), ``stats.txt``, ``scatter_<model>.png``,
``bland_alt_<model>.png``, ``error_hist.png``.
"""

from __future__ import annotations

import math
import re
from pathlib import Path
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
from scipy import stats as ss

from .table import (Row, column, format_table, inner_join, pyplot,
                    read_csv, write_csv)

# GT table: one row per case, AC columns named like ``sweep_3_ac_mm``
# (reference GT file ``ac_result/gt/fetal_abdominal_circumferences_per_sweep.csv``).
_AC_COLUMN = re.compile(r"(\d+).*_ac_mm$")
_PRED_COLUMNS = ("case_id", "frame_idx", "ac_mm")
PRED_TABLE_COLUMNS = _PRED_COLUMNS + ("sweep_idx", "model")
# merged_ac_values.csv: the predictions' columns, the GT's value, the errors
MERGED_COLUMNS = PRED_TABLE_COLUMNS + ("gt_ac_mm", "err_mm", "abs_err",
                                       "sq_err", "ape_%")


# ------------------------------------------------------------------ parsing

def frame_to_sweep(frame_idx, frames_per_sweep: int):
    """1-based sweep index of a global frame index.

    A case stacks six 140-frame sweeps, so ``frame // fps + 1`` recovers
    which sweep a predicted frame belongs to (reference ``analyze_ac.py:54``).
    """
    return np.asarray(frame_idx) // int(frames_per_sweep) + 1


def melt_gt(columns: Sequence[str], rows: Sequence[Row]) -> List[Row]:
    """Long-form ``(case_id, sweep_idx, gt_ac_mm)`` rows from the wide GT
    table (``read_csv``'s columns and rows).

    Each ``*_ac_mm`` column is one sweep; the sweep index is the first
    integer in the column name; rows without a measurement are dropped.
    """
    key = "case_id" if "case_id" in columns else "uuid"
    parts = []
    for col in columns:
        m = _AC_COLUMN.search(col)
        if m is None:
            continue
        vals = column(rows, col)
        parts += [{"case_id": r[key], "sweep_idx": int(m.group(1)),
                   "gt_ac_mm": float(v)}
                  for r, v in zip(rows, vals) if not math.isnan(v)]
    if not any(_AC_COLUMN.search(c) for c in columns):
        raise ValueError("GT table has no *_ac_mm sweep columns")
    return parts


def read_pred(path, model: str, fps: int) -> List[Row]:
    """Load one model's ``ac_results.csv`` and tag it with model + sweep."""
    columns, rows = read_csv(path)
    missing = [c for c in _PRED_COLUMNS if c not in columns]
    if missing:
        raise ValueError(f"{path} needs columns {set(_PRED_COLUMNS)}")
    sweeps = frame_to_sweep(np.array([r["frame_idx"] for r in rows]), fps)
    return [{**{c: r[c] for c in _PRED_COLUMNS}, "sweep_idx": s,
             "model": model}
            for r, s in zip(rows, sweeps.tolist())]


def match_predictions(gt_long: Sequence[Row],
                      preds: Sequence[Sequence[Row]]) -> List[Row]:
    """Inner-join predictions with GT on (case_id, sweep_idx), in the row
    order of pandas' merge (``table.inner_join``; a (case_id, sweep_idx)
    given twice in the GT raises ``ValueError``), and attach per-row error
    columns."""
    left = [p for part in preds for p in part]
    key = ("case_id", "sweep_idx")
    joined = [{**left[i], "gt_ac_mm": gt_long[j]["gt_ac_mm"]}
              for i, j in inner_join(
                  [tuple(r[k] for k in key) for r in left],
                  [tuple(r[k] for k in key) for r in gt_long])]
    if not joined:
        raise RuntimeError("No matched (case_id, sweep_idx)")
    err = column(joined, "ac_mm") - column(joined, "gt_ac_mm")
    gt = column(joined, "gt_ac_mm")
    with np.errstate(divide="ignore", invalid="ignore"):
        ape = 100.0 * np.abs(err) / gt
    # reference merged-CSV error columns kept verbatim (abs_err/sq_err/ape_%,
    # ``analyze_ac.py:59-61``); err_mm (signed) is an addition
    for r, e, a in zip(joined, err, ape):
        r.update({"err_mm": float(e), "abs_err": float(abs(e)),
                  "sq_err": float(e ** 2), "ape_%": float(a)})
    return joined


# ------------------------------------------------------------------ metrics

# (column name, scorer over (pred_mm, gt_mm) arrays)
ERROR_METRICS: Tuple[Tuple[str, Callable], ...] = (
    ("MAE_mm",   lambda p, g: np.mean(np.abs(p - g))),
    ("RMSE_mm",  lambda p, g: np.sqrt(np.mean((p - g) ** 2))),
    ("MAPE_pct", lambda p, g: 100.0 * np.mean(np.abs(p - g) / g)),
    ("Corr_r",   lambda p, g: np.corrcoef(p, g)[0, 1]),
)
METRIC_COLUMNS = ("model",) + tuple(name for name, _ in ERROR_METRICS)


def _model_rows(matched: Sequence[Row], model: str) -> List[Row]:
    return [r for r in matched if r["model"] == model]


def error_table(matched: Sequence[Row], ndigits: int = 3) -> List[Row]:
    """One row per model (alphabetical, the reference's metrics.csv row
    order: ``analyze_ac.py:101-107`` uses pandas' sorted groupby), one column
    per ``ERROR_METRICS`` entry."""
    out = []
    for model in sorted({r["model"] for r in matched}):
        sub = _model_rows(matched, model)
        p, g = column(sub, "ac_mm"), column(sub, "gt_ac_mm")
        out.append({"model": model,
                    **{name: round(float(fn(p, g)), ndigits)
                       for name, fn in ERROR_METRICS}})
    return out


def paired_tests(err_a, err_b) -> Dict[str, float]:
    """Paired t-test + Wilcoxon signed-rank over matched absolute errors.

    Empty when the two error vectors cannot be paired (different lengths —
    the models were evaluated on different case sets) or are too short.
    """
    a = np.asarray(err_a, dtype=float)
    b = np.asarray(err_b, dtype=float)
    if a.shape != b.shape or a.size < 2:
        return {}
    t, p_t = ss.ttest_rel(a, b)
    w, p_w = ss.wilcoxon(a, b, zero_method="zsplit")
    return {"t": float(t), "p_t": float(p_t), "w": float(w), "p_w": float(p_w)}


# ------------------------------------------------------------------- plots

def _identity_scatter(ax, gt: np.ndarray, pred: np.ndarray) -> None:
    """Predicted vs GT with the y=x perfect-agreement line."""
    ax.scatter(gt, pred, alpha=0.6)
    span = (min(gt.min(), pred.min()), max(gt.max(), pred.max()))
    ax.plot(span, span, ls="--")
    ax.set_xlabel("GT (mm)")
    ax.set_ylabel("Pred (mm)")


def _bland_altman(ax, gt: np.ndarray, pred: np.ndarray) -> None:
    """Difference vs mean with bias and 95% limits of agreement."""
    diff = pred - gt
    bias = diff.mean()
    loa = 1.96 * diff.std(ddof=1)
    ax.scatter((gt + pred) / 2.0, diff, alpha=0.6)
    ax.axhline(bias, ls="--")
    for limit in (bias - loa, bias + loa):
        ax.axhline(limit, ls="--", c="r")
    ax.set_xlabel("Mean (mm)")
    ax.set_ylabel("Diff (mm)")


# (output filename template, axes renderer) — one pair of files per model
PER_MODEL_FIGURES = (("scatter_{model}.png", _identity_scatter),
                     ("bland_alt_{model}.png", _bland_altman))


def save_agreement_plots(matched: Sequence[Row], out: Path,
                         models: Sequence[str]) -> None:
    out = Path(out)
    drawn = [m for m in models if _model_rows(matched, m)]
    plt = pyplot([out / t.format(model=m) for m in drawn
                  for t, _ in PER_MODEL_FIGURES] + [out / "error_hist.png"])
    if plt is None:
        return
    for model in drawn:
        sub = _model_rows(matched, model)
        gt = column(sub, "gt_ac_mm")
        pred = column(sub, "ac_mm")
        for template, render in PER_MODEL_FIGURES:
            fig, ax = plt.subplots(figsize=(5, 5))
            render(ax, gt, pred)
            ax.set_title(model)
            fig.savefig(out / template.format(model=model), dpi=300)
            plt.close(fig)

    fig, ax = plt.subplots(figsize=(6, 4))
    for model in models:
        ax.hist(column(_model_rows(matched, model), "abs_err"),
                bins=25, alpha=0.5, label=model, histtype="stepfilled")
    ax.legend()
    fig.savefig(out / "error_hist.png", dpi=300)
    plt.close(fig)


# ---------------------------------------------------------------- analysis

def analyze_ac(gt_csv, baseline_csv, new_csv, out_dir,
               frames_per_sweep: int = 140,
               model_names=("baseline", "attention_aspp_unet"),
               make_plots: bool = True, log=print) -> Dict:
    """Full AC agreement analysis between two models and the GT table."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)

    gt_long = melt_gt(*read_csv(gt_csv))
    matched = match_predictions(gt_long, [
        read_pred(path, name, frames_per_sweep)
        for path, name in zip((baseline_csv, new_csv), model_names)])
    write_csv(out / "merged_ac_values.csv", MERGED_COLUMNS, matched)

    metrics = error_table(matched)
    write_csv(out / "metrics.csv", METRIC_COLUMNS, metrics)
    log("\n*** Metrics ***\n" + format_table(METRIC_COLUMNS, metrics))

    per_model_err = {name: column(_model_rows(matched, name), "abs_err")
                     for name in model_names}
    tests = paired_tests(per_model_err[model_names[0]],
                         per_model_err[model_names[1]])
    if tests:
        (out / "stats.txt").write_text(
            "Paired t-test: t={t:.3f}, p={p_t:.4g}\n"
            "Wilcoxon: W={w:.1f}, p={p_w:.4g}\n".format(**tests))

    if make_plots:
        save_agreement_plots(matched, out, model_names)
    return {"metrics": metrics, "stats": tests, "merged": matched}
