"""Dataset reports + seg-eval summary plots (the reference ``plot/`` suite); a
copy of the JAX package's ``evals/reports.py`` with its pandas frames
replaced by row tables (``evals/table.py``) that write the same files.

(a) dataset reports — three input modes like ``plot/make_dataset_reports.py``
    (frame_indices.json / pos-neg subdirs / flat images+masks), producing
    ``split_stats.csv``, ``per_case_stats.csv``, class-balance + frames-per-
    case plots and a LaTeX table;
(b) attention-vs-no-attention paired comparison plots
    (``plot/plot_attention_comparison.py``);
(c) seg_eval summary stats + plots (``plot/plot_from_seg_eval.py``, with the
    new/base columns read correctly: the reference swapped them);
(d) Dice scatter / ΔDice histogram (``plot/dice_plot.py``) lives in
    ``visualize.plot_dice_summary``.

A frame table is a list of rows with the keys ``split``, ``cls``, ``case``
and ``file``.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..io import read_gray_png
from .table import Row, column, inner_join, pyplot, read_csv, write_csv

_CASE_RX = re.compile(r"^([A-Za-z0-9\-]+)[_\-]?\d+")
PER_CASE_COLUMNS = ("split", "case", "frames_per_case")
SUMMARY_COLUMNS = ("split", "cases", "frames_total", "pos_frames",
                   "neg_frames", "pos_%", "neg_%", "frames_per_case_mean",
                   "frames_per_case_std")
ATT_COLUMNS = ("dice_new", "iou_new", "hd95_new_px")


def _case_of(stem: str, rx=None) -> str:
    m = (rx or _CASE_RX).match(stem)
    return m.group(1) if m else stem.split("_")[0]


def load_from_frame_index(json_path: Path) -> List[Row]:
    data = json.loads(Path(json_path).read_text())
    rows = []
    if isinstance(data, list):
        for it in data:
            split = str(it.get("split", it.get("subset", "train"))).lower()
            label = str(it.get("label", it.get("cls", "pos"))).lower()
            case = it.get("case") or it.get("case_id") or it.get("study_id")
            fname = it.get("path") or it.get("file") or it.get("filename")
            label = "pos" if label in ("1", "true", "pos", "positive",
                                       "foreground") else "neg"
            if case is None and fname:
                case = Path(fname).stem.split("_")[0]
            rows.append({"split": split, "cls": label, "case": case,
                         "file": fname})
    elif isinstance(data, dict):
        guess = "train" if "train" in str(Path(json_path).parent).lower() \
            else ("val" if "val" in str(Path(json_path).parent).lower()
                  else "train")
        for case, d in data.items():
            for idx in d.get("pos", []):
                rows.append({"split": guess, "cls": "pos", "case": case,
                             "file": f"{case}_s{idx:03d}.png"})
            for idx in d.get("neg", []):
                rows.append({"split": guess, "cls": "neg", "case": case,
                             "file": f"{case}_s{idx:03d}.png"})
    else:
        raise ValueError("Unsupported frame_indices.json structure")
    return rows


def load_from_directory(root: Path, splits=("train", "val"),
                        classes=("pos", "neg"),
                        case_regex: Optional[str] = None) -> List[Row]:
    rx = re.compile(case_regex) if case_regex else _CASE_RX
    recs = []
    for sp in splits:
        for cl in classes:
            d = Path(root) / sp / cl
            if not d.exists():
                continue
            for p in sorted(d.glob("*.png")):
                recs.append({"split": sp, "cls": cl,
                             "case": _case_of(p.stem, rx), "file": str(p)})
    return recs


def load_flat_images_masks(root: Path, case_regex: Optional[str] = None,
                           split_name_override: Optional[str] = None
                           ) -> List[Row]:
    rx = re.compile(case_regex) if case_regex else _CASE_RX
    root = Path(root)
    if split_name_override:
        splits = [(split_name_override, root)]
    else:
        splits = [(sub.name, sub) for sub in sorted(root.iterdir())
                  if sub.is_dir() and (sub / "images").exists()
                  and (sub / "masks").exists()] if root.exists() else []
        if not splits and (root / "images").exists() and (root / "masks").exists():
            splits = [("train", root)]
    recs = []
    for sp_name, sp_dir in splits:
        img_dir, msk_dir = sp_dir / "images", sp_dir / "masks"
        for p in sorted(img_dir.glob("*.png")):
            mp = msk_dir / p.name
            if not mp.exists():
                continue
            cls = "pos" if (read_gray_png(mp) > 0).any() else "neg"
            recs.append({"split": sp_name, "cls": cls,
                         "case": _case_of(p.stem, rx), "file": str(p)})
    return recs


def _std1(v: Sequence[float]) -> float:
    return float(np.std(np.asarray(v, float), ddof=1)) if len(v) > 1 else 0.0


def _mean(v: Sequence[float]) -> float:
    return float(np.mean(np.asarray(v, float))) if len(v) else 0.0


def _split_row(split: str, rows: Sequence[Row], fpc: Sequence[int]) -> Row:
    total = len(rows)
    pos = sum(r["cls"] == "pos" for r in rows)
    out = {"split": split,
           "cases": len({r["case"] for r in rows if r["case"] is not None}),
           "frames_total": total, "pos_frames": pos,
           "neg_frames": total - pos}
    if total:
        out["pos_%"] = round(100 * pos / total, 1)
        out["neg_%"] = round(100 * (total - pos) / total, 1)
    out["frames_per_case_mean"] = round(_mean(fpc), 1)
    out["frames_per_case_std"] = round(_std1(fpc), 1)
    return out


def summarize(rows: Sequence[Row]) -> Tuple[List[Row], List[Row]]:
    """(frames per (split, case), sorted as pandas' groupby sorts; the
    per-split statistics with an ``overall`` row)."""
    counts = {}
    for r in rows:
        if r["split"] is not None and r["case"] is not None:
            key = (r["split"], r["case"])
            counts[key] = counts.get(key, 0) + 1
    per_case = [{"split": sp, "case": c, "frames_per_case": n}
                for (sp, c), n in sorted(counts.items())]
    summary = []
    for sp in sorted({r["split"] for r in rows if r["split"] is not None}):
        split_rows = [r for r in rows if r["split"] == sp]
        summary.append(_split_row(
            sp, split_rows, [p["frames_per_case"] for p in per_case
                             if p["split"] == sp]))
    summary.append(_split_row("overall", rows,
                              [p["frames_per_case"] for p in per_case]))
    return per_case, summary


def save_latex_table(summary: Sequence[Row], tex_path: Path) -> None:
    lines = [r"\begin{table}[t]", r"\centering",
             r"\caption{Dataset split statistics}",
             r"\begin{tabular}{l r r r r r r r r}", r"\toprule",
             r"Split & \#Cases & \#Frames & Pos & Neg & Pos (\%) & Neg (\%) & "
             r"Frames/Case mean & std \\", r"\midrule"]
    for r in summary:
        lines.append(
            f"{r['split']} & {int(r['cases'])} & {int(r['frames_total'])} & "
            f"{int(r['pos_frames'])} & {int(r['neg_frames'])} & "
            f"{r.get('pos_%', np.nan)} & {r.get('neg_%', np.nan)} & "
            f"{r['frames_per_case_mean']} & {r['frames_per_case_std']} \\\\")
    lines += [r"\bottomrule", r"\end{tabular}", r"\end{table}"]
    Path(tex_path).write_text("\n".join(lines))


def make_dataset_reports(rows: Sequence[Row], outdir: Path,
                         log=print) -> None:
    outdir = Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    per_case, summary = summarize(rows)
    write_csv(outdir / "per_case_stats.csv", PER_CASE_COLUMNS, per_case)
    write_csv(outdir / "split_stats.csv", SUMMARY_COLUMNS, summary)
    save_latex_table(summary, outdir / "latex_table_split_stats.tex")

    sub = [r for r in summary if r["split"] in ("train", "val", "test")]
    figures = ([outdir / "class_balance.png"] if sub else []) + \
        ([outdir / "frames_per_case_hist.png"] if per_case else [])
    plt = pyplot(figures) if figures else None
    if plt is not None and sub:
        x = np.arange(len(sub))
        w = 0.35
        fig, ax = plt.subplots(figsize=(5, 4))
        ax.bar(x - w / 2, column(sub, "pos_%"), w, label="Positive (%)")
        ax.bar(x + w / 2, column(sub, "neg_%"), w, label="Negative (%)")
        ax.set_xticks(x)
        ax.set_xticklabels([r["split"] for r in sub])
        ax.set_ylabel("Percentage of frames")
        ax.set_title("Class balance")
        ax.legend()
        fig.tight_layout()
        fig.savefig(outdir / "class_balance.png", dpi=300)
        plt.close(fig)

    if plt is not None and per_case:
        fig, ax = plt.subplots(figsize=(5, 4))
        for sp in sorted({p["split"] for p in per_case}):
            vals = [p["frames_per_case"] for p in per_case
                    if p["split"] == sp]
            ax.hist(vals, bins=20, alpha=0.5, label=f"{sp} (n={len(vals)})")
        ax.set_xlabel("Frames per case")
        ax.set_ylabel("Count")
        ax.set_title("Frames-per-case distribution")
        ax.legend()
        fig.tight_layout()
        fig.savefig(outdir / "frames_per_case_hist.png", dpi=300)
        plt.close(fig)
    log(f"dataset reports → {outdir}")


def attention_comparison(with_att_csv: Path, no_att_csv: Path, outdir: Path,
                         log=print) -> List[Row]:
    """Paired per-case comparison of two seg_eval.csv runs (w/ vs w/o
    attention) + ΔDice histogram; inner join on ``case`` in pandas' merge
    order (a case twice in ``no_att_csv`` raises ``ValueError``)."""
    outdir = Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    _, rows_w = read_csv(with_att_csv)
    _, rows_n = read_csv(no_att_csv)
    merged = []
    for i, j in inner_join([(r["case"],) for r in rows_w],
                           [(r["case"],) for r in rows_n]):
        m = {"case": rows_w[i]["case"]}
        m.update({f"{c}_with": rows_w[i][c] for c in ATT_COLUMNS})
        m.update({f"{c}_without": rows_n[j][c] for c in ATT_COLUMNS})
        for stem, c in (("dice", "dice_new"), ("iou", "iou_new"),
                        ("hd95", "hd95_new_px")):
            m[f"delta_{stem}"] = m[f"{c}_with"] - m[f"{c}_without"]
        merged.append(m)
    cols = (("case",) + tuple(f"{c}_with" for c in ATT_COLUMNS)
            + tuple(f"{c}_without" for c in ATT_COLUMNS)
            + ("delta_dice", "delta_iou", "delta_hd95"))
    write_csv(outdir / "attention_comparison.csv", cols, merged)

    plt = pyplot([outdir / "dice_paired.png", outdir / "dice_delta_hist.png"])
    if plt is not None:
        x = np.arange(len(merged))
        without = column(merged, "dice_new_without")
        with_ = column(merged, "dice_new_with")
        fig, ax = plt.subplots(figsize=(10, 5))
        ax.scatter(x, without, label="w/o Attention", color="orange")
        ax.scatter(x, with_, label="w/ Attention", color="blue")
        for i in range(len(merged)):
            ax.plot([x[i], x[i]], [without[i], with_[i]], color="gray",
                    alpha=0.4)
        ax.set_xlabel("Case index")
        ax.set_ylabel("Dice")
        ax.set_title("Paired Dice comparison")
        ax.legend()
        fig.tight_layout()
        fig.savefig(outdir / "dice_paired.png", dpi=300)
        plt.close(fig)

        fig, ax = plt.subplots(figsize=(7, 5))
        ax.hist(column(merged, "delta_dice"), bins=20, color="skyblue",
                edgecolor="black")
        ax.set_xlabel("ΔDice (with − without)")
        ax.set_ylabel("Count")
        ax.set_title("ΔDice histogram")
        fig.tight_layout()
        fig.savefig(outdir / "dice_delta_hist.png", dpi=300)
        plt.close(fig)
    log(f"attention comparison → {outdir}")
    return merged


def seg_eval_summary(seg_eval_csv: Path, px2mm: float = 1.0,
                     log=print) -> List[Row]:
    """Overall stats table of a seg_eval.csv (``plot_from_seg_eval.py``, with
    the new/base columns read correctly — the reference swapped them)."""
    from scipy.stats import wilcoxon

    _, df = read_csv(seg_eval_csv)
    unit = "mm" if px2mm != 1.0 else "px"

    def summ(new, base, hib):
        keep = ~(np.isnan(new) | np.isnan(base))
        new, base = new[keep], base[keep]
        if len(new) == 0:
            return dict(n=0)
        improve = (new > base).mean() * 100 if hib else (new < base).mean() * 100
        p = wilcoxon(new, base, alternative="two-sided").pvalue
        return dict(n=len(new), new_mean=new.mean(),
                    new_std=new.std(ddof=1), new_median=np.median(new),
                    base_mean=base.mean(), base_std=base.std(ddof=1),
                    base_median=np.median(base), improve_pct=improve,
                    wilcoxon_p=float(p))

    rows = [
        {"metric": "dice", **summ(column(df, "dice_new"),
                                  column(df, "dice_base"), True)},
        {"metric": "iou", **summ(column(df, "iou_new"),
                                 column(df, "iou_base"), True)},
        {"metric": f"hd95({unit})",
         **summ(column(df, "hd95_new_px") * px2mm,
                column(df, "hd95_base_px") * px2mm, False)},
    ]
    # the columns in the order of their first appearance, as a frame built
    # from these records orders them
    cols = list(dict.fromkeys(k for r in rows for k in r))
    stats_path = Path(seg_eval_csv).parent / "seg_stats.csv"
    write_csv(stats_path, cols, rows)
    log(f"seg stats → {stats_path}")
    return rows
