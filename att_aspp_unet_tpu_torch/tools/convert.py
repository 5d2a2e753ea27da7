"""Dataset conversion: slice 3-D .mha volumes into per-frame PNG image/mask
pairs with negative-frame sampling (a copy of the JAX package's
``tools/convert.py``; the same seed draws the same frames).

Covers the capabilities of the reference's ``convert_to_png.py`` (which, note,
does not parse as shipped — ``required=True")`` syntax errors at :182-183):
percentile-windowed u8 export, top-K largest-mask positive frames with
optional neighbour padding, negative sampling (all / random / stride with
per-case and global caps), an area threshold in mm² or px, and the two
output contracts downstream tooling reads: ``masks/frame_indices.json``
(per-case pos/neg indices, frame records, threshold + spacing metadata) and
``mapping.csv`` (case_id, frame_idx rows).

The design here is selection-as-data: each export policy is a frozen rule
object, frame selection is a pure vectorised function of the per-frame area
profile, and PNG/JSON/CSV emission is separated from planning — so the
selection logic is unit-testable without touching the filesystem.
"""

from __future__ import annotations

import csv
import dataclasses
import json
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from ..io import read_mha, write_gray_png


# ------------------------------------------------------------ policies

@dataclasses.dataclass(frozen=True)
class PositiveRule:
    """Which annotated frames to export."""

    topk: int = 3                          # largest-mask frames per case
    neighbor_pad: int = 0                  # also take ±pad neighbours
    min_area_mm2: Optional[float] = 80.0   # area floor in mm² (needs spacing)
    min_area_px: int = 100                 # area floor in px (always applies)


@dataclasses.dataclass(frozen=True)
class NegativeRule:
    """How to sample unannotated frames."""

    strategy: str = "random"               # all | random | stride
    ratio: float = 0.0                     # negatives per positive (random)
    per_case_cap: int = 5
    stride: int = 5
    total_cap: int = 0                     # global cap over all cases; 0 = ∞

    def __post_init__(self):
        if self.strategy not in ("all", "random", "stride"):
            raise ValueError(f"unknown negative strategy {self.strategy!r}")


# ------------------------------------------------------------ pure helpers

def window_to_u8(frame: np.ndarray, lo_pct: float = 1.0,
                 hi_pct: float = 99.0) -> np.ndarray:
    """Percentile-windowed rescale to uint8 (robust to ultrasound speckle)."""
    f = frame.astype(np.float32)
    lo, hi = np.percentile(f, (lo_pct, hi_pct))
    if hi - lo < 1e-5:
        return np.zeros(f.shape, np.uint8)
    f = (np.clip(f, lo, hi) - lo) / (hi - lo + 1e-5)
    return np.rint(f * 255).astype(np.uint8)


def area_threshold_px(rule: PositiveRule,
                      spacing_xy: Optional[Tuple[float, float]]) -> int:
    """Pixel-area floor: the px floor, raised to the mm² floor when in-plane
    spacing is known."""
    floor = max(1, int(rule.min_area_px))
    if rule.min_area_mm2 and spacing_xy:
        mm2_per_px = spacing_xy[0] * spacing_xy[1]
        floor = max(floor, int(np.ceil(rule.min_area_mm2 / mm2_per_px)))
    return floor


def select_positive_frames(areas_px: np.ndarray, thr_px: int,
                           rule: PositiveRule) -> np.ndarray:
    """Indices of the top-K frames by mask area (≥ threshold), optionally
    widened by ±neighbor_pad — neighbours below threshold are dropped."""
    eligible = areas_px >= thr_px
    if rule.topk <= 0 or not eligible.any():
        return np.empty(0, int)
    ranked = np.argsort(np.where(eligible, areas_px, -1))[::-1]
    chosen = ranked[: min(rule.topk, int(eligible.sum()))]
    if rule.neighbor_pad > 0:
        widened = chosen[:, None] + np.arange(-rule.neighbor_pad,
                                              rule.neighbor_pad + 1)
        widened = widened[(widened >= 0) & (widened < len(areas_px))]
        chosen = np.concatenate([chosen, widened])
        chosen = chosen[eligible[chosen]]
    return np.unique(chosen)


def select_negative_frames(candidates: np.ndarray, n_positive: int,
                           rule: NegativeRule, rng: np.random.Generator,
                           global_budget: Optional[int] = None,
                           take_all: bool = False) -> np.ndarray:
    """Sample negative frame indices from ``candidates`` under the rule.

    ``take_all`` mirrors the reference behaviour for neg-only exports and
    for cases without positives: the whole candidate pool is eligible
    (subject only to the global budget).
    """
    if candidates.size == 0:
        return candidates
    if rule.strategy == "all" or take_all:
        picked = candidates
    elif rule.strategy == "random":
        want = int(min(np.ceil(rule.ratio * n_positive), rule.per_case_cap))
        if want <= 0:
            return np.empty(0, int)
        picked = rng.choice(candidates, min(want, candidates.size),
                            replace=False)
    else:  # stride
        picked = candidates[:: max(1, rule.stride)][: rule.per_case_cap]
    if global_budget is not None:
        if global_budget <= 0:
            return np.empty(0, int)
        if picked.size > global_budget:
            picked = rng.choice(picked, global_budget, replace=False)
    return picked


def _spacing_xy(*images) -> Optional[Tuple[float, float]]:
    for im in images:
        try:
            sx, sy = float(im.spacing[0]), float(im.spacing[1])
            if sx > 0 and sy > 0:
                return sx, sy
        except Exception:
            continue
    return None


# ------------------------------------------------------------ emission

def _emit_frames(case: str, img3d: np.ndarray, msk3d: np.ndarray,
                 picks: Iterable[Tuple[int, str]], img_dir: Path,
                 msk_dir: Path) -> List[dict]:
    """Write PNG pairs for (index, class) picks; return the frame records
    that go into frame_indices.json."""
    records = []
    for idx, cls in picks:
        fname = f"{case}_s{int(idx):03d}.png"
        write_gray_png(img_dir / fname, window_to_u8(img3d[idx]))
        mask_png = (((msk3d[idx] > 0) * 255).astype(np.uint8)
                    if cls == "pos" else
                    np.zeros(img3d[idx].shape, np.uint8))
        write_gray_png(msk_dir / fname, mask_png)
        records.append({"idx": int(idx), "cls": cls,
                        "img": f"images/{fname}", "mask": f"masks/{fname}"})
    return records


def _write_index(out_root: Path, msk_dir: Path, index: Dict[str, dict]) -> None:
    (msk_dir / "frame_indices.json").write_text(
        json.dumps(index, indent=2, ensure_ascii=False))
    with open(out_root / "mapping.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["case_id", "frame_idx"])
        w.writerows((case, rec["idx"])
                    for case in sorted(index)
                    for rec in index[case].get("frames", []))


# ------------------------------------------------------------ build

def build_png_dataset(mha_root, out_root,
                      positives: PositiveRule = PositiveRule(),
                      negatives: NegativeRule = NegativeRule(),
                      seed: int = 2025, export_neg_only: bool = False,
                      log=print) -> Dict[str, dict]:
    """Convert ``<mha_root>/{images,masks}/*.mha`` volume pairs into the
    per-frame PNG training layout under ``out_root``.

    Cases are visited in a seeded random order so a global negative cap is
    spread fairly across cases rather than consumed by the first few.
    Returns (and writes) the frame index.
    """
    mha_root, out_root = Path(mha_root), Path(out_root)
    img_dir, msk_dir = out_root / "images", out_root / "masks"
    img_dir.mkdir(parents=True, exist_ok=True)
    msk_dir.mkdir(parents=True, exist_ok=True)

    rng = np.random.default_rng(seed)
    cases = list(rng.permutation(sorted((mha_root / "images").glob("*.mha"))))

    index: Dict[str, dict] = {}
    budget = negatives.total_cap if negatives.total_cap > 0 else None

    for img_path in cases:
        case = Path(img_path).stem
        msk_path = mha_root / "masks" / f"{case}.mha"
        if not msk_path.exists():
            log(f"{case}: no mask, skipped")
            continue

        img, msk = read_mha(img_path), read_mha(msk_path)
        img3d, msk3d = img.array, msk.array
        spacing = _spacing_xy(img, msk) or (1.0, 1.0)
        thr_px = area_threshold_px(positives, spacing)
        areas = (msk3d > 0).reshape(msk3d.shape[0], -1).sum(axis=1)

        pos = (np.empty(0, int) if export_neg_only
               else select_positive_frames(areas, thr_px, positives))
        neg_candidates = np.flatnonzero(areas < thr_px)
        # "random" falls back to the whole pool for neg-only exports and for
        # cases without positives; "stride"/"all" behave uniformly
        neg = select_negative_frames(
            neg_candidates, pos.size, negatives, rng,
            global_budget=budget,
            take_all=(negatives.strategy == "random"
                      and (export_neg_only or pos.size == 0)))
        if budget is not None:
            budget -= neg.size

        records = _emit_frames(
            case, img3d, msk3d,
            [(i, "pos") for i in pos] + [(i, "neg") for i in neg],
            img_dir, msk_dir)
        if records:
            index[case] = {
                "pos": sorted(int(i) for i in pos),
                "neg": sorted(int(i) for i in neg),
                "frames": records,
                "_meta": {
                    "thr_px": int(thr_px),
                    "spacing_xy_mm": [float(spacing[0]), float(spacing[1])],
                    "min_area_mm2": (None if positives.min_area_mm2 is None
                                     else float(positives.min_area_mm2)),
                },
            }

    _write_index(out_root, msk_dir, index)
    return index


def convert_frames_with_negatives(
        mha_root, out_root, topk: int = 3, neighbor_pad: int = 0,
        min_area_mm2: Optional[float] = 80.0, min_area_px: int = 100,
        neg_strategy: str = "random", neg_ratio: float = 0.0,
        neg_cap: int = 5, neg_stride: int = 5, seed: int = 2025,
        export_neg_only: bool = False, neg_total_cap: int = 0,
        log=print) -> Dict[str, dict]:
    """Flat-kwargs adapter for the CLI (flag names match ``cli.py convert``)."""
    return build_png_dataset(
        mha_root, out_root,
        positives=PositiveRule(topk=topk, neighbor_pad=neighbor_pad,
                               min_area_mm2=min_area_mm2,
                               min_area_px=min_area_px),
        negatives=NegativeRule(strategy=neg_strategy, ratio=neg_ratio,
                               per_case_cap=neg_cap, stride=neg_stride,
                               total_cap=neg_total_cap),
        seed=seed, export_neg_only=export_neg_only, log=log)
