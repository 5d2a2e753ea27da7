"""Standalone prediction over a directory of ``.mha`` sweeps.

Counterpart of the direct ``.mha`` branch of
``att_aspp_unet_tpu/infer/predict_cli.py::predict_directory``: per sweep the
best frame, its refined mask and the AC in mm (spacing from the volume
header), written as ``<case>/images/fetal-abdomen-segmentation/output.mha``
plus the frame JSON, and ``ac_results.csv`` (case_id, frame_idx, ac_mm) over
the directory.  PNG inputs and the diagnostic outputs are not ported yet.
"""

from __future__ import annotations

import csv
from pathlib import Path
from typing import List, Optional, Tuple

from ..config import Config
from ..io import read_json, read_mha
from .engine import AttAsppEngine
from .outputs import write_output_mha_and_json


def load_threshold(cfg: Config, thr_path: Path = Path("./checkpoints/thr.json"),
                   log=print) -> float:
    """``best_thr`` from thr.json if it exists and parses, else the
    configured threshold (the reference's silent fallback)."""
    if Path(thr_path).exists():
        try:
            thr = float(read_json(thr_path)["best_thr"])
        except (ValueError, KeyError, TypeError):
            return cfg.predict.threshold
        log(f"use thr {thr:.3f}")
        return thr
    return cfg.predict.threshold


def predict_directory(cfg: Config, variables: Optional[dict], input_dir: Path,
                      out_dir: Path, spacing_json: Optional[Path] = None,
                      threshold: Optional[float] = None, device="cuda",
                      log=print) -> List[Tuple[str, int, float]]:
    """Predict every ``.mha`` sweep in ``input_dir`` (sorted by name) into
    ``out_dir``; returns the (case, frame, AC mm) rows.  ``spacing_json``
    only applies to PNG inputs, which this port does not read yet; ``.mha``
    spacing comes from the header."""
    engine = AttAsppEngine(cfg, variables, device=device)
    thr = threshold if threshold is not None else load_threshold(cfg, log=log)
    if spacing_json:
        try:
            log(f"loaded spacing map ({len(read_json(spacing_json))})")
        except (OSError, ValueError) as e:
            log(f"cannot load spacing_json: {e}")

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    rows: List[Tuple[str, int, float]] = []
    for p in sorted(Path(input_dir).iterdir()):
        if p.suffix.lower() != ".mha":
            if p.suffix.lower() in {".png", ".jpg", ".jpeg"}:
                log(f"{p.name}: PNG inputs are not supported by this port "
                    "yet; skipped")
            continue
        img = read_mha(p)
        sx, sy = float(img.spacing[0]), float(img.spacing[1])
        best, best_mask, ac = engine.predict_case(img.array, (sx, sy), thr)
        ac = round(ac, 1)
        write_output_mha_and_json(out_dir, p.stem, best_mask, best, img)
        rows.append((p.stem, int(best), ac))
        log(f"{p.stem}: best_frame={best}, AC={ac:.1f} mm")

    if rows:
        csv_path = out_dir / "ac_results.csv"
        with open(csv_path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["case_id", "frame_idx", "ac_mm"])
            w.writerows(rows)
        log(f"AC saved → {csv_path} ({len(rows)})")
    return rows
