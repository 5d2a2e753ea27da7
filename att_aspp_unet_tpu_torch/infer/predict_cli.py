"""Standalone prediction over a directory of ``.mha`` sweeps.

Counterpart of the ``.mha`` branch of
``att_aspp_unet_tpu/infer/predict_cli.py::predict_directory``: per sweep the
best frame, its refined mask and the AC in mm (spacing from the volume
header), written as ``<case>/images/fetal-abdomen-segmentation/output.mha``
plus the frame JSON, and ``ac_results.csv`` (case_id, frame_idx, ac_mm) over
the directory.  One case or group stays in flight while the previous one's
host tail runs, the next file is decoded on a worker thread meanwhile, and
with ``bulk_group`` consecutive same-shape cases are served as one bulk
cascade.  PNG inputs and the diagnostic outputs are not ported yet.
"""

from __future__ import annotations

import csv
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..io import read_json, read_mha
from .engine import AttAsppEngine
from .outputs import write_output_mha_and_json

# Share of the card's free memory, read at the first group, that the buffers
# of one bulk group may take.  The cascade holds about two f32 copies of a
# group (the native stack as f32 for the scout's resize, and its low-
# resolution copies and probabilities) beside the model's activations.
BULK_FREE_MEMORY_SHARE = 0.5


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


def bulk_budget_bytes(device: torch.device) -> float:
    """Bytes the buffers of one bulk group may take on ``device``: a share
    of the card's free memory; on the CPU the group size is the caller's."""
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        return BULK_FREE_MEMORY_SHARE * free
    return float("inf")


def predict_directory(cfg: Config, variables: Optional[dict], input_dir: Path,
                      out_dir: Path, spacing_json: Optional[Path] = None,
                      threshold: Optional[float] = None, bulk_group: int = 0,
                      read_ahead: bool = True, device="cuda", log=print,
                      engine: Optional[AttAsppEngine] = None
                      ) -> List[Tuple[str, int, float]]:
    """Predict every ``.mha`` sweep in ``input_dir`` (sorted by name) into
    ``out_dir``; returns the (case, frame, AC mm) rows.  ``spacing_json``
    only applies to PNG inputs, which this port does not read yet; ``.mha``
    spacing comes from the header.  ``engine`` serves with an engine that
    exists already (its configuration and device then hold) instead of
    building one from ``variables``.

    ``bulk_group`` > 1 groups up to that many consecutive same-shape cases
    into one :meth:`AttAsppEngine.predict_bulk_submit` (requires cascade
    mode).  The files written and the rows equal the per-case run's, in the
    same order; a shape change or a non-``.mha`` entry closes the current
    group early, and a group of one goes through the single-case path."""
    if engine is not None:
        cfg = engine.cfg
    if bulk_group > 1 and not cfg.predict.cascade:
        raise ValueError("--bulk grouping requires cascade serving "
                         "(pass --cascade)")
    if engine is None:
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

    # One FIFO holds whatever is in flight, single cases and groups alike,
    # so rows and ac_results.csv come out in submission order.
    pending: List[tuple] = []   # ("case", [(stem, img, sp)], handle)
    #                           | ("group", [(stem, img, sp), ...], handle)

    def finish(stem, img, sp, best, best_mask):
        ac = round(engine.measure(best_mask, sp), 1)
        write_output_mha_and_json(out_dir, stem, best_mask, best, img)
        rows.append((stem, int(best), ac))
        log(f"{stem}: best_frame={best}, AC={ac:.1f} mm")

    def drain(keep: int = 0):
        while len(pending) > keep:
            kind, metas, handle = pending.pop(0)
            results = ([engine.predict_case_collect(handle)] if kind == "case"
                       else engine.predict_bulk_collect(handle))
            for (stem, img, sp), (best, best_mask, _) in zip(metas, results):
                finish(stem, img, sp, best, best_mask)

    def submit_case(stem, img, vol, sp):
        handle = engine.predict_case_submit(vol, thr)
        pending.append(("case", [(stem, img, sp)], handle))
        drain(keep=1)

    buf: List[tuple] = []       # (stem, img, vol, (sx, sy)) of the open group
    budget: List[float] = []    # the device budget, asked once

    def submit_group():
        """Dispatch the open group, split so that no part's buffers (two f32
        copies of its sweeps) pass the device budget."""
        nonlocal buf
        if not buf:
            return
        if not budget:
            budget.append(bulk_budget_bytes(engine.device))
        per_case = 2 * 4 * buf[0][2].size
        cap = int(max(1, min(len(buf), budget[0] // per_case)))
        if cap < len(buf):
            log(f"bulk group capped at {cap} case(s) "
                f"(~{per_case / 1e9:.2f} GB of device buffers each, "
                f"{budget[0] / 1e9:.1f} GB budget); splitting the group")
        while buf:
            chunk, buf = buf[:cap], buf[cap:]
            if len(chunk) == 1:
                submit_case(*chunk[0])
                continue
            metas = [(s, i, sp) for s, i, _, sp in chunk]
            group = np.stack([v for _, _, v, _ in chunk])
            pending.append(("group", metas,
                            engine.predict_bulk_submit(group, thr)))
            drain(keep=1)

    def flush_all():
        submit_group()
        drain(keep=0)

    paths = sorted(Path(input_dir).iterdir())

    def load(p):
        return read_mha(p) if p.suffix.lower() == ".mha" else None

    # Depth-1 read-ahead: decode file i+1 on a worker thread (zlib and numpy
    # release the GIL) while case i is uploaded, served and written.  The
    # worker does no torch work.
    prefetch = ThreadPoolExecutor(max_workers=1)
    fut = prefetch.submit(load, paths[0]) if paths and read_ahead else None
    try:
        for i, p in enumerate(paths):
            img = fut.result() if fut is not None else load(p)
            fut = (prefetch.submit(load, paths[i + 1])
                   if read_ahead and i + 1 < len(paths) else None)
            if img is None:
                flush_all()
                if p.suffix.lower() in {".png", ".jpg", ".jpeg"}:
                    log(f"{p.name}: PNG inputs are not supported by this "
                        "port yet; skipped")
                continue
            vol = img.array
            sp = (float(img.spacing[0]), float(img.spacing[1]))
            if bulk_group > 1:
                if buf and buf[0][2].shape != vol.shape:
                    submit_group()
                buf.append((p.stem, img, vol, sp))
                if len(buf) >= bulk_group:
                    submit_group()
            else:
                submit_case(p.stem, img, vol, sp)
    finally:
        prefetch.shutdown(wait=False)
    flush_all()

    if rows:
        csv_path = out_dir / "ac_results.csv"
        with open(csv_path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["case_id", "frame_idx", "ac_mm"])
            w.writerows(rows)
        log(f"AC saved → {csv_path} ({len(rows)})")
    return rows
