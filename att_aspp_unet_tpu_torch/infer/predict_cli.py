"""Standalone prediction over a directory of PNG / JPG frames and ``.mha``
sweeps (counterpart of ``att_aspp_unet_tpu/infer/predict_cli.py``).

- PNG / JPG: one frame through ``predict_full``, refined, written as
  ``<stem>_mask.png``; AC from a ``--spacing_json`` map keyed by the case id
  (the stem up to ``_s<frame>``); with ``viz_att`` a 2x4 attention panel.
- ``.mha``: per sweep the best frame, its refined mask and the AC in mm
  (spacing from the volume header), written as
  ``<case>/images/fetal-abdomen-segmentation/output.mha`` plus the frame
  JSON.  One case or group stays in flight while the previous one's host
  tail runs, the next file is decoded on a worker thread meanwhile, and with
  ``bulk_group`` consecutive same-shape cases are served as one bulk
  cascade.  With ``slice_metrics`` / ``topk_viz`` a sweep instead refines
  every frame and writes the per-slice CSV and the top-K sheet.
- ``ac_results.csv`` (case_id, frame_idx, ac_mm) over the directory.
"""

from __future__ import annotations

import csv
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..io import read_gray_png, read_json, read_mha, write_gray_png
from ..ops.image import minmax_normalize_u8
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


def spacing_from_map(spacing_map: Dict, case_id: str
                     ) -> Optional[Tuple[float, float]]:
    """(sx, sy) of ``case_id`` from a spacing map whose values are
    ``{"spacing": [sx, sy, ...]}`` or ``[sx, sy, ...]``; None if absent."""
    if case_id not in spacing_map:
        return None
    v = spacing_map[case_id]
    if isinstance(v, dict) and "spacing" in v:
        sx, sy = v["spacing"][:2]
    elif isinstance(v, (list, tuple)) and len(v) >= 2:
        sx, sy = v[:2]
    else:
        return None
    return float(sx), float(sy)


def split_case_frame(stem: str) -> Tuple[str, int]:
    """``<case>_s<frame>`` naming -> (case, frame); other stems -> (stem, -1)
    (a non-integer frame part gives (case, -1))."""
    if "_s" in stem:
        case = stem.split("_s")[0]
        try:
            return case, int(stem.split("_s")[1])
        except ValueError:
            return case, -1
    return stem, -1


def bulk_budget_bytes(device: torch.device) -> float:
    """Bytes the buffers of one bulk group may take on ``device``: a share
    of the card's free memory; on the CPU the group size is the caller's."""
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        return BULK_FREE_MEMORY_SHARE * free
    return float("inf")


def predict_directory(cfg: Config, variables: Optional[dict], input_dir: Path,
                      out_dir: Path, spacing_json: Optional[Path] = None,
                      threshold: Optional[float] = None,
                      slice_metrics: bool = False, topk_viz: bool = False,
                      viz_att: bool = False,
                      noatt: Optional[Tuple[Config, dict]] = None,
                      bulk_group: int = 0, read_ahead: bool = True,
                      device="cuda", log=print,
                      engine: Optional[AttAsppEngine] = None
                      ) -> List[Tuple[str, int, float]]:
    """Predict every PNG / JPG frame and ``.mha`` sweep in ``input_dir``
    (sorted by name) into ``out_dir``; returns the (case, frame, AC mm) rows.
    ``spacing_json`` maps case ids to the spacing of PNG inputs; ``.mha``
    spacing comes from the header.  ``engine`` serves with an engine that
    exists already (its configuration and device then hold) instead of
    building one from ``variables``.

    ``slice_metrics`` / ``topk_viz``: each sweep refines every frame and
    writes ``<case>_slices.csv`` (area and circularity per slice) and
    ``<case>_topk.png`` (the top-K candidate sheet).  ``viz_att``: each PNG
    gets a 2x4 panel in ``<out>/panels``: raw, probability, mean psi and mask
    of this model on top, the same of the no-attention model ``noatt`` =
    (config, variables) below (zeros without it).

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
    noatt_engine = (AttAsppEngine(*noatt, device=engine.device)
                    if noatt is not None else None)
    diagnostics = slice_metrics or topk_viz
    thr = threshold if threshold is not None else load_threshold(cfg, log=log)
    spacing_map: Dict = {}
    if spacing_json:
        try:
            spacing_map = read_json(spacing_json)
            log(f"loaded spacing map ({len(spacing_map)})")
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

    def predict_frame(p):
        sl = read_gray_png(p)
        probs = engine.predict_full(sl[None])
        mask = engine.refine(probs, thr).cpu().numpy()[0]
        write_gray_png(out_dir / f"{p.stem}_mask.png", mask * 255)
        if viz_att:
            save_panel(p.stem, sl, probs.cpu().numpy()[0], mask)
        case_id, frame_idx = split_case_frame(p.stem)
        sp = spacing_from_map(spacing_map, case_id)
        if sp is None:
            log(f"no spacing for {case_id}, skip AC")
        else:
            ac = round(engine.measure(mask, sp), 1)
            rows.append((case_id, frame_idx, ac))
            log(f"{p.stem}: AC={ac:.1f} mm")

    def save_panel(stem, sl, prob_att, mask):
        from ..evals.panels import save_attention_panel

        raw_u8 = minmax_normalize_u8(torch.from_numpy(sl[None])).numpy()[0]
        # psi exists only for gated models; the panel cell is zero without
        psi = (engine.psi_sweep(sl[None])[0] if cfg.model.use_att
               else np.zeros_like(prob_att))
        if noatt_engine is not None:
            prob_na = noatt_engine.predict_full(sl[None])
            mask_na = noatt_engine.refine(prob_na, thr).cpu().numpy()[0]
            prob_na = prob_na.cpu().numpy()[0]
        else:
            prob_na, mask_na = np.zeros_like(prob_att), np.zeros_like(mask)
        save_attention_panel(stem, raw_u8, prob_att, psi, mask * 255,
                             prob_na, mask_na * 255, out_dir / "panels")

    def predict_diagnostics(stem, img, vol, sp):
        """Every frame refined, the exact selection, the per-slice CSV and
        the top-K sheet."""
        probs = engine.predict_full(vol)
        masks = engine.refine(probs, thr).cpu().numpy()
        best = engine.select_best(masks)
        finish(stem, img, sp, best, masks[best])
        ac = rows[-1][2]
        if slice_metrics:
            from ..evals.panels import write_slice_metrics_csv
            write_slice_metrics_csv(masks, out_dir / f"{stem}_slices.csv",
                                    stem)
        if topk_viz:
            from ..evals.panels import save_topk_candidates

            areas = (masks > 0).sum(axis=(1, 2))
            k = max(1, min(cfg.predict.topk_frames, len(masks)))
            topk_idx = np.argsort(areas)[::-1][:k].tolist()
            imgs_u8 = minmax_normalize_u8(torch.from_numpy(vol)).numpy()
            save_topk_candidates(imgs_u8, probs.cpu().numpy(), masks,
                                 topk_idx, best, ac,
                                 out_dir / f"{stem}_topk.png")

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
            if img is None or diagnostics:
                flush_all()
            if img is None:
                if p.suffix.lower() in {".png", ".jpg", ".jpeg"}:
                    predict_frame(p)
                continue
            vol = img.array
            sp = (float(img.spacing[0]), float(img.spacing[1]))
            if diagnostics:
                predict_diagnostics(p.stem, img, vol, sp)
            elif bulk_group > 1:
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
