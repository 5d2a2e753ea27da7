"""Grand-Challenge container entry point (the JAX package's
``infer/container.py``).

- input:  ``<input>/images/stacked-fetal-ultrasound/*.mha|*.tiff`` (one case)
- env:    ``MODEL_TAG`` = ``baseline`` | ``att_aspp``; ``CASE_ID`` names the
          output volume
- output: ``<output>/images/fetal-abdomen-segmentation/<case>.mha`` and
          ``<output>/fetal-abdomen-frame-number.json``
- ``baseline`` (the default): the nnU-Net-style PlainConvUNet over
  sliding-window tiles at native resolution, the 3-D largest component of
  each class, and the reference's class-1-then-class-2 frame ladder;
  ``att_aspp``: the ROI path on 128 subsampled frames, with the model
  variant of ``cfg.model`` (the CLI's model flags; weights from a flat
  ``.npz`` or a reference ``.pt``);
- the selected-frame mask is nearest-neighbour resized back to the native
  (H, W) before writing; optionally the probability stack is dumped and three
  debug frames are written as PNGs.
"""

from __future__ import annotations

import dataclasses
import os
from glob import glob
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..io import read_volume, write_gray_png, write_json
from ..preprocess import enhance_frames
from .engine import (AttAsppEngine, BaselineEngine, resize_mask_to,
                     select_mask_and_frame)
from .outputs import write_segmentation_output


def get_image_file_path(location: Path):
    return glob(str(Path(location) / "*.tiff")) + \
        glob(str(Path(location) / "*.mha"))


def select_labeled_mask_and_frame(seg) -> Tuple[np.ndarray, int]:
    """Class-aware max-area frame pick of the baseline path, the reference's
    sequential if/elif ladder: per frame, the class-1 area is checked first
    and wins the frame if it beats the running best, even when class 2 of
    the same frame is larger; class 2 is consulted only otherwise.  The
    winning frame's labels are binarised; an all-empty stack gives
    (zeros, -1).  Only the per-frame areas and the chosen frame cross to the
    host."""
    seg = torch.as_tensor(seg)
    areas = torch.stack([(seg == lab).sum(dim=(1, 2)) for lab in (1, 2)])
    a1, a2 = areas.cpu().numpy()
    largest, frame = 0, -1
    for f in range(seg.shape[0]):
        if a1[f] > largest:
            largest, frame = int(a1[f]), f
        elif a2[f] > largest:
            largest, frame = int(a2[f]), f
    if frame < 0:
        return np.zeros(tuple(seg.shape[1:]), np.uint8), -1
    return (seg[frame] > 0).to(torch.uint8).cpu().numpy(), frame


def _dump_debug_frames(cfg: Config, sweep: np.ndarray, dump_dir: Path,
                       device) -> None:
    """First, middle and last frame as min-max-normalised and as enhanced
    PNGs (needs PIL)."""
    p = cfg.preprocess
    n_frames = sweep.shape[0]
    picks = sorted({0, n_frames // 2, n_frames - 1})
    with torch.no_grad():
        enhanced = enhance_frames(
            torch.as_tensor(sweep[picks]).to(device), p.clahe_clip,
            p.clahe_grid, p.median_kernel).cpu().numpy()
    for i, enh in zip(picks, enhanced):
        lo, hi = sweep[i].min(), sweep[i].max()
        orig = np.zeros_like(sweep[i], np.uint8) if hi <= lo else np.clip(
            np.round((sweep[i].astype(np.float64) - lo) * 255.0 / (hi - lo)),
            0, 255).astype(np.uint8)
        write_gray_png(dump_dir / f"frame{i:03d}_orig.png", orig)
        write_gray_png(dump_dir / f"frame{i:03d}_enh.png", enh)


def run(cfg: Config, variables, case_id: Optional[str] = None,
        save_probabilities: bool = True, debug_frames: bool = True,
        device="cuda", log=print) -> int:
    """Process the single case in ``cfg.container.input_path``.
    ``variables``: the JAX package's variables tree as numpy for either
    model, or the port's ``PlainConvUNet`` for ``baseline``."""
    ccfg = cfg.container
    if ccfg.model_tag not in ("baseline", "att_aspp"):
        raise ValueError(f"MODEL_TAG={ccfg.model_tag!r}: expected 'baseline' "
                         "or 'att_aspp'")
    input_path = Path(ccfg.input_path)
    output_path = Path(ccfg.output_path)
    case_id = case_id or ccfg.case_id

    files = get_image_file_path(input_path / "images/stacked-fetal-ultrasound")
    if not files:
        raise FileNotFoundError(
            f"no sweep under {input_path}/images/stacked-fetal-ultrasound")
    sweep_path = Path(files[0])
    log(f"predicting on {sweep_path}")

    img = read_volume(sweep_path, default_spacing=ccfg.spacing_mm)
    sweep = img.array
    if sweep.ndim != 3:
        raise ValueError(f"expected 3-D sweep, got {sweep.shape}")
    n_frames, ref_h, ref_w = sweep.shape

    baseline = ccfg.model_tag == "baseline"
    engine = (BaselineEngine if baseline else AttAsppEngine)(
        cfg, variables, device=device)
    if debug_frames:
        _dump_debug_frames(cfg, sweep, output_path / "images", engine.device)

    # the probability stack, its postprocess and the frame pick stay on the
    # device; only the selected mask (and, when dumping, the stack) crosses
    # to the host
    probs = engine.predict(sweep) if baseline else engine.predict_roi(sweep)
    if save_probabilities:
        # relative to the working directory, as the reference does
        prob_dir = Path("output/probabilities")
        prob_dir.mkdir(parents=True, exist_ok=True)
        np.save(prob_dir / f"{sweep_path.stem}_prob.npy", probs.cpu().numpy())
    if baseline:
        mask2d, frame = select_labeled_mask_and_frame(
            engine.postprocess(probs))
    else:
        mask2d, sub_frame = select_mask_and_frame(engine.postprocess_roi(probs))
        if sub_frame >= 0:
            # map the subsampled index back to the original frame axis
            idxs = np.linspace(0, n_frames - 1,
                               min(cfg.predict.subsample_frames, n_frames)
                               ).astype(int)
            frame = int(idxs[sub_frame])
        else:
            frame = -1
    del probs

    mask2d = resize_mask_to(mask2d, (ref_h, ref_w))
    write_segmentation_output(
        output_path / "images/fetal-abdomen-segmentation", mask2d, frame,
        n_frames, filename=f"{case_id}.mha", spacing=(ccfg.spacing_mm,) * 3)
    write_json(output_path / "fetal-abdomen-frame-number.json", frame)
    log(f"frame number: {frame}")
    return 0


def run_from_env(cfg: Config, variables: dict, **kw) -> int:
    """:func:`run` with ``MODEL_TAG`` and ``CASE_ID`` of the environment
    overriding the configuration's ``model_tag`` and ``case_id``."""
    ccfg = dataclasses.replace(
        cfg.container,
        model_tag=os.getenv("MODEL_TAG", cfg.container.model_tag),
        case_id=os.getenv("CASE_ID", cfg.container.case_id))
    return run(dataclasses.replace(cfg, container=ccfg), variables,
               case_id=ccfg.case_id, **kw)
