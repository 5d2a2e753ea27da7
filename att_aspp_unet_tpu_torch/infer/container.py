"""Grand-Challenge container entry point (the JAX package's
``infer/container.py``).

- input:  ``<input>/images/stacked-fetal-ultrasound/*.mha|*.tiff`` (one case)
- env:    ``MODEL_TAG`` (a tag of ``infer/models.py``'s table);
          ``CASE_ID`` names the output volume
- output: ``<output>/images/fetal-abdomen-segmentation/<case>.mha`` and
          ``<output>/fetal-abdomen-frame-number.json``
- a labeled network (the default ``baseline``): sliding-window tiles at
  native resolution, the 3-D largest component of each class, and the
  reference's class-1-then-class-2 frame ladder; ``att_aspp``: the ROI path
  on 128 subsampled frames, with the model variant of ``cfg.model``;
- the selected-frame mask is nearest-neighbour resized back to the native
  (H, W) before writing; optionally the probability stack is dumped and three
  debug frames are written as PNGs.
"""

from __future__ import annotations

from glob import glob
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..io import read_volume, write_gray_png, write_json
from ..preprocess import enhance_frames
from .engine import resize_mask_to, select_mask_and_frame
from .models import build_engine, entry_config
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
    """Process the single case in ``cfg.container.input_path`` with the
    model ``variables`` of ``cfg.container.model_tag`` (as
    ``infer.models.build_engine`` takes it)."""
    ccfg = cfg.container
    serving = build_engine(ccfg.model_tag, cfg, variables, device)
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

    if debug_frames:
        _dump_debug_frames(cfg, sweep, output_path / "images", serving.device)

    # the probability stack, its postprocess and the frame pick stay on the
    # device; only the selected mask (and, when dumping, the stack) crosses
    # to the host
    probs = serving.predict(sweep)
    if save_probabilities:
        # relative to the working directory, as the reference does
        prob_dir = Path("output/probabilities")
        prob_dir.mkdir(parents=True, exist_ok=True)
        np.save(prob_dir / f"{sweep_path.stem}_prob.npy", probs.cpu().numpy())
    masks = serving.postprocess(probs)
    if serving.labeled:
        mask2d, frame = select_labeled_mask_and_frame(masks)
    else:
        mask2d, sub_frame = select_mask_and_frame(masks)
        if sub_frame >= 0:
            # map the subsampled index back to the original frame axis
            idxs = np.linspace(0, n_frames - 1,
                               min(cfg.predict.subsample_frames, n_frames)
                               ).astype(int)
            frame = int(idxs[sub_frame])
        else:
            frame = -1
    del probs, masks

    mask2d = resize_mask_to(mask2d, (ref_h, ref_w))
    write_segmentation_output(
        output_path / "images/fetal-abdomen-segmentation", mask2d, frame,
        n_frames, filename=f"{case_id}.mha", spacing=(ccfg.spacing_mm,) * 3)
    write_json(output_path / "fetal-abdomen-frame-number.json", frame)
    log(f"frame number: {frame}")
    return 0


def run_from_env(cfg: Config, variables, **kw) -> int:
    """:func:`run` with ``MODEL_TAG`` and ``CASE_ID`` of the environment
    overriding the configuration's ``model_tag`` and ``case_id``."""
    return run(entry_config(cfg), variables, **kw)
