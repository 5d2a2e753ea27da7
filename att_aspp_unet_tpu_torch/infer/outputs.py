"""Output writer of the standalone predict CLI (the JAX package's
``infer/outputs.py::write_output_mha_and_json``): per case
``<out>/<case>/images/fetal-abdomen-segmentation/output.mha`` holding the
mask relabeled 1 -> 2 on the chosen frame (geometry copied from the input,
uncompressed) and ``<out>/<case>/fetal-abdomen-frame-number.json``."""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..io import MetaImage, write_json, write_mha


def write_output_mha_and_json(out_dir: Path, case: str, mask_2d: np.ndarray,
                              frame_number: int, reference: MetaImage,
                              label: int = 2) -> Path:
    case_dir = Path(out_dir) / case
    n_frames = reference.size[2] if len(reference.size) >= 3 else 1
    m2 = np.where(np.squeeze(np.asarray(mask_2d)) > 0, label, 0).astype(np.uint8)
    vol = np.zeros((n_frames, *m2.shape), np.uint8)
    if frame_number == -1:
        pass
    elif frame_number is not None and 0 <= frame_number < n_frames:
        vol[frame_number] = m2
    else:
        raise ValueError(f"frame_number must be between -1 and "
                         f"{n_frames - 1}, got {frame_number}.")
    img = MetaImage(vol, spacing=(0.28, 0.28, 0.28))
    img.copy_information(reference)
    seg_dir = case_dir / "images/fetal-abdomen-segmentation"
    seg_dir.mkdir(parents=True, exist_ok=True)
    out = seg_dir / "output.mha"
    write_mha(out, img, compressed=False)
    write_json(case_dir / "fetal-abdomen-frame-number.json", int(frame_number),
               indent=2)
    return out
