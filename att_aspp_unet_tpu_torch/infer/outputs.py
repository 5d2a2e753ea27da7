"""Writers of the two output contracts (the JAX package's
``infer/outputs.py``).

- Container: the mask is written binarised to uint8 {0, 1} on the chosen
  frame of an otherwise zero volume, isotropic 0.28 mm spacing,
  zlib-compressed, and the file is read back and compared after the write.
- Standalone predict CLI: per case
  ``<out>/<case>/images/fetal-abdomen-segmentation/output.mha`` holding the
  mask relabeled 1 -> 2 (geometry copied from the input, uncompressed, no
  read-back) and ``<out>/<case>/fetal-abdomen-frame-number.json``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from ..io import MetaImage, read_mha, write_json, write_mha


def _verify_written(path: Path, expected: np.ndarray) -> None:
    """Read the written file back and hold it against what was written."""
    arr = np.asarray(read_mha(path).array)
    assert arr.shape == expected.shape, (
        f"read-back shape {arr.shape} != written {expected.shape}")
    assert arr.dtype == np.uint8, f"read-back dtype {arr.dtype} != uint8"
    assert np.array_equal(arr, expected), "read-back voxels differ from written"


def write_segmentation_output(location: Path, mask_2d: np.ndarray,
                              frame_number: int, number_of_frames: int,
                              filename: str = "output.mha",
                              spacing: Tuple[float, float, float] = (0.28, 0.28, 0.28),
                              reference: Optional[MetaImage] = None,
                              binarize: bool = True, compressed: bool = True,
                              verify: bool = True) -> Path:
    """Write a segmentation ``.mha``: the 2-D mask on frame ``frame_number``
    of a zero (number_of_frames, H, W) uint8 volume; -1 writes all zeros, any
    other frame outside the volume is an error.

    ``binarize=True`` is the container contract ({0, 1}); ``binarize=False``
    writes label 2 (the standalone CLI contract).  The volume is zero
    outside the written frame by construction, so the value check runs on the
    2-D mask."""
    location = Path(location)
    location.mkdir(parents=True, exist_ok=True)
    fg = np.squeeze(np.asarray(mask_2d)) > 0
    m2 = np.where(fg, 1 if binarize else 2, 0).astype(np.uint8)
    vol = np.zeros((number_of_frames, *m2.shape), np.uint8)
    if frame_number == -1:
        pass
    elif frame_number is not None and 0 <= frame_number < number_of_frames:
        vol[frame_number] = m2
    else:
        raise ValueError(
            f"frame_number must be between -1 and {number_of_frames - 1}, "
            f"got {frame_number}.")
    img = MetaImage(vol, spacing=tuple(spacing))
    if reference is not None:
        img.copy_information(reference)
    out = location / filename
    write_mha(out, img, compressed=compressed)
    if verify:
        _verify_written(out, vol)
    return out


def write_output_mha_and_json(out_dir: Path, case: str, mask_2d: np.ndarray,
                              frame_number: int, reference: MetaImage) -> Path:
    """Per-case layout of the standalone predict CLI."""
    case_dir = Path(out_dir) / case
    n_frames = reference.size[2] if len(reference.size) >= 3 else 1
    out = write_segmentation_output(
        case_dir / "images/fetal-abdomen-segmentation", mask_2d, frame_number,
        n_frames, reference=reference, binarize=False, compressed=False,
        verify=False)
    write_json(case_dir / "fetal-abdomen-frame-number.json", int(frame_number),
               indent=2)
    return out
