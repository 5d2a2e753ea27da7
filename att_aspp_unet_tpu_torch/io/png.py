"""Grayscale image IO through PIL, imported inside the functions so that the
package imports without it (a copy of ``att_aspp_unet_tpu/io/png.py``)."""

from __future__ import annotations

from pathlib import Path

import numpy as np


def read_gray_png(path) -> np.ndarray:
    """Read an image file (PNG, JPG, ...) as a uint8 grayscale array (H, W)."""
    from PIL import Image

    with Image.open(path) as im:
        if im.mode != "L":
            im = im.convert("L")
        return np.array(im, dtype=np.uint8)


def write_gray_png(path, array: np.ndarray) -> None:
    """Write a uint8 (H, W) array as a grayscale PNG."""
    from PIL import Image

    arr = np.asarray(array)
    if arr.dtype != np.uint8:
        arr = np.clip(arr, 0, 255).astype(np.uint8)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(arr, mode="L").save(str(path))
