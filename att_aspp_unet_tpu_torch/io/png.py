"""Grayscale PNG output through PIL, imported inside the function so that
the package imports without it."""

from __future__ import annotations

from pathlib import Path

import numpy as np


def write_gray_png(path, array: np.ndarray) -> None:
    """Write a uint8 (H, W) array as a grayscale PNG."""
    from PIL import Image

    arr = np.asarray(array)
    if arr.dtype != np.uint8:
        arr = np.clip(arr, 0, 255).astype(np.uint8)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(arr, mode="L").save(str(path))
