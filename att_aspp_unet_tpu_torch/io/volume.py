"""Sweep volume loading: ``.mha`` through the port's own codec, multi-page
``.tiff`` through PIL (imported only when a TIFF is read).

The container contract globs both extensions; TIFF carries no reliable
spacing metadata, so the challenge default of 0.28 mm isotropic applies there.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .mha import MetaImage, read_mha


def read_volume(path, default_spacing: float = 0.28) -> MetaImage:
    path = Path(path)
    suffix = path.suffix.lower()
    if suffix == ".mha":
        return read_mha(path)
    if suffix in (".tif", ".tiff"):
        from PIL import Image, ImageSequence

        with Image.open(path) as im:
            frames = [np.asarray(page.convert("I;16") if page.mode not in
                                 ("L", "I;16", "I") else page)
                      for page in ImageSequence.Iterator(im)]
        arr = np.stack(frames).astype(np.uint16 if frames and
                                      frames[0].dtype.itemsize > 1 else np.uint8)
        return MetaImage(arr, spacing=(default_spacing,) * 3)
    raise ValueError(f"unsupported volume format: {path.suffix}")
