"""Host-side dataset pipeline, a copy of ``att_aspp_unet_tpu/train/data.py``
(which imports no JAX): pair collection (images / masks [+ a negative dir]),
the positive-only 10 % val split fallback, deterministic epoch shuffling with
the same numpy RNG (so the index order equals the JAX package's), and
batching.  Images are read and resized to the training size on the host
(uint8); augmentation and enhancement run on the device in
``train.augment.augment_batch``.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..io import read_gray_png
from ..io.mha import read_mha

_EXTS = {".png", ".jpg", ".jpeg", ".tif", ".bmp", ".mha"}


def collect_pairs(img_dir: Path, msk_dir: Optional[Path]
                  ) -> Tuple[List[Path], List[Optional[Path]]]:
    """Sorted images with same-name masks where present (else None)."""
    imgs, msks = [], []
    for p in sorted(Path(img_dir).iterdir()):
        if p.suffix.lower() not in _EXTS:
            continue
        imgs.append(p)
        q = Path(msk_dir) / p.name if msk_dir else None
        msks.append(q if (q and q.exists()) else None)
    return imgs, msks


def positive_only_val_split(imgs: Sequence[Path], msks: Sequence[Optional[Path]],
                            seed: int, val_frac: float = 0.1):
    """10 % val split drawn from positive (mask-bearing) samples only, with
    an all-samples fallback when no positives exist (``…stage.py:271-289``)."""
    pos = [i for i, m in enumerate(msks) if m is not None]
    cand = pos if pos else list(range(len(imgs)))
    rng = np.random.default_rng(seed)
    cand = list(cand)
    rng.shuffle(cand)
    val_sel = set(cand[: max(1, int(val_frac * len(cand)))])
    tr = [i for i in range(len(imgs)) if i not in val_sel]
    va = sorted(val_sel)
    pick = lambda idx: ([imgs[i] for i in idx], [msks[i] for i in idx])
    return pick(tr), pick(va)


def _read_image(p: Path) -> np.ndarray:
    if p.suffix.lower() == ".mha":
        arr = read_mha(p).array
        if arr.ndim == 3:
            arr = arr[arr.shape[0] // 2]      # middle frame, like the dataset
        lo, hi = arr.min(), arr.max()
        if arr.dtype != np.uint8:
            arr = np.zeros_like(arr, np.uint8) if hi <= lo else \
                np.clip(np.round((arr.astype(np.float64) - lo)
                                 * (255.0 / (hi - lo))), 0, 255).astype(np.uint8)
        return arr
    return read_gray_png(p)


def _resize_u8(img: np.ndarray, size: int) -> np.ndarray:
    """Host bilinear resize to (size, size) — PIL, half-pixel convention."""
    from PIL import Image

    if img.shape == (size, size):
        return img
    return np.asarray(Image.fromarray(img).resize((size, size),
                                                  Image.BILINEAR))


@dataclasses.dataclass
class ArrayDataset:
    """Materialised uint8 dataset: images (N, S, S), masks (N, S, S)."""

    images: np.ndarray
    masks: np.ndarray
    is_positive: np.ndarray

    def __len__(self):
        return len(self.images)

    @classmethod
    def from_paths(cls, imgs: Sequence[Path], msks: Sequence[Optional[Path]],
                   img_size: int) -> "ArrayDataset":
        xs, ys, pos = [], [], []
        for ip, mp in zip(imgs, msks):
            img = _resize_u8(_read_image(Path(ip)), img_size)
            if mp is None:
                msk = np.zeros_like(img)
            else:
                msk = _resize_u8(_read_image(Path(mp)), img_size)
            xs.append(img)
            ys.append(msk)
            pos.append(mp is not None)
        return cls(np.stack(xs) if xs else np.zeros((0, img_size, img_size), np.uint8),
                   np.stack(ys) if ys else np.zeros((0, img_size, img_size), np.uint8),
                   np.array(pos, bool))


def epoch_batches(ds: ArrayDataset, batch_size: int, seed: int, epoch: int,
                  shuffle: bool = True, drop_last: bool = True
                  ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Deterministic shuffled batches; (epoch, seed)-keyed like the seeded
    torch Generator + worker seeding of the reference."""
    n = len(ds)
    order = np.arange(n)
    if shuffle:
        np.random.default_rng(seed * 100003 + epoch).shuffle(order)
    stop = n - (n % batch_size) if drop_last else n
    for s in range(0, stop, batch_size):
        idx = order[s:s + batch_size]
        yield ds.images[idx], ds.masks[idx]
