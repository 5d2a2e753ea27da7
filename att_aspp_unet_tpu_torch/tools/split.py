"""Train/val dataset splitter (a copy of the JAX package's ``tools/split.py``;
the same seed gives the same partition).

Capability parity with the reference's ``split_image.py`` (seeded 80/20
shuffle of ``<raw>/{images,masks}`` copied into
``<out>/{train,val}/{images,masks}``), structured as three separable steps:
discover image/mask pairs, assign each pair to a partition, materialize the
partitions on disk.  Unlike the reference, a missing mask is tolerated
(negative-only frames from ``tools.convert`` have images but no mask file).
"""

from __future__ import annotations

import random
import shutil
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional


@dataclass(frozen=True)
class SamplePair:
    """One dataset sample: an image file and its (optional) mask twin."""
    image: Path
    mask: Optional[Path]


def discover_pairs(raw_root) -> List[SamplePair]:
    """All samples under ``<raw>/images``, mask matched by filename."""
    raw_root = Path(raw_root)
    mask_dir = raw_root / "masks"
    pairs = []
    for image in sorted((raw_root / "images").glob("*")):
        mask = mask_dir / image.name
        pairs.append(SamplePair(image, mask if mask.exists() else None))
    return pairs


def assign_partitions(pairs: List[SamplePair], train_frac: float,
                      seed: int) -> Dict[str, List[SamplePair]]:
    """Seeded-shuffle assignment; first ``train_frac`` of the permutation
    becomes train, the remainder val (reference: seed 42, 80/20)."""
    order = list(pairs)
    random.Random(seed).shuffle(order)
    cut = int(train_frac * len(order))
    return {"train": order[:cut], "val": order[cut:]}


def materialize(partitions: Dict[str, List[SamplePair]], out_root) -> None:
    """Copy every assigned pair into ``<out>/<partition>/{images,masks}``."""
    out_root = Path(out_root)
    for name, members in partitions.items():
        img_out = out_root / name / "images"
        mask_out = out_root / name / "masks"
        img_out.mkdir(parents=True, exist_ok=True)
        mask_out.mkdir(parents=True, exist_ok=True)
        for pair in members:
            shutil.copy(pair.image, img_out / pair.image.name)
            if pair.mask is not None:
                shutil.copy(pair.mask, mask_out / pair.mask.name)


def split_train_val(raw_root, out_root, train_frac: float = 0.8,
                    seed: int = 42, log=print) -> Dict[str, List[Path]]:
    """Discover, assign and copy; returns {partition: [image paths]}."""
    partitions = assign_partitions(discover_pairs(raw_root), train_frac, seed)
    materialize(partitions, out_root)
    log(f"Train: {len(partitions['train'])}  Val: {len(partitions['val'])}")
    return {name: [p.image for p in members]
            for name, members in partitions.items()}
