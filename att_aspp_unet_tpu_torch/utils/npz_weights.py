"""Flat-npz weight archives (``params/<module>/.../<leaf>``,
``batch_stats/...``), the JAX package's format (e.g.
``resources/synthetic/weights.npz``): the reader, and the writer that
``cli train --export_npz`` uses (a copy of
``att_aspp_unet_tpu/utils/npz_weights.py::save_npz_variables``)."""

from __future__ import annotations

from pathlib import Path
from typing import Dict

import numpy as np


def save_npz_variables(variables: Dict, path) -> None:
    """Nested ``{collection: {module: ... {leaf: array}}}`` -> one compressed
    npz; float leaves of params / batch_stats are stored as f16, every other
    leaf keeps its dtype."""
    flat = {}

    def walk(prefix, tree, narrow):
        for key, value in tree.items():
            name = f"{prefix}/{key}"
            if isinstance(value, dict):
                walk(name, value, narrow)
                continue
            arr = np.asarray(value)
            flat[name] = (arr.astype(np.float16) if narrow and
                          np.issubdtype(arr.dtype, np.floating) else arr)

    for coll, tree in variables.items():
        walk(coll, tree, coll in ("params", "batch_stats"))
    np.savez_compressed(path, **flat)


def load_npz_variables(path) -> Dict:
    """Rebuild the nested collections; params/batch_stats leaves widen to
    float32, other collections keep their stored dtype."""
    out: Dict = {"params": {}, "batch_stats": {}}
    with np.load(Path(path)) as z:
        for key in z.files:
            parts = key.split("/")
            node = out.setdefault(parts[0], {})
            for p in parts[1:-1]:
                node = node.setdefault(p, {})
            leaf = z[key]
            if (parts[0] in ("params", "batch_stats")
                    and np.issubdtype(leaf.dtype, np.floating)):
                leaf = leaf.astype(np.float32)
            node[parts[-1]] = leaf
    return out
