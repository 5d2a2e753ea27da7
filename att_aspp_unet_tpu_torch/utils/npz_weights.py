"""Reader of the flat-npz weight archives (``params/<module>/.../<leaf>``,
``batch_stats/...``) that the JAX package exports, e.g.
``resources/synthetic/weights.npz``."""

from __future__ import annotations

from pathlib import Path
from typing import Dict

import numpy as np


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
