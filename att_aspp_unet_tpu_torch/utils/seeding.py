"""Seeding for ``--deterministic``.  ``set_seed`` reseeds the host RNGs as
``att_aspp_unet_tpu/utils/seeding.py::set_seed`` does; unlike the JAX
package, whose device code is deterministic by construction, it also seeds
PyTorch and makes cuDNN pick deterministic algorithms (the reference's
opt-in cudnn-deterministic mode)."""

from __future__ import annotations

import os
import random

import numpy as np
import torch


def set_seed(seed: int = 2025) -> None:
    os.environ["PYTHONHASHSEED"] = str(seed)
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
