"""Host RNG seeding for ``--deterministic`` (a copy of
``att_aspp_unet_tpu/utils/seeding.py::set_seed``).  The eval paths draw no
random numbers on the device, so the flag reseeds only the host RNGs."""

from __future__ import annotations

import os
import random

import numpy as np


def set_seed(seed: int = 2025) -> None:
    os.environ["PYTHONHASHSEED"] = str(seed)
    random.seed(seed)
    np.random.seed(seed)
