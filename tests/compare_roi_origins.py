"""``crop_roi`` of the port against the JAX package's at native size: the
number of frames whose ROI origin differs between the two.

    python tests/compare_roi_origins.py

runs both packages on the CPU over every frame of the six seeded 140-frame
562 x 744 synthetic sweeps (seeds 0..5, the 840-frame case that the
container path serves), on the input the ROI path gives ``crop_roi`` (the
enhanced frames / 255) and on the raw frames / 255, and prints the counts.
``tests/test_torch_serving.py`` holds the same comparison on a shorter
seeded sweep.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from att_aspp_unet_tpu.preprocess.roi import crop_roi as jax_crop_roi  # noqa: E402
from att_aspp_unet_tpu_torch.preprocess import enhance_frames  # noqa: E402
from att_aspp_unet_tpu_torch.preprocess.roi import crop_roi  # noqa: E402


def roi_inputs(sweep_u8: np.ndarray) -> dict:
    """label -> the f32 (N, H, W) stack handed to ``crop_roi``: the ROI
    path's enhanced frames / 255, and the raw frames / 255."""
    with torch.no_grad():
        enh = enhance_frames(torch.from_numpy(sweep_u8), 1.0, (8, 8), 3)
    return {"enhanced": enh.to(torch.float32).numpy() / np.float32(255.0),
            "raw": sweep_u8.astype(np.float32) / np.float32(255.0)}


def differing_origins(frames: np.ndarray, roi: int = 224) -> int:
    """Frames of an (N, H, W) f32 stack whose origin differs between the two
    packages."""
    _, want = jax.jit(jax_crop_roi, static_argnums=1)(jnp.asarray(frames), roi)
    _, got = crop_roi(torch.from_numpy(frames), roi)
    return int((np.asarray(want) != got.numpy()).any(axis=1).sum())


def main() -> int:
    from att_aspp_unet_tpu_torch.tools.synthetic import make_sweep

    totals = {"enhanced": 0, "raw": 0}
    n = 0
    for seed in range(6):
        sweep = make_sweep(140, 562, 744, seed=seed)[0]
        n += len(sweep)
        for label, frames in roi_inputs(sweep).items():
            d = differing_origins(frames)
            totals[label] += d
            print(f"seed {seed}: {label}: {d} of {len(sweep)} origins differ",
                  flush=True)
    for label, d in totals.items():
        print(f"all six sweeps, {label}: {d} of {n} origins differ")
    return 0


if __name__ == "__main__":
    sys.exit(main())
