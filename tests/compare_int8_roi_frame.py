"""The ROI (container) path's frame pick of the JAX package's int8 engine
against its bf16 engine, on the CPU, on the 840-frame case.

    python tests/compare_int8_roi_frame.py [--quant scales.npz]

Builds the six seeded 140-frame 562 x 744 synthetic sweeps (seeds 0..5,
stacked: the 840-frame case the container serves), runs the JAX package's
``predict_roi`` + ``postprocess_roi`` with the repo's trained weights
(base_c 48, the container's configuration) in bf16 and with
``--int8``, picks each frame as the container does, and prints both picks
with the pixels above 0.05 that each engine's probabilities give both
frames.  ``--quant`` is an npz of variables with their ``quant``
collection, as ``chip_smoke.py --save-int8-scales`` writes the card's
calibration of the same case; without it the JAX int8 engine calibrates on
the case itself.  Takes several minutes on the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402

from att_aspp_unet_tpu.config import Config, ModelConfig  # noqa: E402
from att_aspp_unet_tpu.infer.engine import (AttAsppEngine,  # noqa: E402
                                            select_mask_and_frame)
from att_aspp_unet_tpu.utils.npz_weights import load_npz_variables  # noqa: E402


def roi_pick(engine, case):
    """(frame of the case, pixels above 0.05 per subsampled frame, the
    subsampled frame indices, seconds) of the container's ROI pick."""
    t0 = time.perf_counter()
    probs = engine.predict_roi(case)
    masks = np.asarray(engine.postprocess_roi(probs))
    _, sub = select_mask_and_frame(masks)
    n = case.shape[0]
    idxs = np.linspace(0, n - 1, min(engine.cfg.predict.subsample_frames, n)
                       ).astype(int)
    areas = (np.asarray(probs) > 0.05).sum(axis=(-2, -1))
    return (int(idxs[sub]) if sub >= 0 else -1), areas, idxs, \
        time.perf_counter() - t0


def main(argv=None) -> int:
    from att_aspp_unet_tpu_torch.tools.synthetic import make_sweep

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quant", default=None)
    ap.add_argument("--weights",
                    default=str(REPO / "resources/synthetic/weights.npz"))
    args = ap.parse_args(argv)
    case = np.concatenate([make_sweep(140, 562, 744, seed=s)[0]
                           for s in range(6)])
    picks = {}
    for label in ("bf16", "int8"):
        lowering = "int8" if label == "int8" else "direct"
        variables = load_npz_variables(
            args.quant if label == "int8" and args.quant else args.weights)
        engine = AttAsppEngine(Config(model=ModelConfig(
            base_c=48, conv_lowering=lowering)), variables)
        picks[label] = roi_pick(engine, case)
        print(f"[{label}] frame {picks[label][0]} "
              f"({picks[label][3]:.1f} s)", flush=True)
    idxs = picks["bf16"][2]
    for label, (frame, areas, _, _) in picks.items():
        counts = {f: int(areas[list(idxs).index(f)])
                  for f in (picks["bf16"][0], picks["int8"][0]) if f in idxs}
        print(f"{label} engine: picks frame {frame}; pixels above 0.05 "
              f"per frame {counts}, of {224 * 224}")
    scales = args.quant or "the JAX engine's own calibration on the case"
    print(f"int8 scales: {scales}; same frame: "
          f"{picks['bf16'][0] == picks['int8'][0]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
