"""Where the device time of one sweep goes: a warm
``AttAsppEngine.predict_case`` under ``torch.profiler``.

    python -m att_aspp_unet_tpu_torch.tools.profile_predict [--frames 140]
        [--top 10] [--weights resources/synthetic/weights.npz]
        [--cascade [--scout_weights resources/.../weights.npz] | --roi
         | --baseline] [--int8]

Builds the synthetic sweep (``tools/synthetic.make_sweep``, seed 0, 562x744),
runs one case to warm up, profiles the next one and prints the device
operations with the most self time, the device-busy share of the case's wall
time, and the card's name and power limit.  ``--cascade`` profiles the
two-tier cascade, by default with the distilled 128-px scout; ``--roi``
profiles the container's ROI path (``predict_roi`` and its postprocess)
instead of ``predict_case``; ``--baseline`` the container's default model
(``BaselineEngine.predict``, its postprocess and the frame ladder) with the
initialisation of seed 0, the command line's without ``--weights``.
``--int8`` serves the 3x3 convs on the int8 path (kernel K3), calibrated on
the sweep before the warm-up.  Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType

from ..config import Config, ModelConfig, PredictConfig
from ..infer.engine import AttAsppEngine
from ..utils.npz_weights import load_npz_variables
from .synthetic import make_sweep

REPO = Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=140)
    ap.add_argument("--top", type=int, default=10)
    ap.add_argument("--weights", default=str(
        REPO / "resources/synthetic/weights.npz"))
    ap.add_argument("--cascade", action="store_true")
    ap.add_argument("--roi", action="store_true")
    ap.add_argument("--baseline", action="store_true")
    ap.add_argument("--int8", action="store_true")
    ap.add_argument("--scout_weights", default=str(
        REPO / "resources/synthetic_scout_noclahe128/weights.npz"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: the profile needs one GPU", file=sys.stderr)
        return 2
    thr = float(json.loads((REPO / "resources/synthetic/thr.json")
                           .read_text())["best_thr"])
    cfg = Config(model=ModelConfig(
                     base_c=48,
                     conv_lowering="int8" if args.int8 else "direct"),
                 predict=PredictConfig(
                     tta_hflip=True, cascade=args.cascade,
                     cascade_scout_weights=(args.scout_weights
                                            if args.cascade else None)))
    engine = AttAsppEngine(cfg, load_npz_variables(args.weights),
                           device="cuda")
    sweep, _, _ = make_sweep(args.frames, 562, 744, seed=0)

    if args.baseline:
        from ..infer.container import select_labeled_mask_and_frame
        from ..infer.engine import BaselineEngine
        from ..models import PlainConvUNet

        base = BaselineEngine(Config(), PlainConvUNet.from_config(
            Config().plain_unet, seed=0), device="cuda")

    def case(frames):
        if args.baseline:
            return select_labeled_mask_and_frame(
                base.postprocess(base.predict(frames)))
        if args.roi:
            return engine.postprocess_roi(engine.predict_roi(frames)).cpu()
        return engine.predict_case(frames, (0.28, 0.28), thr)

    case(sweep if args.int8 else sweep[:16])    # int8: calibrates on it
    case(sweep)
    torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        case(sweep)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    # kernel and memcpy events only: an operator's row repeats its kernels'
    rows = sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and dev_us(e) > 0),
                  key=dev_us, reverse=True)
    busy = sum(dev_us(e) for e in rows) / 1e6
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"gpu: {smi}")
    what = ("BaselineEngine predict + postprocess" if args.baseline else
            "predict_roi + postprocess_roi" if args.roi else
            "predict_case (cascade)" if args.cascade else "predict_case")
    if args.int8:
        what += ", --int8"
    print(f"{what}, "
          f"{args.frames} frames, warm, profiler on: "
          f"{wall:.3f} s wall, device busy {busy:.3f} s "
          f"({100 * busy / wall:.1f} %)")
    print(f"{'device ms':>10} {'share':>6} {'calls':>6}  operation")
    for e in rows[:args.top]:
        print(f"{dev_us(e) / 1e3:10.3f} {100 * dev_us(e) / 1e6 / busy:5.1f}% "
              f"{e.count:6d}  {e.key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
