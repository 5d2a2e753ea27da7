"""Where the device time of a train step goes: warm train steps of the full
model under ``torch.profiler``.

    python -m att_aspp_unet_tpu_torch.tools.profile_train [--base_c 48]
        [--size 512] [--batch 8] [--steps 5] [--top 25] [--f32]

Builds the seeded model (``utils/convert.init_variables``, seed 0) and a
batch of synthetic frames and masks (``tools/synthetic.make_dataset``),
runs three steps to warm up, profiles ``--steps`` more and prints the
milliseconds per step, the device operations with the most self time, the
device-busy share of the wall time, the peak device memory and the card's
name and power limit.  ``--f32`` trains in exact f32 instead of bf16.
Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType

from ..config import Config, ModelConfig, PreprocessConfig, TrainConfig
from ..train.train_loop import create_train_state, train_step
from .synthetic import make_dataset


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base_c", type=int, default=48)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--f32", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: the profile needs one GPU", file=sys.stderr)
        return 2
    cfg = Config(model=ModelConfig(
        base_c=args.base_c,
        compute_dtype="float32" if args.f32 else "bfloat16"),
        preprocess=PreprocessConfig(img_size=args.size),
        train=TrainConfig(batch_size=args.batch, epochs=1))
    state = create_train_state(cfg.model, cfg.train, 100, "cuda")
    imgs, msks = make_dataset(args.batch - args.batch // 4, args.batch // 4,
                              args.size, seed=0)

    def steps(n):
        for _ in range(n):
            train_step(state, cfg, imgs, msks)
        torch.cuda.synchronize()

    steps(3)
    torch.cuda.reset_peak_memory_stats()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        steps(args.steps)
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

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
    print(f"train_step, base_c {args.base_c}, {args.size}^2, batch "
          f"{args.batch}, {cfg.model.compute_dtype}, {args.steps} warm steps, "
          f"profiler on: {1e3 * wall / args.steps:.2f} ms per step, device "
          f"busy {busy:.3f} s of {wall:.3f} s ({100 * busy / wall:.1f} %), "
          f"peak {peak:.2f} GiB")
    print(f"{'device ms':>10} {'share':>6} {'calls':>6}  operation")
    for e in rows[:args.top]:
        print(f"{dev_us(e) / 1e3:10.3f} {100 * dev_us(e) / 1e6 / busy:5.1f}% "
              f"{e.count:6d}  {e.key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
