"""Kernel K1's two paths side by side on the card, per conv pair of a model
(default: base_c 48 at a 512 input, the direct path).

    python -m att_aspp_unet_tpu_torch.tools.bench_k1 [--batch 32] [--reps 5]
    ... bench_k1 --base_c 16 --size 128 --batch 128     # the cascade's scout
    ... bench_k1 --base_c 48 --size 224 --batch 16      # the ROI path

For each of the eight pairs: the mma.sync path's time, the wgmma path's time
where it takes the shape, and the largest difference between the two
outputs.  The inputs are random, made on the card from seed 0.  Needs one
CUDA device; prints the card's name and power limit.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys

import torch

from ..ops.kernels import fused_conv as fc


def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of ``fn`` (CUDA events) after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--base_c", type=int, default=48)
    ap.add_argument("--size", type=int, default=512)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: the bench needs one GPU", file=sys.stderr)
        return 2
    dev, bf = "cuda", torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"gpu: {smi}; base_c {args.base_c} at {args.size}^2, batch "
          f"{args.batch}, median of {args.reps}")
    print(f"{'pair':<5}{'shape':<24}{'mma.sync ms':>12}{'wgmma ms':>10}"
          f"{'max |diff|':>12}")
    tot = {"mma": 0.0, "best": 0.0}
    for name, cin, cmid, cout, hw in fc.model_pairs(args.base_c, args.size):
        def rnd(*shape):
            return torch.randn(*shape, generator=g, device=dev)

        x = rnd(args.batch, cin, hw, hw).to(bf).contiguous(
            memory_format=torch.channels_last)
        w1 = (rnd(cmid, 9 * cin) / (9 * cin) ** 0.5).to(bf)
        w2 = (rnd(cout, 9 * cmid) / (9 * cmid) ** 0.5).to(bf)
        s1 = torch.rand(cmid, generator=g, device=dev) + 0.5
        s2 = torch.rand(cout, generator=g, device=dev) + 0.5
        call = (x, w1, s1, rnd(cmid) * 0.1, w2, s2, rnd(cout) * 0.1)
        pm = fc.prepack_pair(w1, w2, wgmma=False)
        t_m = cuda_ms(lambda: fc.fused_double_cbr(*call, packed=pm), args.reps)
        t_w, diff = None, None
        if fc.wgmma_takes(cin, cmid, cout):
            pw = fc.prepack_pair(w1, w2, wgmma=True)
            t_w = cuda_ms(lambda: fc.fused_double_cbr(*call, packed=pw),
                          args.reps)
            diff = float((fc.fused_double_cbr(*call, packed=pw).float()
                          - fc.fused_double_cbr(*call, packed=pm).float())
                         .abs().max())
        tot["mma"] += t_m
        tot["best"] += t_m if t_w is None else min(t_m, t_w)
        print(f"{name:<5}{f'{cin}->{cmid}->{cout} @{hw}^2':<24}{t_m:12.3f}"
              + (f"{t_w:10.3f}{diff:12.4g}" if t_w is not None
                 else f"{'-':>10}{'-':>12}"))
        del x, call
        torch.cuda.empty_cache()
    print(f"sum: mma.sync on all eight {tot['mma']:.3f} ms; the faster path "
          f"per pair {tot['best']:.3f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
