#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. build the hand-written kernels from ``att_aspp_unet_tpu_torch/csrc``
   (one ``nvcc`` per source, in parallel);
2. hold each kernel against its plain PyTorch version on the card at the
   main path's shapes — K1 ``fused_double_cbr`` at the eight conv-pair
   shapes of the base_c 48 model at 512x512 (bf16 channel-last tensors,
   rtol/atol 2e-2; the line of each pair names the path it took, wgmma or
   mma.sync), K2 ``clahe_interp`` through CLAHE on a 140 x 562 x 744 sweep
   (bit-exact) — and time kernel, plain version and a library yardstick
   (for K1 cuDNN's bf16 convolutions on channel-last and on contiguous
   tensors; the faster sum is ``library_ms``);
3. drive the port's ``predict`` CLI on a synthetic 140-frame ``.mha`` sweep
   with the repo's trained weights (base_c 48, hflip TTA), with the kernel
   launch counters zeroed just before and read just after; check the
   outputs; rerun 6 frames around the true best frame on the CPU (plain
   versions) and require the same frame and a mask Dice >= 0.98.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import csv
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
PEAK_BF16_FLOPS = 989e12     # H100 SXM dense bf16 tensor-core rate
PEAK_F32_FLOPS = 67e12       # H100 SXM f32 rate outside the tensor cores
PEAK_BYTES = 3.35e12         # H100 SXM HBM3 bytes/s
N_FRAMES, FRAME_HW, SEED = 140, (562, 744), 0
# conv pairs of the main path: (Cin, Cmid, Cout, H=W) at base_c 48, 512 input
PAIR_SHAPES = [("d1", 1, 48, 48, 512), ("d2", 48, 96, 96, 256),
               ("d3", 96, 192, 192, 128), ("d4", 192, 384, 384, 64),
               ("u4", 768, 384, 384, 64), ("u3", 384, 192, 192, 128),
               ("u2", 192, 96, 96, 256), ("u1", 96, 48, 48, 512)]


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 5) -> float:
    """Median milliseconds of ``fn`` on the card (CUDA events), after one
    warm-up call."""
    import torch

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


def bound(flops: float, nbytes: float, peak_flops: float):
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def phase_build():
    from att_aspp_unet_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    logs = _build.build_all()
    log(f"[build] {len(logs)} kernel(s) built in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")


def phase_k1(dev):
    """K1 at the eight pair shapes, N = 32 (a 16-frame micro-batch with its
    hflip twins).  Returns the kernel's JSON entry (sums over the eight)."""
    import torch
    import torch.nn.functional as F

    from att_aspp_unet_tpu_torch.ops.kernels import fused_conv as fc

    g = torch.Generator(device=dev).manual_seed(SEED)
    bf = torch.bfloat16
    N = 32
    tot = dict(ms=0.0, plain_ms=0.0, lib_cl=0.0, lib_nchw=0.0, bound_ms=0.0,
               flops=0.0, bytes=0.0)
    max_err = 0.0
    for name, cin, cmid, cout, hw in PAIR_SHAPES:
        def rnd(*shape):
            return torch.randn(*shape, generator=g, device=dev)

        x = rnd(N, cin, hw, hw).to(bf).contiguous(
            memory_format=torch.channels_last)
        w1 = (rnd(cmid, 9 * cin) / (9 * cin) ** 0.5).to(bf)
        w2 = (rnd(cout, 9 * cmid) / (9 * cmid) ** 0.5).to(bf)
        s1 = torch.rand(cmid, generator=g, device=dev) + 0.5
        s2 = torch.rand(cout, generator=g, device=dev) + 0.5
        b1, b2 = rnd(cmid) * 0.1, rnd(cout) * 0.1
        args = (x, w1, s1, b1, w2, s2, b2)
        packed = fc.prepack_pair(w1, w2)     # once, as FusedCBRPair does

        got = fc.fused_double_cbr(*args, packed=packed)
        torch.cuda.synchronize()
        want = fc.fused_double_cbr_reference(*args).float()
        err = (got.float() - want).abs()
        n_bad = int((err > 2e-2 + 2e-2 * want.abs()).sum())
        max_err = max(max_err, float(err.max()))
        del got, want, err
        if n_bad:
            raise AssertionError(f"K1 {name}: {n_bad} outputs outside "
                                 "rtol/atol 2e-2")

        sb = [t.to(bf)[None, :, None, None] for t in (s1, b1, s2, b2)]

        def library(x, fmt):
            w1o = fc.unpack_conv_weight(w1, cin).contiguous(memory_format=fmt)
            w2o = fc.unpack_conv_weight(w2, cmid).contiguous(memory_format=fmt)

            def run():
                h = F.relu(F.conv2d(x, w1o, padding=1) * sb[0] + sb[1])
                return F.relu(F.conv2d(h, w2o, padding=1) * sb[2] + sb[3])
            return run

        ms = cuda_ms(lambda: fc.fused_double_cbr(*args, packed=packed))
        plain_ms = cuda_ms(lambda: fc.fused_double_cbr_reference(*args), 3)
        lib_cl = cuda_ms(library(x, torch.channels_last))
        lib_nchw = cuda_ms(library(x.contiguous(), torch.contiguous_format))
        flops = 2.0 * N * hw * hw * 9 * (cin * cmid + cmid * cout)
        nbytes = (2 * (x.numel() + w1.numel() + w2.numel() + N * cout * hw * hw)
                  + 4 * (2 * cmid + 2 * cout))
        b_ms, _ = bound(flops, nbytes, PEAK_BF16_FLOPS)
        log(f"[K1] {name} N={N} {cin}->{cmid}->{cout} @{hw}^2: kernel "
            f"{ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s, "
            f"{'wgmma' if packed.wgmma else 'mma.sync'} path, tile "
            f"{packed.th}x16, K-chunk {packed.kc}), plain {plain_ms:.3f}"
            f" ms, cuDNN bf16 channel-last {lib_cl:.3f} ms / NCHW "
            f"{lib_nchw:.3f} ms, bound {b_ms:.3f} ms, max|err| "
            f"{float(max_err):.4g}")
        for k, v in (("ms", ms), ("plain_ms", plain_ms), ("lib_cl", lib_cl),
                     ("lib_nchw", lib_nchw), ("bound_ms", b_ms),
                     ("flops", flops), ("bytes", nbytes)):
            tot[k] += v
        del x, w1, w2, args
        torch.cuda.empty_cache()
    _, bound_by = bound(tot["flops"], tot["bytes"], PEAK_BF16_FLOPS)
    log(f"[K1] all eight pairs (one 32-frame micro-batch): kernel "
        f"{tot['ms']:.3f} ms = {tot['flops'] / tot['ms'] / 1e9:.1f} TFLOP/s, "
        f"cuDNN bf16 channel-last {tot['lib_cl']:.3f} ms / NCHW "
        f"{tot['lib_nchw']:.3f} ms, bound {tot['bound_ms']:.3f} ms "
        f"({bound_by})")
    return {"name": "fused_double_cbr", "route": "cuda",
            "source": "att_aspp_unet_tpu_torch/csrc/fused_double_cbr.cu",
            "replaces": "att_aspp_unet_tpu/ops/pallas/fused_conv.py:140",
            "max_abs_err": max_err, "ms": tot["ms"],
            "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": bound_by,
            "library_ms": min(tot["lib_cl"], tot["lib_nchw"])}


def phase_k2(dev, sweep):
    """K2 on the CLAHE operands of the whole sweep, bit-exact."""
    import torch

    from att_aspp_unet_tpu_torch.ops.clahe import clahe_finish, clahe_tables
    from att_aspp_unet_tpu_torch.ops.image import minmax_normalize_u8
    from att_aspp_unet_tpu_torch.ops.kernels import clahe_interp as ci

    u8 = minmax_normalize_u8(torch.as_tensor(sweep).to(dev))
    blocks, luts, wts = clahe_tables(u8)
    got = ci.clahe_interp(blocks, luts, wts)
    torch.cuda.synchronize()
    want = ci.clahe_interp_reference(blocks, luts, wts)
    n_raw = int((got != want).sum())
    max_err = float((got - want).abs().max())
    n_u8 = int((clahe_finish(got, FRAME_HW) != clahe_finish(want, FRAME_HW))
               .sum())
    log(f"[K2] clahe on {tuple(u8.shape)} u8: blocks {tuple(blocks.shape)}, "
        f"{n_raw} blended values and {n_u8} u8 pixels differ from the plain "
        "version")
    if n_raw or n_u8:
        raise AssertionError(f"K2 is not bit-exact: {n_u8} u8 pixels differ")

    idx4 = blocks.clamp(0, 255).long()[..., None].expand(*blocks.shape, 4)
    ms = cuda_ms(lambda: ci.clahe_interp(blocks, luts, wts), 10)
    plain_ms = cuda_ms(lambda: ci.clahe_interp_reference(blocks, luts, wts), 3)
    lib_ms = cuda_ms(lambda: (torch.gather(luts, 2, idx4) * wts).sum(-1), 5)
    nbytes = 4 * (blocks.numel() + luts.numel() + wts.numel() + got.numel())
    b_ms, bound_by = bound(7.0 * blocks.numel(), nbytes, PEAK_F32_FLOPS)
    log(f"[K2] kernel {ms:.3f} ms ({nbytes / ms / 1e6:.1f} GB/s), plain "
        f"{plain_ms:.3f} ms, gather+sum {lib_ms:.3f} ms, bound {b_ms:.3f} ms "
        f"({bound_by})")
    return {"name": "clahe_interp", "route": "cuda",
            "source": "att_aspp_unet_tpu_torch/csrc/clahe_interp.cu",
            "replaces": "att_aspp_unet_tpu/ops/pallas/clahe_interp.py:90",
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": bound_by, "library_ms": lib_ms}


def dice(a, b) -> float:
    a, b = a > 0, b > 0
    s = int(a.sum()) + int(b.sum())
    return 1.0 if s == 0 else 2.0 * int((a & b).sum()) / s


def phase_slice(dev, sweep, best_true, truth):
    """The predict CLI on the sweep, with the launch counters read around
    it; output checks; the CPU cross-check; the stage split."""
    import numpy as np

    from att_aspp_unet_tpu_torch import cli
    from att_aspp_unet_tpu_torch.config import (Config, ModelConfig,
                                                PredictConfig)
    from att_aspp_unet_tpu_torch.infer.engine import AttAsppEngine
    from att_aspp_unet_tpu_torch.io import (MetaImage, read_json, read_mha,
                                            write_mha)
    from att_aspp_unet_tpu_torch.ops.kernels import clahe_interp as ci
    from att_aspp_unet_tpu_torch.ops.kernels import fused_conv as fc
    from att_aspp_unet_tpu_torch.utils.npz_weights import load_npz_variables

    weights = REPO / "resources/synthetic/weights.npz"
    thr = float(json.loads((REPO / "resources/synthetic/thr.json")
                           .read_text())["best_thr"])
    cfg = Config(model=ModelConfig(base_c=48),
                 predict=PredictConfig(tta_hflip=True))
    variables = load_npz_variables(weights)
    n = sweep.shape[0]

    # warm-up on the card (first-call costs: cuDNN/cuBLAS handles, allocator)
    times = {}
    engine = AttAsppEngine(cfg, variables, device=dev, stage_times=times)
    engine.predict_case(sweep[:16], (0.28, 0.28), thr)

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        (tmp / "in").mkdir()
        write_mha(tmp / "in/sweep_0.mha",
                  MetaImage(sweep, spacing=(0.28, 0.28, 1.0)))
        argv = ["predict", "--weights", str(weights), "--input_dir",
                str(tmp / "in"), "--out_dir", str(tmp / "out"), "--thr",
                str(thr), "--device", dev]
        fc.fused_double_cbr.launches = 0
        ci.clahe_interp.launches = 0
        t0 = time.perf_counter()
        rc = cli.main(argv)
        wall = time.perf_counter() - t0
        launches = {"fused_double_cbr": fc.fused_double_cbr.launches,
                    "clahe_interp": ci.clahe_interp.launches}
        log(f"[slice] cli predict: rc {rc}, {wall:.2f} s for {n} frames = "
            f"{n / wall:.1f} frames/s end to end (read .mha, predict, write); "
            f"kernel launches {launches}")
        if rc != 0 or min(launches.values()) <= 0:
            raise AssertionError(f"main path: rc {rc}, launches {launches}")

        case = tmp / "out/sweep_0"
        vol = read_mha(case / "images/fetal-abdomen-segmentation/output.mha")
        frame = int(read_json(case / "fetal-abdomen-frame-number.json"))
        with open(tmp / "out/ac_results.csv", newline="") as f:
            rows = list(csv.reader(f))
        arr = vol.array
        fg_frames = np.flatnonzero(arr.reshape(n, -1).any(axis=1)).tolist()
        ac = float(rows[1][2])
        log(f"[slice] output {arr.shape} {arr.dtype} values "
            f"{sorted(np.unique(arr).tolist())}, mask on frames {fg_frames}, "
            f"frame JSON {frame}, csv {rows}")
        abdomen = [i for i in range(n)
                   if 1.0 - abs(i - best_true) / max(n * 0.25, 1) >= 0.25]
        truth_mm = truth.circumference_px() * 0.28
        log(f"[slice] chosen frame {frame} (generator's best {best_true}, "
            f"abdomen frames {abdomen[0]}..{abdomen[-1]}), AC {ac} mm "
            f"(analytic ring {truth_mm:.1f} mm at the best frame)")
        if not (arr.shape == sweep.shape and set(np.unique(arr)) <= {0, 2}
                and fg_frames == [frame] and rows[1][:2] == ["sweep_0",
                                                             str(frame)]
                and np.isfinite(ac) and ac > 0 and frame in abdomen):
            raise AssertionError("predict outputs failed their checks")

    # stage split on a warm engine, same sweep
    times.clear()
    t0 = time.perf_counter()
    f_gpu_full, _, _ = engine.predict_case(sweep, (0.28, 0.28), thr)
    tot = time.perf_counter() - t0
    log("[slice] engine stages for %d frames: %s; total %.3f s = %.1f "
        "frames/s" % (n, ", ".join(f"{k} {v:.3f} s ({n / v:.1f} frames/s)"
                                   for k, v in times.items()), tot, n / tot))
    if f_gpu_full != frame:
        raise AssertionError(f"engine rerun picked {f_gpu_full}, CLI {frame}")

    # the same slice with the plain versions on the CPU, 6 frames
    lo = max(0, best_true - 3)
    sub = sweep[lo:lo + 6]
    t0 = time.perf_counter()
    f_cpu, m_cpu, ac_cpu = AttAsppEngine(cfg, variables, device="cpu") \
        .predict_case(sub, (0.28, 0.28), thr)
    t_cpu = time.perf_counter() - t0
    engine.stage_times = None
    f_gpu, m_gpu, ac_gpu = engine.predict_case(sub, (0.28, 0.28), thr)
    d = dice(m_cpu, m_gpu)
    log(f"[slice] 6 frames {lo}..{lo + 5}: card frame {lo + f_gpu} AC "
        f"{ac_gpu:.2f} mm, CPU plain frame {lo + f_cpu} AC {ac_cpu:.2f} mm "
        f"({t_cpu:.1f} s), mask Dice {d:.5f}, "
        f"{int(((m_cpu > 0) != (m_gpu > 0)).sum())} pixels differ")
    if f_cpu != f_gpu or d < 0.98:
        raise AssertionError("card and CPU plain versions disagree")
    return launches


def main() -> int:
    if not (REPO / "att_aspp_unet_tpu_torch").is_dir():
        print("chip_smoke.py must run from a checkout of the repository",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: this smoke run needs one GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from att_aspp_unet_tpu_torch.tools.synthetic import make_sweep

    dev = "cuda"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t_start = time.perf_counter()
    phase_build()
    k1 = phase_k1(dev)
    t0 = time.perf_counter()
    sweep, best_true, truth = make_sweep(N_FRAMES, *FRAME_HW, seed=SEED)
    log(f"[data] synthetic sweep {sweep.shape} seed {SEED} in "
        f"{time.perf_counter() - t0:.1f} s, best frame {best_true}")
    k2 = phase_k2(dev, sweep)
    launches = phase_slice(dev, sweep, best_true, truth)
    k1["launches"] = launches["fused_double_cbr"]
    k2["launches"] = launches["clahe_interp"]
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(f"gpu: {smi}")
    print(json.dumps({"kernels": [k1, k2]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
