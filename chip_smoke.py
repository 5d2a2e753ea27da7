#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. build the hand-written kernels from ``att_aspp_unet_tpu_torch/csrc``
   (one ``nvcc`` per source, in parallel);
2. hold each kernel against its plain PyTorch version on the card at the
   shapes the serving paths give it — K1 ``fused_double_cbr`` at the eight
   conv-pair shapes of the base_c 48 model at 512x512 (N = 32), of the
   base_c 16 scout at 128x128 (N = 128) and of the base_c 48 model on the
   224x224 ROI (N = 16), bf16 channel-last tensors, rtol/atol 2e-2, the line
   of each pair naming the path it took (wgmma or mma.sync); K2
   ``clahe_interp`` through CLAHE's own tables, bit-exact, on the 140 x 562
   x 744 sweep, on the 8, 32 and 128 native frames that the cascade, the bulk
   path and the container enhance, on the sweep at 256 x 256 and 128 x 128
   (a scout's CLAHE: tiles of 32 x 32 and 16 x 16 pixels) and on the whole
   840 x 562 x 744 case (the baseline) — and time
   kernel, plain version and a library yardstick (for K1 cuDNN's
   bf16 convolutions on channel-last and on contiguous tensors; the faster
   sum is ``library_ms``);
3. direct path: the port's ``predict`` CLI on a synthetic 140-frame ``.mha``
   sweep with the repo's trained weights (base_c 48, hflip TTA), the kernel
   launch counters zeroed just before and read just after; output checks; 6
   frames around the true best frame again on the CPU (plain versions), same
   frame and mask Dice >= 0.98 required;
4. cascade: ``predict --cascade --scout_weights`` (the distilled 128-px
   scout) on the 140-frame sweep and on an 840-frame case (six seeded sweeps
   stacked), launch counts held to what the path implies; a warm engine's
   cascade against its direct path on the same inputs (every one of the six
   sweeps, and the stacked case), with the stage split and the host time of
   the submit and collect halves, and the submit half once more with
   synchronising calls set to raise; the 256-px scout that was trained with
   CLAHE, on the 140-frame sweep; the six sweeps as a directory of cases,
   with and without the submit halves' speculative fixed points;
5. bulk: ``predict_bulk`` on four 140-frame sweeps against four
   ``predict_case`` calls (frames and ACs equal, Dice >= 0.98);
6. container: ``infer-container`` (``MODEL_TAG=att_aspp``) on the 840-frame
   case: the output contract, and 12 of its frames again on the CPU;
7. baseline: ``infer-container`` with ``MODEL_TAG`` unset (the nnU-Net-style
   PlainConvUNet of the in-repo ``plans.json`` at full width, seeded
   initialisation ``BASELINE_SEED``) on the 840-frame case: the output
   contract; a warm ``BaselineEngine`` on the 140-frame sweep and the
   840-frame case (frames/s, stage split, the forward's TFLOP/s, peak
   memory, class shares, 3-D components); card against CPU: the forward on
   2 frames, the postprocess of the 140-frame softmax stack.  K1 does not
   run on this path.

Every path is driven with the launch counters at zero and must have launched
the kernels it runs.  The line before the last is a JSON object with one
entry per kernel; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import csv
import json
import multiprocessing
import os
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parent
PEAK_BF16_FLOPS = 989e12     # H100 SXM dense bf16 tensor-core rate
PEAK_F32_FLOPS = 67e12       # H100 SXM f32 rate outside the tensor cores
PEAK_BYTES = 3.35e12         # H100 SXM HBM3 bytes/s
N_FRAMES, FRAME_HW, SEED = 140, (562, 744), 0
N_SWEEPS = 6                 # seeds 0..5; stacked they are the 840-frame case
SPACING = (0.28, 0.28)
BASE_C = 48                  # the main model's width
MAIN_WEIGHTS = "resources/synthetic/weights.npz"
SCOUT_WEIGHTS = "resources/synthetic_scout_noclahe128/weights.npz"
CLAHE_SCOUT_WEIGHTS = "resources/synthetic_scout/weights.npz"   # 256 px
PLAN_DIR = ("resources/nnUNet_results/Dataset300_ACOptimalSuboptimal/"
            "nnUNetTrainer__nnUNetPlans__2d")
# seed of the baseline's initialisation (no trained nnU-Net checkpoint is in
# the repository): the one infer-container uses without --weights, and one
# that tools/probe_baseline.py shows keeps non-empty 3-D components of both
# classes on the synthetic sweeps
BASELINE_SEED = 0


# label -> (base_c, input size, frames per launch) of K1's shape sets: the
# direct path and tier 2 (a 16-frame micro-batch with its hflip twins), the
# scout tier of an 840-frame case, the ROI path
K1_SHAPE_SETS = {"main": (48, 512, 32), "scout": (16, 128, 128),
                 "roi": (48, 224, 16)}


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
            if "Used " in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")


def phase_k1_set(dev, label):
    """K1 at the eight pair shapes of one shape set.  Returns the sums over
    the eight and the largest |kernel - plain|."""
    import torch
    import torch.nn.functional as F

    from att_aspp_unet_tpu_torch.ops.kernels import fused_conv as fc

    base_c, size, N = K1_SHAPE_SETS[label]
    shapes = fc.model_pairs(base_c, size)
    g = torch.Generator(device=dev).manual_seed(SEED)
    bf = torch.bfloat16
    tot = dict(ms=0.0, plain_ms=0.0, lib_cl=0.0, lib_nchw=0.0, bound_ms=0.0,
               flops=0.0, bytes=0.0)
    max_err = 0.0
    for name, cin, cmid, cout, hw in shapes:
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
            raise AssertionError(f"K1 {label} {name}: {n_bad} outputs "
                                 "outside rtol/atol 2e-2")

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
        log(f"[K1 {label}] {name} N={N} {cin}->{cmid}->{cout} @{hw}^2: "
            f"kernel {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s, "
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
    _, tot["bound_by"] = bound(tot["flops"], tot["bytes"], PEAK_BF16_FLOPS)
    tot["max_abs_err"] = max_err
    log(f"[K1 {label}] all eight pairs (one {N}-frame launch each): kernel "
        f"{tot['ms']:.3f} ms = {tot['flops'] / tot['ms'] / 1e9:.1f} TFLOP/s, "
        f"cuDNN bf16 channel-last {tot['lib_cl']:.3f} ms / NCHW "
        f"{tot['lib_nchw']:.3f} ms, bound {tot['bound_ms']:.3f} ms "
        f"({tot['bound_by']})")
    return tot


def phase_k1(dev):
    """K1 at all three shape sets.  Returns the kernel's JSON entry: the
    main path's sums under the contract's keys, the scout's and the ROI's
    under names of their own."""
    sets = {label: phase_k1_set(dev, label) for label in K1_SHAPE_SETS}
    main = sets["main"]
    entry = {"name": "fused_double_cbr", "route": "cuda",
             "source": "att_aspp_unet_tpu_torch/csrc/fused_double_cbr.cu",
             "replaces": "att_aspp_unet_tpu/ops/pallas/fused_conv.py:140",
             "max_abs_err": max(t["max_abs_err"] for t in sets.values()),
             "ms": main["ms"], "plain_ms": main["plain_ms"],
             "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
             "library_ms": min(main["lib_cl"], main["lib_nchw"])}
    for label in ("scout", "roi"):
        t = sets[label]
        entry.update({f"{label}_ms": t["ms"], f"{label}_plain_ms": t["plain_ms"],
                      f"{label}_bound_ms": t["bound_ms"],
                      f"{label}_bound_by": t["bound_by"],
                      f"{label}_library_ms": min(t["lib_cl"], t["lib_nchw"])})
    return entry


def k2_stacks(dev, sweeps):
    """label -> the uint8 stack that a path hands to CLAHE: the whole sweep
    (direct), the 8 promoted frames of a cascade, the 32 of a bulk group of
    four, the container's 128 subsampled frames of the 840-frame case, the
    sweep at the sizes of the scouts (256 px: the scout that was trained
    with CLAHE; 128 px: tiles of 16 x 16 pixels), and the whole 840-frame
    case at native size (the baseline)."""
    import numpy as np
    import torch

    from att_aspp_unet_tpu_torch.ops.image import (minmax_normalize_u8,
                                                   resize_bilinear)

    def u8(frames):
        return minmax_normalize_u8(torch.as_tensor(frames).to(dev))

    def low(size):
        return minmax_normalize_u8(resize_bilinear(
            torch.as_tensor(sweeps[0]).to(dev).float(), (size, size)))

    case = np.concatenate(sweeps)
    idxs = np.linspace(0, len(case) - 1, 128).astype(int)
    mid = N_FRAMES // 2
    return {"main": u8(sweeps[0]), "cascade": u8(sweeps[0][mid:mid + 8]),
            "bulk": u8(np.concatenate([sw[mid:mid + 8] for sw in sweeps[:4]])),
            "roi": u8(case[idxs]), "scout": low(256), "scout128": low(128),
            "baseline": u8(case)}


def phase_k2(dev, sweeps):
    """K2 on the CLAHE operands of every stack of :func:`k2_stacks`,
    bit-exact.  Returns the kernel's JSON entry: the whole sweep's numbers
    under the contract's keys, the other stacks' under names of their own."""
    import torch

    from att_aspp_unet_tpu_torch.ops.clahe import clahe_finish, clahe_tables
    from att_aspp_unet_tpu_torch.ops.kernels import clahe_interp as ci

    entry = {"name": "clahe_interp", "route": "cuda",
             "source": "att_aspp_unet_tpu_torch/csrc/clahe_interp.cu",
             "replaces": "att_aspp_unet_tpu/ops/pallas/clahe_interp.py:90",
             "max_abs_err": 0.0}
    for label, u8 in k2_stacks(dev, sweeps).items():
        hw = tuple(u8.shape[-2:])
        blocks, luts, wts = clahe_tables(u8)
        got = ci.clahe_interp(blocks, luts, wts)
        torch.cuda.synchronize()
        want = ci.clahe_interp_reference(blocks, luts, wts)
        n_raw = int((got != want).sum())
        entry["max_abs_err"] = max(entry["max_abs_err"],
                                   float((got - want).abs().max()))
        n_u8 = int((clahe_finish(got, hw) != clahe_finish(want, hw)).sum())
        if n_raw or n_u8:
            raise AssertionError(f"K2 {label} is not bit-exact: {n_raw} "
                                 f"blended values, {n_u8} u8 pixels differ")

        idx4 = blocks.clamp(0, 255).long()[..., None].expand(*blocks.shape, 4)
        ms = cuda_ms(lambda: ci.clahe_interp(blocks, luts, wts), 10)
        plain_ms = cuda_ms(
            lambda: ci.clahe_interp_reference(blocks, luts, wts), 3)
        lib_ms = cuda_ms(lambda: (torch.gather(luts, 2, idx4) * wts).sum(-1))
        nbytes = 4 * (blocks.numel() + luts.numel() + wts.numel()
                      + got.numel())
        b_ms, bound_by = bound(7.0 * blocks.numel(), nbytes, PEAK_F32_FLOPS)
        log(f"[K2 {label}] clahe on {tuple(u8.shape)} u8: blocks "
            f"{tuple(blocks.shape)}, 0 blended values and 0 u8 pixels differ "
            f"from the plain version; kernel {ms:.3f} ms "
            f"({nbytes / ms / 1e6:.1f} GB/s), plain {plain_ms:.3f} ms, "
            f"gather+sum {lib_ms:.3f} ms, bound {b_ms:.3f} ms ({bound_by})")
        pre = "" if label == "main" else f"{label}_"
        entry.update({f"{pre}ms": ms, f"{pre}plain_ms": plain_ms,
                      f"{pre}bound_ms": b_ms, f"{pre}bound_by": bound_by,
                      f"{pre}library_ms": lib_ms})
        del blocks, luts, wts, got, want, idx4
        torch.cuda.empty_cache()
    return entry


def reset_launches():
    from att_aspp_unet_tpu_torch.ops.kernels import clahe_interp as ci
    from att_aspp_unet_tpu_torch.ops.kernels import fused_conv as fc

    fc.fused_double_cbr.launches = 0
    ci.clahe_interp.launches = 0


def read_launches(where: str, expect=None):
    """The counters since :func:`reset_launches`; exactly ``expect`` = (K1,
    K2) launches where that is given, and every kernel the path runs (all of
    them without ``expect``) must have launched."""
    from att_aspp_unet_tpu_torch.ops.kernels import clahe_interp as ci
    from att_aspp_unet_tpu_torch.ops.kernels import fused_conv as fc

    got = {"fused_double_cbr": fc.fused_double_cbr.launches,
           "clahe_interp": ci.clahe_interp.launches}
    runs = [v for v, e in zip(got.values(), expect or (1, 1)) if e]
    if not runs or min(runs) <= 0:
        raise AssertionError(f"{where}: a kernel never launched: {got}")
    if expect is not None and tuple(got.values()) != tuple(expect):
        raise AssertionError(f"{where}: launches {got}, the path implies "
                             f"{expect}")
    return got


def forward_launches(n_frames: int, batch: int) -> int:
    """K1 launches of one model forward over ``n_frames`` in micro-batches
    of ``batch`` (hflip twins ride in the same launch): 8 pairs each."""
    return -(-n_frames // batch) * 8


def cascade_launches(n_stack: int, n_promoted: int, tier2_batch: int):
    """(K1, K2) launches of one cascade with the no-CLAHE scout: the scout
    forward over the whole stack, tier 2 over the promoted frames, and CLAHE
    once, on the promoted frames."""
    from att_aspp_unet_tpu_torch.infer.engine import scout_micro_batch

    scout_batch = scout_micro_batch(n_stack, 128, 16)
    return (forward_launches(n_stack, scout_batch)
            + forward_launches(n_promoted, min(tier2_batch, n_promoted)), 1)


def abdomen_frames(n: int, best_true: int):
    """Frames of an ``n``-frame generated sweep that show the abdomen."""
    return [i for i in range(n)
            if 1.0 - abs(i - best_true) / max(n * 0.25, 1) >= 0.25]


def main_config(**predict):
    from att_aspp_unet_tpu_torch.config import (Config, ModelConfig,
                                                PredictConfig)

    return Config(model=ModelConfig(base_c=BASE_C),
                  predict=PredictConfig(tta_hflip=True, **predict))


def load_main():
    """(variables, threshold) of the repo's trained main model."""
    from att_aspp_unet_tpu_torch.utils.npz_weights import load_npz_variables

    thr = float(json.loads((REPO / MAIN_WEIGHTS).with_name("thr.json")
                           .read_text())["best_thr"])
    return load_npz_variables(REPO / MAIN_WEIGHTS), thr


def run_predict_cli(dev, in_dir: Path, out_dir: Path, thr: float, extra=()):
    """The ``predict`` CLI, the launch counters zeroed just before it (the
    caller reads them just after); returns its seconds."""
    from att_aspp_unet_tpu_torch import cli

    argv = ["predict", "--weights", str(REPO / MAIN_WEIGHTS), "--base_c",
            str(BASE_C), "--input_dir", str(in_dir), "--out_dir",
            str(out_dir), "--thr", str(thr), "--device", dev, *extra]
    reset_launches()
    t0 = time.perf_counter()
    rc = cli.main(argv)
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"cli predict {extra}: rc {rc}")
    return wall


def check_case_output(out_dir: Path, case: str, shape, abdomen, where: str):
    """Output checks of one predicted case; returns (frame, AC mm)."""
    import numpy as np

    from att_aspp_unet_tpu_torch.io import read_json, read_mha

    arr = read_mha(out_dir / case /
                   "images/fetal-abdomen-segmentation/output.mha").array
    frame = int(read_json(out_dir / case / "fetal-abdomen-frame-number.json"))
    with open(out_dir / "ac_results.csv", newline="") as f:
        rows = list(csv.reader(f))
    row = next(r for r in rows[1:] if r[0] == case)
    fg_frames = np.flatnonzero(arr.reshape(shape[0], -1).any(axis=1)).tolist()
    ac = float(row[2])
    log(f"[{where}] {case}: output {arr.shape} {arr.dtype} values "
        f"{sorted(np.unique(arr).tolist())}, mask on frames {fg_frames}, "
        f"frame JSON {frame}, csv row {row}")
    if not (arr.shape == tuple(shape) and set(np.unique(arr)) <= {0, 2}
            and fg_frames == [frame] and row[1] == str(frame)
            and np.isfinite(ac) and ac > 0 and frame in abdomen):
        raise AssertionError(f"{where}: predict outputs failed their checks")
    return frame, ac


def dice(a, b) -> float:
    a, b = a > 0, b > 0
    s = int(a.sum()) + int(b.sum())
    return 1.0 if s == 0 else 2.0 * int((a & b).sum()) / s


def fmt_stages(times, n):
    return ", ".join(f"{k} {v:.3f} s" for k, v in times.items()) + \
        f"; sum {sum(times.values()):.3f} s = " \
        f"{n / sum(times.values()):.1f} frames/s"


def phase_slice(dev, sweep, best_true, truth, variables, thr, tmp):
    """The direct path: the predict CLI on the sweep, with the launch
    counters read around it; output checks; the CPU cross-check; the stage
    split."""
    from att_aspp_unet_tpu_torch.infer.engine import AttAsppEngine
    from att_aspp_unet_tpu_torch.io import MetaImage, write_mha

    cfg = main_config()
    n = sweep.shape[0]

    # warm-up on the card (first-call costs: cuDNN/cuBLAS handles, allocator)
    times = {}
    engine = AttAsppEngine(cfg, variables, device=dev, stage_times=times)
    engine.predict_case(sweep[:16], SPACING, thr)

    (tmp / "in140").mkdir()
    write_mha(tmp / "in140/sweep_0.mha",
              MetaImage(sweep, spacing=(0.28, 0.28, 1.0)))
    wall = run_predict_cli(dev, tmp / "in140", tmp / "out_direct", thr)
    # micro-batches of 16 frames with their hflip twins (9 x 8 = 72 launches
    # for 140 frames); one CLAHE over the sweep
    launches = read_launches("direct", (forward_launches(n, 16), 1))
    log(f"[direct] cli predict: {wall:.2f} s for {n} frames = "
        f"{n / wall:.1f} frames/s end to end (read .mha, predict, write); "
        f"kernel launches {launches}")
    abdomen = abdomen_frames(n, best_true)
    frame, ac = check_case_output(tmp / "out_direct", "sweep_0", sweep.shape,
                                  abdomen, "direct")
    log(f"[direct] chosen frame {frame} (generator's best {best_true}, "
        f"abdomen frames {abdomen[0]}..{abdomen[-1]}), AC {ac} mm (analytic "
        f"ring {truth.circumference_px() * 0.28:.1f} mm at the best frame)")

    # stage split on a warm engine, same sweep
    times.clear()
    t0 = time.perf_counter()
    f_gpu_full, _, ac_full = engine.predict_case(sweep, SPACING, thr)
    tot = time.perf_counter() - t0
    log(f"[direct] engine stages for {n} frames: {fmt_stages(times, n)}; "
        f"wall {tot:.3f} s = {n / tot:.1f} frames/s")
    if f_gpu_full != frame:
        raise AssertionError(f"engine rerun picked {f_gpu_full}, CLI {frame}")
    if check_submit_reads_nothing(engine, sweep, thr, "direct")[0] != frame:
        raise AssertionError("direct: the checked submit picked another frame")

    # the same slice with the plain versions on the CPU, 6 frames
    lo = max(0, best_true - 3)
    sub = sweep[lo:lo + 6]
    t0 = time.perf_counter()
    f_cpu, m_cpu, ac_cpu = AttAsppEngine(cfg, variables, device="cpu") \
        .predict_case(sub, SPACING, thr)
    t_cpu = time.perf_counter() - t0
    engine.stage_times = None
    f_gpu, m_gpu, ac_gpu = engine.predict_case(sub, SPACING, thr)
    d = dice(m_cpu, m_gpu)
    log(f"[direct] 6 frames {lo}..{lo + 5}: card frame {lo + f_gpu} AC "
        f"{ac_gpu:.2f} mm, CPU plain frame {lo + f_cpu} AC {ac_cpu:.2f} mm "
        f"({t_cpu:.1f} s), mask Dice {d:.5f}, "
        f"{int(((m_cpu > 0) != (m_gpu > 0)).sum())} pixels differ")
    if f_cpu != f_gpu or d < 0.98:
        raise AssertionError("card and CPU plain versions disagree")
    return launches, engine, (frame, ac_full)


def timed_case(engine, sweep, thr):
    """One warm ``predict_case`` in its two halves, no stage syncs: (result,
    seconds of the submit call on the host, of the collect call, of both)."""
    import torch

    engine.stage_times = None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    handle = engine.predict_case_submit(sweep, thr)
    t1 = time.perf_counter()
    out = engine.predict_case_collect(handle, SPACING)
    t2 = time.perf_counter()
    return out, t1 - t0, t2 - t1, t2 - t0


def check_submit_reads_nothing(engine, data, thr, label, bulk=False):
    """A submit half on an input that already lies on the card, with
    PyTorch's synchronisation debug mode set to raise: any read-back or wait
    for the device inside it fails the run.  Prints when the call returned
    and when the device had finished."""
    import torch

    submit = engine.predict_bulk_submit if bulk else engine.predict_case_submit
    collect = (engine.predict_bulk_collect if bulk
               else engine.predict_case_collect)
    on_card = torch.as_tensor(data).to(engine.device)
    engine.stage_times = None
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        handle = submit(on_card, thr)
        t1 = time.perf_counter()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    out = collect(handle, SPACING)
    log(f"[{label}] submit half with the input on the card, synchronising "
        f"calls set to raise: returned after {t1 - t0:.3f} s, the device "
        f"finished after {t2 - t0:.3f} s; cases repeated with the exact "
        f"loops so far: {engine.exact_repeats}")
    return out


def explain_disagreement(direct_engine, cascade_engine, sweep, thr, frames):
    """Tier-1 and tier-2 rank areas of ``frames``, for the record."""
    import torch

    from att_aspp_unet_tpu_torch.infer import engine as te

    p, pc = cascade_engine.cfg.preprocess, cascade_engine.cfg.predict
    with torch.no_grad():
        sub = torch.as_tensor(sweep[list(frames)]).to(direct_engine.device)
        low = cascade_engine._scout_img_size or pc.cascade_img_size
        x = te.enhance_frames(
            te.resize_bilinear(sub.float(), (low, low)),
            p.clahe_clip if cascade_engine._scout_clahe else 0.0,
            p.clahe_grid, p.median_kernel).float() / 255.0
        probs = te.predict_sweep_probs(cascade_engine.scout_model, x,
                                       len(frames), hflip=False)
        tier1 = te.candidate_rank_areas(
            te._threshold(probs, cascade_engine._scout_thr or thr),
            pc.close_kernel)
        tier2 = te.candidate_rank_areas(
            te._threshold(direct_engine.predict_full(sub), thr),
            pc.close_kernel)
    return {f: (int(a), int(b)) for f, a, b in
            zip(frames, tier1.tolist(), tier2.tolist())}


def phase_cascade(dev, sweeps, bests, variables, thr, tmp, direct_engine,
                  direct_140):
    """The cascade with the distilled scout: the CLI on the 140-frame sweep
    and on the 840-frame case, then a warm engine against the direct path."""
    import numpy as np

    from att_aspp_unet_tpu_torch.infer.engine import AttAsppEngine
    from att_aspp_unet_tpu_torch.io import MetaImage, write_mha

    scout = str(REPO / SCOUT_WEIGHTS)
    flags = ["--cascade", "--scout_weights", scout]
    n = N_FRAMES
    case = np.concatenate(sweeps)                          # (840, H, W)
    n_case = case.shape[0]
    abdomen_case = [k * n + i for k, b in enumerate(bests)
                    for i in abdomen_frames(n, b)]
    (tmp / "in840").mkdir()
    write_mha(tmp / "in840/case_840.mha",
              MetaImage(case, spacing=(0.28, 0.28, 1.0)))
    totals = {"fused_double_cbr": 0, "clahe_interp": 0}

    # scout: ceil(N / b) micro-batches x 8 pairs (b = 32 for 140 frames:
    # 40 launches; 128 for 840: 56); tier 2: one micro-batch of the 8
    # promoted frames with their hflip twins (8 launches); K2 once, on the
    # promoted frames (the scout was trained without CLAHE)
    for label, in_dir, shape, abdomen in (
            ("sweep_0", "in140", sweeps[0].shape, abdomen_frames(n, bests[0])),
            ("case_840", "in840", case.shape, abdomen_case)):
        out = tmp / f"out_cascade_{label}"
        wall = run_predict_cli(dev, tmp / in_dir, out, thr, flags)
        launches = read_launches(f"cascade {label}",
                                 cascade_launches(shape[0], 8, 16))
        for k, v in launches.items():
            totals[k] += v
        log(f"[cascade] cli predict --cascade on {label}: {wall:.2f} s for "
            f"{shape[0]} frames = {shape[0] / wall:.1f} frames/s end to end; "
            f"kernel launches {launches}")
        check_case_output(out, label, shape, abdomen, "cascade")

    # warm engines on the same inputs: cascade against direct
    times = {}
    engine = AttAsppEngine(
        main_config(cascade=True, cascade_scout_weights=scout), variables,
        device=dev, stage_times=times)
    log(f"[cascade] scout: base_c {engine.scout_model.cfg.base_c} at "
        f"{engine._scout_img_size}^2, CLAHE {engine._scout_clahe}, "
        f"threshold {engine._scout_thr}")
    engine.predict_case(sweeps[0][:32], SPACING, thr)            # warm-up
    results = {}
    for label, data, direct in (("140", sweeps[0], direct_140),
                                ("840", case, None)):
        nn = data.shape[0]
        times.clear()
        engine.stage_times = times
        engine.predict_case(data, SPACING, thr)
        log(f"[cascade] engine stages for {nn} frames: "
            f"{fmt_stages(times, nn)}")
        (f_c, m_c, ac_c), t_sub, t_col, t_all = timed_case(engine, data, thr)
        (f_d, _, ac_d), d_sub, d_col, d_all = timed_case(direct_engine, data,
                                                          thr)
        if direct is not None and (f_d, ac_d) != direct:
            raise AssertionError("the direct path is not repeatable")
        log(f"[cascade] {nn} frames, warm, no stage syncs: cascade "
            f"{t_all:.3f} s = {nn / t_all:.1f} frames/s (submit call "
            f"{t_sub:.3f} s on the host, collect {t_col:.3f} s), frame "
            f"{f_c}, AC {ac_c:.2f} mm; direct {d_all:.3f} s = "
            f"{nn / d_all:.1f} frames/s (submit {d_sub:.3f} s, collect "
            f"{d_col:.3f} s), frame {f_d}, AC {ac_d:.2f} mm; cascade is "
            f"x{d_all / t_all:.2f}")
        if check_submit_reads_nothing(engine, data, thr,
                                      f"cascade {nn}")[0] != f_c:
            raise AssertionError("cascade: the checked submit picked "
                                 "another frame")
        agree = f_c == f_d and abs(ac_c - ac_d) <= 0.1
        if not agree:
            areas = explain_disagreement(direct_engine, engine, data, thr,
                                         sorted({f_c, f_d}))
            log(f"[cascade] {nn} frames: cascade and direct DISAGREE: "
                f"cascade frame {f_c} AC {ac_c:.2f}, direct frame {f_d} AC "
                f"{ac_d:.2f}; (tier-1, tier-2) rank areas by frame: {areas}")
        if f_c not in (abdomen_frames(n, bests[0]) if label == "140"
                       else abdomen_case) or not m_c.any():
            raise AssertionError(f"cascade {label}: frame {f_c} shows no "
                                 "abdomen")
        results[label] = agree
    # the other five sweeps, each against the direct path
    for k in range(1, N_SWEEPS):
        (f_c, m_c, ac_c), _, _, _ = timed_case(engine, sweeps[k], thr)
        (f_d, _, ac_d), _, _, _ = timed_case(direct_engine, sweeps[k], thr)
        results[f"sweep {k}"] = f_c == f_d and abs(ac_c - ac_d) <= 0.1
        log(f"[cascade] sweep {k}: cascade frame {f_c} AC {ac_c:.2f} mm, "
            f"direct frame {f_d} AC {ac_d:.2f} mm")
        if not results[f"sweep {k}"]:
            areas = explain_disagreement(direct_engine, engine, sweeps[k],
                                         thr, sorted({f_c, f_d}))
            log(f"[cascade] sweep {k}: cascade and direct DISAGREE; "
                f"(tier-1, tier-2) rank areas by frame: {areas}")
        if f_c not in abdomen_frames(n, bests[k]) or not m_c.any():
            raise AssertionError(f"cascade sweep {k}: frame {f_c} shows no "
                                 "abdomen")
    log(f"[cascade] agreement with the direct path (same frame, AC within "
        f"0.1 mm) on {sum(results.values())} of {len(results)} inputs: "
        f"{results}; cases that repeated steps with the exact loops: cascade "
        f"engine {engine.exact_repeats}, direct engine "
        f"{direct_engine.exact_repeats}")

    # the scout that was trained with CLAHE, at 256 px: K2 runs twice, on
    # every frame at the scout's size (tiles of 32 x 32 pixels) and on the
    # promoted frames at native size
    clahe_engine = AttAsppEngine(
        main_config(cascade=True,
                    cascade_scout_weights=str(REPO / CLAHE_SCOUT_WEIGHTS)),
        variables, device=dev)
    clahe_engine.predict_case(sweeps[0][:32], SPACING, thr)      # warm-up
    reset_launches()
    (f_s, m_s, ac_s), _, _, t_all = timed_case(clahe_engine, sweeps[0], thr)
    k1_launches, _ = cascade_launches(n, 8, 16)
    launches = read_launches("cascade, CLAHE scout", (k1_launches, 2))
    for k, v in launches.items():
        totals[k] += v
    log(f"[cascade] CLAHE scout (base_c "
        f"{clahe_engine.scout_model.cfg.base_c} at "
        f"{clahe_engine._scout_img_size}^2, CLAHE "
        f"{clahe_engine._scout_clahe}) on {n} frames: {t_all:.3f} s = "
        f"{n / t_all:.1f} frames/s, frame {f_s}, AC {ac_s:.2f} mm; kernel "
        f"launches {launches}")
    if f_s not in abdomen_frames(n, bests[0]) or not m_s.any():
        raise AssertionError(f"cascade, CLAHE scout: frame {f_s} shows no "
                             "abdomen")
    return totals, engine


def phase_directory(sweeps, thr, tmp, direct_engine, cascade_engine):
    """The six sweeps as a directory of cases through ``predict_directory``
    (one case or group in flight while the previous one's host tail runs),
    with the submit halves' speculative fixed points and with the exact
    loops, in the order on, off, off, on after a warm-up run: what the speculation is worth where
    several cases are in flight."""
    from att_aspp_unet_tpu_torch.infer.predict_cli import predict_directory
    from att_aspp_unet_tpu_torch.io import MetaImage, write_mha

    reset_launches()
    (tmp / "in6").mkdir()
    for k, sw in enumerate(sweeps):
        write_mha(tmp / f"in6/sweep_{k}.mha",
                  MetaImage(sw, spacing=(0.28, 0.28, 1.0)), compressed=False)
    n = sum(sw.shape[0] for sw in sweeps)
    for label, engine, bulk in (("direct", direct_engine, 0),
                                ("cascade", cascade_engine, 0),
                                ("cascade, bulk groups of 3", cascade_engine,
                                 3)):
        engine.stage_times = None
        secs = {True: [], False: []}
        rows = {}
        # one run to warm the files and the allocator, then the four
        for run, spec in enumerate((None, True, False, False, True)):
            engine.speculate = spec is not False
            before = engine.exact_repeats
            t0 = time.perf_counter()
            rows[run] = predict_directory(
                engine.cfg, None, tmp / "in6", tmp / f"out6_{run}",
                threshold=thr, bulk_group=bulk, log=lambda *a: None,
                engine=engine)
            if spec is not None:
                secs[spec].append(time.perf_counter() - t0)
            repeats = engine.exact_repeats - before
        engine.speculate = True
        if any(rows[r] != rows[0] for r in rows) or len(rows[0]) != len(sweeps):
            raise AssertionError(f"directory, {label}: the runs' rows differ")
        log(f"[directory] {label}: {len(sweeps)} cases, {n} frames; "
            f"speculative fixed points {secs[True][0]:.3f} and "
            f"{secs[True][1]:.3f} s, exact loops {secs[False][0]:.3f} and "
            f"{secs[False][1]:.3f} s: x"
            f"{sum(secs[False]) / sum(secs[True]):.3f}; "
            f"{n / min(secs[True]):.1f} frames/s at best; cases repeated in "
            f"the last speculative run: {repeats}; rows equal: "
            f"{[(r[1], r[2]) for r in rows[0]]}")
    return read_launches("directory")


def phase_bulk(dev, sweeps, thr, engine):
    """``predict_bulk`` on four sweeps against four ``predict_case`` calls
    of the same warm cascade engine."""
    import numpy as np
    import torch

    S = 4
    group = np.stack(sweeps[:S])
    engine.stage_times = None
    engine.predict_bulk(group, SPACING, thr)                     # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    singles = [engine.predict_case(sw, SPACING, thr) for sw in sweeps[:S]]
    t_single = time.perf_counter() - t0
    reset_launches()
    t0 = time.perf_counter()
    handle = engine.predict_bulk_submit(group, thr)
    t1 = time.perf_counter()
    bulk = engine.predict_bulk_collect(handle, SPACING)
    t_bulk = time.perf_counter() - t0
    # 4 x 144 frames (140 padded to the frame batch) in scout batches of 128
    # -> 5 x 8; 32 promoted frames in two tier-2 batches of 16 -> 2 x 8; K2
    # once over the 32 promoted frames
    n_pad = -(-N_FRAMES // 16) * 16
    launches = read_launches("bulk", cascade_launches(S * n_pad, S * 8, 16))
    checked = check_submit_reads_nothing(engine, group, thr, "bulk", bulk=True)
    if [c[0] for c in checked] != [b[0] for b in bulk]:
        raise AssertionError("bulk: the checked submit picked other frames")
    n_diff = []
    for s, ((fb, mb, acb), (fs, ms_, acs)) in enumerate(zip(bulk, singles)):
        d = dice(mb, ms_)
        n_diff.append(int(((mb > 0) != (ms_ > 0)).sum()))
        if fb != fs or round(acb, 1) != round(acs, 1) or d < 0.98:
            raise AssertionError(
                f"bulk sweep {s}: frame {fb} AC {acb} against per-case "
                f"frame {fs} AC {acs}, Dice {d:.5f}")
    log(f"[bulk] S={S} sweeps of {N_FRAMES} frames: bulk {t_bulk:.3f} s = "
        f"{S / t_bulk:.2f} sweeps/s (submit call {t1 - t0:.3f} s), "
        f"{S} predict_case calls {t_single:.3f} s = {S / t_single:.2f} "
        f"sweeps/s, bulk is x{t_single / t_bulk:.2f}; frames "
        f"{[b[0] for b in bulk]} and ACs {[round(b[2], 1) for b in bulk]} "
        f"mm equal, mask pixels that differ per sweep {n_diff}; kernel "
        f"launches {launches}; cases that repeated steps with the exact "
        f"loops so far: {engine.exact_repeats}")
    return launches


def phase_container(dev, case, abdomen_case, variables, tmp):
    """``infer-container`` on the 840-frame case, then 12 of its frames on
    the CPU with the plain versions."""
    import numpy as np

    from att_aspp_unet_tpu_torch import cli
    from att_aspp_unet_tpu_torch.config import (Config, ContainerConfig,
                                                ModelConfig)
    from att_aspp_unet_tpu_torch.infer import container
    from att_aspp_unet_tpu_torch.io import (MetaImage, read_json, read_mha,
                                            write_mha)

    n = case.shape[0]
    src = tmp / "cin/images/stacked-fetal-ultrasound"
    src.mkdir(parents=True)
    write_mha(src / "case_840.mha", MetaImage(case, spacing=(0.28,) * 3),
              compressed=False)
    os.environ["MODEL_TAG"], os.environ["CASE_ID"] = "att_aspp", "case-840"
    argv = ["infer-container", "--input", str(tmp / "cin"), "--output",
            str(tmp / "cout"), "--weights", str(REPO / MAIN_WEIGHTS),
            "--base_c", str(BASE_C), "--device", dev,
            "--no-save-probabilities", "--no-debug-frames"]
    reset_launches()
    t0 = time.perf_counter()
    rc = cli.main(argv)
    wall = time.perf_counter() - t0
    # 128 subsampled frames in 8 micro-batches of 16 x 8 pairs, no TTA; one
    # CLAHE over the 128 frames
    n_sub = min(128, n)
    launches = read_launches("container", (forward_launches(n_sub, 16), 1))
    vol = read_mha(tmp / "cout/images/fetal-abdomen-segmentation/case-840.mha")
    frame = read_json(tmp / "cout/fetal-abdomen-frame-number.json")
    arr = vol.array
    fg = np.flatnonzero(arr.reshape(n, -1).any(axis=1)).tolist()
    idxs = np.linspace(0, n - 1, n_sub).astype(int)
    log(f"[container] infer-container: rc {rc}, {wall:.2f} s for {n} frames "
        f"(read, ROI path on {n_sub} of them, write compressed, read back); "
        f"volume {arr.shape} {arr.dtype} values "
        f"{sorted(np.unique(arr).tolist())}, spacing {vol.spacing}, mask on "
        f"frames {fg}, frame JSON {frame}, {int(arr.sum())} mask pixels; "
        f"kernel launches {launches}")
    if not (rc == 0 and arr.shape == case.shape and arr.dtype == np.uint8
            and set(np.unique(arr)) <= {0, 1} and fg == [frame]
            and all(abs(v - 0.28) < 1e-9 for v in vol.spacing)
            and frame in idxs and arr.any()):
        raise AssertionError("container outputs failed their contract")
    # the ROI path takes the frame with the most pixels above 0.05; whether
    # that frame shows the abdomen depends on the weights, which were trained
    # on whole frames at 512x512 and not on 224x224 crops
    log(f"[container] frame {frame} lies "
        f"{'inside' if frame in abdomen_case else 'outside'} the generator's "
        "abdomen ranges")

    # every 10th frame around the chosen one (up to 12), card against the
    # CPU's plain versions
    picks = [int(i) for i in frame + 10 * np.arange(-6, 6) if 0 <= i < n]
    sub = tmp / "csub/images/stacked-fetal-ultrasound"
    sub.mkdir(parents=True)
    write_mha(sub / "sub.mha", MetaImage(case[picks], spacing=(0.28,) * 3))
    got = {}
    for device in (dev, "cpu"):
        cfg = Config(model=ModelConfig(base_c=BASE_C), container=ContainerConfig(
            input_path=str(tmp / "csub"), output_path=str(tmp / f"o_{device}"),
            model_tag="att_aspp", case_id="sub"))
        t0 = time.perf_counter()
        container.run(cfg, variables, save_probabilities=False,
                      debug_frames=False, device=device, log=lambda *a: None)
        got[device] = (
            read_json(tmp / f"o_{device}/fetal-abdomen-frame-number.json"),
            read_mha(tmp / f"o_{device}/images/fetal-abdomen-segmentation/"
                     "sub.mha").array, time.perf_counter() - t0)
    (f_g, m_g, _), (f_c, m_c, t_cpu) = got[dev], got["cpu"]
    d = dice(m_g, m_c)
    log(f"[container] frames {picks} as a case of their own: card frame "
        f"{picks[f_g]}, CPU plain frame {picks[f_c]} ({t_cpu:.1f} s), mask "
        f"Dice {d:.5f}, "
        f"{int((m_g != m_c).sum())} pixels differ")
    if f_g != f_c or d < 0.98:
        raise AssertionError("container: card and CPU plain versions "
                             "disagree")
    return launches


def baseline_config(compute_dtype: str = "bfloat16"):
    """The port's configuration with the in-repo nnU-Net plan (7 stages,
    base 32 capped at 512, patch 448 x 576, 3 classes)."""
    import dataclasses

    from att_aspp_unet_tpu_torch.config import Config
    from att_aspp_unet_tpu_torch.utils.nnunet_import import load_plans_config

    pu = load_plans_config(REPO / PLAN_DIR / "plans.json",
                           dataset_json=REPO / PLAN_DIR / "dataset.json")
    return Config(plain_unet=dataclasses.replace(pu,
                                                 compute_dtype=compute_dtype))


def plain_unet_flops(pu) -> float:
    """2 x multiply-adds of one PlainConvUNet forward over a patch: the 3x3
    convs (stride 2 where a stage begins), the 2x2 stride-2 transposed convs
    and the 1x1 head."""
    h, w = pu.patch_size
    feats = [min(pu.base_c * 2 ** s, pu.max_c) for s in range(pu.n_stages)]
    px = [(h >> s) * (w >> s) for s in range(pu.n_stages)]
    total, cin = 0.0, pu.in_channels
    for s, f in enumerate(feats):
        total += 2 * 9 * (cin + (pu.conv_per_stage - 1) * f) * f * px[s]
        cin = f
    for s in range(pu.n_stages - 2, -1, -1):
        f = feats[s]
        total += 2 * feats[s + 1] * f * px[s]
        total += 2 * 9 * (2 * f + (pu.conv_per_stage - 1) * f) * f * px[s]
    return total + 2 * feats[0] * pu.num_classes * px[0]


def phase_baseline(dev, sweep, case, tmp):
    """The nnU-Net-style baseline, the container's default model, at the
    full width of the in-repo plan with the seeded initialisation: the
    ``infer-container`` CLI with ``MODEL_TAG`` unset on the 840-frame case,
    a warm engine on 140 and 840 frames, card against CPU."""
    import numpy as np
    import torch

    from att_aspp_unet_tpu_torch import cli
    from att_aspp_unet_tpu_torch.infer.container import \
        select_labeled_mask_and_frame
    from att_aspp_unet_tpu_torch.infer.engine import BaselineEngine
    from att_aspp_unet_tpu_torch.io import (MetaImage, read_json, read_mha,
                                            write_mha)
    from att_aspp_unet_tpu_torch.models import PlainConvUNet
    from att_aspp_unet_tpu_torch.models.sliding_window import \
        compute_tile_starts
    from att_aspp_unet_tpu_torch.postprocess import cc
    from att_aspp_unet_tpu_torch.postprocess.refine import \
        postprocess_softmax_stack
    from att_aspp_unet_tpu_torch.tools.probe_baseline import (
        count_iterations, thresholded_labels)

    n = case.shape[0]
    cfg = baseline_config()
    pu = cfg.plain_unet
    src = tmp / "bin/images/stacked-fetal-ultrasound"
    src.mkdir(parents=True)
    write_mha(src / "case_840.mha", MetaImage(case, spacing=(0.28,) * 3),
              compressed=False)
    os.environ.pop("MODEL_TAG", None)
    os.environ["CASE_ID"] = "case-840"
    argv = ["infer-container", "--input", str(tmp / "bin"), "--output",
            str(tmp / "bout"), "--plans", str(REPO / PLAN_DIR / "plans.json"),
            "--dataset-json", str(REPO / PLAN_DIR / "dataset.json"),
            "--device", dev,
            "--no-save-probabilities", "--no-debug-frames"]
    reset_launches()
    t0 = time.perf_counter()
    rc = cli.main(argv)
    wall = time.perf_counter() - t0
    # no K1 (conv + InstanceNorm is not K1's conv + folded BN); one CLAHE
    # over the whole case
    launches = read_launches("baseline", (0, 1))
    vol = read_mha(tmp / "bout/images/fetal-abdomen-segmentation/case-840.mha")
    frame = read_json(tmp / "bout/fetal-abdomen-frame-number.json")
    arr = vol.array
    fg = np.flatnonzero(arr.reshape(n, -1).any(axis=1)).tolist()
    log(f"[baseline] infer-container, MODEL_TAG unset: rc {rc}, {wall:.2f} s "
        f"for {n} frames (read, PlainConvUNet {pu.base_c}->{pu.max_c}, "
        f"{pu.n_stages} stages, patch {pu.patch_size[0]}x{pu.patch_size[1]}, "
        f"seed {BASELINE_SEED}, write compressed, read back); volume "
        f"{arr.shape} {arr.dtype} values {sorted(np.unique(arr).tolist())}, "
        f"spacing {vol.spacing}, mask on frames {fg}, frame JSON {frame}, "
        f"{int(arr.sum())} mask pixels; kernel launches {launches}")
    if not (rc == 0 and arr.shape == case.shape and arr.dtype == np.uint8
            and set(np.unique(arr)) <= {0, 1}
            and all(abs(v - 0.28) < 1e-9 for v in vol.spacing)
            and (fg == [frame] if frame >= 0 else not arr.any())):
        raise AssertionError("baseline container outputs failed their "
                             "contract")
    totals = dict(launches)

    # a warm engine: frames/s, stage split, TFLOP/s, peak memory
    tiles = len(compute_tile_starts(case.shape[1], pu.patch_size[0],
                                    pu.tile_step)) * \
        len(compute_tile_starts(case.shape[2], pu.patch_size[1],
                                pu.tile_step))
    frame_flops = tiles * (4 if pu.use_mirroring else 1) * plain_unet_flops(pu)
    times = {}
    engine = BaselineEngine(
        cfg, PlainConvUNet.from_config(pu, seed=BASELINE_SEED), device=dev,
        stage_times=times)
    engine.postprocess(engine.predict(sweep[:8]))                # warm-up
    kept = {}
    for label, data in (("140", sweep), ("840", case)):
        nn = data.shape[0]
        times.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        with count_iterations() as iters:
            t0 = time.perf_counter()
            probs = engine.predict(data)
            seg = engine.postprocess(probs)
            _, f = select_labeled_mask_and_frame(seg)
            t = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        for k, v in read_launches(f"baseline engine {nn}", (0, 1)).items():
            totals[k] += v
        raw = thresholded_labels(probs)
        stats = []
        for lab in (1, 2):
            m = raw == lab
            comps = len(torch.unique(cc.label_components(m, 6, ndim=3))) - 1
            stats.append(f"class {lab}: {float(m.float().mean()):.5f} of the "
                         f"voxels, {comps} 3-D components, "
                         f"{int((seg == lab).sum())} voxels kept")
        fwd = times["forward"]
        log(f"[baseline] warm engine, {nn} frames: {t:.3f} s = "
            f"{nn / t:.2f} frames/s; stages {fmt_stages(times, nn)}; forward "
            f"{frame_flops * nn / 1e12:.2f} TFLOP ({tiles} tiles x 4 mirrors "
            f"x {plain_unet_flops(pu) / 1e9:.1f} GFLOP per frame) in "
            f"{fwd:.3f} s = {frame_flops * nn / fwd / 1e12:.1f} TFLOP/s "
            f"({100 * frame_flops * nn / fwd / PEAK_BF16_FLOPS:.1f} % of the "
            f"bf16 peak); peak memory {peak:.2f} GiB; propagation iterations "
            f"{iters}; frame {f}; after the threshold {'; '.join(stats)}")
        if label == "140":
            probs140, seg140, f140 = probs, seg, f
        kept[label] = int((seg > 0).sum())
        del probs, seg, raw
        torch.cuda.empty_cache()
    if not any(kept.values()):
        raise AssertionError(f"seed {BASELINE_SEED} leaves every class "
                             "empty: the postprocess does no work")

    # card against CPU: the forward on 2 frames (the card's bf16 and, TF32
    # off, f32 forwards against the CPU's f32), and the postprocess of the
    # card's 140-frame softmax stack
    lo = min(max(f140, 0), sweep.shape[0] - 2)
    sub = sweep[lo:lo + 2]
    engine.stage_times = None
    card_bf = engine.predict(sub).cpu()
    cfg32 = baseline_config("float32")
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        card32 = BaselineEngine(cfg32, PlainConvUNet.from_config(
            cfg32.plain_unet, seed=BASELINE_SEED), device=dev).predict(sub).cpu()
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    t0 = time.perf_counter()
    cpu32 = BaselineEngine(cfg32, PlainConvUNet.from_config(
        cfg32.plain_unet, seed=BASELINE_SEED), device="cpu").predict(sub)
    t_fwd = time.perf_counter() - t0
    d32 = float((card32 - cpu32).abs().max())
    dbf = (card_bf - cpu32).abs()
    agree = float((thresholded_labels(card_bf)
                   == thresholded_labels(cpu32)).float().mean())
    log(f"[baseline] frames {lo}..{lo + 1}, softmax: card f32 (TF32 off) vs "
        f"CPU f32 max |diff| {d32:.3g} (tolerance 1e-3); card bf16 vs CPU "
        f"f32 max |diff| {float(dbf.max()):.3g}, mean {float(dbf.mean()):.3g} "
        f"(tolerance 1e-2), thresholded labels equal on {100 * agree:.3f} % "
        f"of the pixels (tolerance 99 %); CPU forward {t_fwd:.1f} s")
    if d32 > 1e-3 or float(dbf.mean()) > 1e-2 or agree < 0.99:
        raise AssertionError("baseline: card and CPU forwards disagree")
    t0 = time.perf_counter()
    seg_cpu = postprocess_softmax_stack(probs140.cpu(), 0.5)
    t_post = time.perf_counter() - t0
    _, f_cpu = select_labeled_mask_and_frame(seg_cpu)
    n_diff = int((seg_cpu != seg140.cpu()).sum())
    log(f"[baseline] postprocess of the card's 140-frame softmax stack on the "
        f"CPU ({t_post:.1f} s): {n_diff} labels differ from the card's; "
        f"frame {f_cpu} on the CPU, {f140} on the card")
    if n_diff or f_cpu != f140:
        raise AssertionError("baseline: card and CPU postprocess disagree")
    return totals


def make_seeded_sweep(seed: int):
    from att_aspp_unet_tpu_torch.tools.synthetic import make_sweep

    return make_sweep(N_FRAMES, *FRAME_HW, seed=seed)


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
    import numpy as np

    dev = "cuda"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t_start = time.perf_counter()
    # the six sweeps are generated by worker processes (numpy only) while
    # the kernels build and the K1 phase runs
    with ProcessPoolExecutor(
            max_workers=N_SWEEPS,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        futures = [pool.submit(make_seeded_sweep, SEED + k)
                   for k in range(N_SWEEPS)]
        phase_build()
        k1 = phase_k1(dev)
        t0 = time.perf_counter()
        made = [f.result() for f in futures]
    sweeps = [m[0] for m in made]
    bests = [m[1] for m in made]
    log(f"[data] {N_SWEEPS} synthetic sweeps {sweeps[0].shape} seeds "
        f"{SEED}..{SEED + N_SWEEPS - 1}, best frames {bests} (waited "
        f"{time.perf_counter() - t0:.1f} s after the K1 phase)")
    k2 = phase_k2(dev, sweeps)
    variables, thr = load_main()
    totals = {"fused_double_cbr": 0, "clahe_interp": 0}

    def add(launches):
        for k, v in launches.items():
            totals[k] += v

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        launches, direct_engine, direct_140 = phase_slice(
            dev, sweeps[0], bests[0], made[0][2], variables, thr, tmp)
        add(launches)
        launches, cascade_engine = phase_cascade(
            dev, sweeps, bests, variables, thr, tmp, direct_engine,
            direct_140)
        add(launches)
        add(phase_bulk(dev, sweeps, thr, cascade_engine))
        add(phase_directory(sweeps, thr, tmp, direct_engine, cascade_engine))
        del direct_engine, cascade_engine
        torch.cuda.empty_cache()
        case = np.concatenate(sweeps)
        abdomen_case = [k * N_FRAMES + i for k, b in enumerate(bests)
                        for i in abdomen_frames(N_FRAMES, b)]
        add(phase_container(dev, case, abdomen_case, variables, tmp))
        add(phase_baseline(dev, sweeps[0], case, tmp))
    k1["launches"] = totals["fused_double_cbr"]
    k2["launches"] = totals["clahe_interp"]
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(f"gpu: {smi}")
    print(json.dumps({"kernels": [k1, k2]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
