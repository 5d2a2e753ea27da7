#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

    python3 chip_smoke.py --save-int8-scales out/int8_scales.npz

    python3 chip_smoke.py --only swin

    python3 chip_smoke.py --only baseline

Phases (any failure exits non-zero and prints no result line):

1. build the hand-written kernels from ``att_aspp_unet_tpu_torch/csrc``
   (one ``nvcc`` per source, in parallel): K1 ``fused_double_cbr``, K2
   ``clahe_interp``, K3 ``int8_conv3x3``;
2. hold each kernel against its plain PyTorch version on the card at the
   shapes the serving paths give it — K1 ``fused_double_cbr`` at the eight
   conv-pair shapes of the base_c 48 model at 512x512 (N = 32; N = 2, a PNG
   frame with its hflip twin; N = 1, one frame's psi maps; N = 8, the
   variants' forward), of the base_c 16 scout at 128x128 (N = 128) and of
   the base_c 48 model on the 224x224 ROI (N = 16), bf16 channel-last
   tensors, rtol/atol 2e-2, the line of each pair naming the path it took
   (wgmma or mma.sync); K2 ``clahe_interp`` through CLAHE's own tables,
   bit-exact, on the 140 x 562 x 744 sweep, on the 8, 32 and 128 native
   frames that the cascade, the bulk path and the container enhance, on the
   sweep at 256 x 256 and 128 x 128 (a scout's CLAHE: tiles of 32 x 32 and
   16 x 16 pixels), on the whole 840 x 562 x 744 case (the baseline), on one
   native frame (a PNG), on the calibrate phase's 16 x 562 x 744 and
   16 x 480 x 640 groups and on the train steps' 8 x 512 x 512 and
   4 x 128 x 128 batches — and time
   kernel, plain version and a library yardstick (for K1 cuDNN's
   bf16 convolutions on channel-last and on contiguous tensors; the faster
   sum is ``library_ms``); K1's calibration launches (the int8 path's
   absmax of the intermediate) against the plain version's max at the main
   shapes, their output equal to the served launch's, and timed; K3 at the
   sixteen conv shapes of the direct path's 32-frame micro-batch, a
   cascade's 16-frame tier-2 micro-batch and the ROI path's 16 crops (and
   the ``--no_aspp`` bridge conv), each pair as the int8 model serves it
   (the first conv's result quantized to int8 with the second conv's scale,
   the second conv reading that int8 tensor): int32 accumulators exact from
   a bf16 and from an int8 input on both paths, bf16 outputs within one ulp
   of the plain version, the int8 intermediate bit-equal to ``quantize_act``
   of the plain bf16 result; each conv's line names its path (wgmma with
   its output channels a pass, or mma.sync) and its bound, the set's line
   the bound of both forms (int8 intermediate, and bf16 in and out per
   conv); timed beside the bf16 form and im2col + ``torch._int_mm``
   (cuBLASLt's int8 GEMM) as ``library_ms``;
3. direct path: the port's ``predict`` CLI on a synthetic 140-frame ``.mha``
   sweep with the repo's trained weights (base_c 48, hflip TTA), the kernel
   launch counters zeroed just before and read just after; output checks; 6
   frames around the true best frame again on the CPU (plain versions), same
   frame and mask Dice >= 0.98 required;
4. cascade: ``predict --cascade --scout_weights`` (the distilled 128-px
   scout) on the 140-frame sweep and on an 840-frame case (six seeded sweeps
   stacked), launch counts held to what the path implies; a warm engine's
   cascade against its direct path on the same inputs (every one of the six
   sweeps, and the stacked case), with the program's spans of a profiled
   call and the host time of the submit and collect halves, and the submit
   half once more with synchronising calls set to raise; the 256-px scout
   that was trained with CLAHE, on the 140-frame sweep; the six sweeps as a
   directory of cases, with and without the submit halves' speculative
   fixed points;
5. bulk: ``predict_bulk`` on four 140-frame sweeps against four
   ``predict_case`` calls (frames and ACs equal, Dice >= 0.98);
6. container: ``infer-container`` (``MODEL_TAG=att_aspp``) on the 840-frame
   case: the output contract, and 12 of its frames again on the CPU;
7. baseline: ``infer-container`` with ``MODEL_TAG`` unset (the nnU-Net-style
   PlainConvUNet of the in-repo ``plans.json`` at full width, seeded
   initialisation ``BASELINE_SEED``) on the 840-frame case: the output
   contract; a warm ``BaselineEngine`` on the 140-frame sweep and the
   840-frame case (frames/s, the forward's TFLOP/s, peak memory, class
   shares, 3-D components; the ``fixed_point_reads`` counter equal to the
   propagation iterations; every one of the 26 InstanceNorms of each bf16
   forward through the port's norm kernels, counted by their launches),
   the program's spans of a profiled call on the sweep; card against CPU:
   the forward on 2 frames, the postprocess of the 140-frame softmax stack;
   the norm kernels' statistics and apply passes at each stage's shape of a
   forward (ms, GB/s) beside the plain ``InstanceNorm`` + ``leaky_relu_``,
   their output held there against its plain version.
   K1 does not run on this path (``--only baseline`` runs this phase
   alone);
7b. swin (after the baseline; ``--only swin`` runs it alone): Swin UNETR
   at its published widths (feature size 48, heads 3/6/12/24, window 7)
   from the seeded initialisation: the bf16 forward over one tile batch
   (8 frames x 4 tiles of 448 x 576 x 4 mirror views) against the plain f32
   reference of ``tests/torch_ref.py::SwinUNETR`` (logits relative RMS
   under ``SWIN_RTOL``, and above it with the relative-position tables
   zeroed; argmax equal on ``SWIN_ARGMAX``), the forward's time, peak
   memory and device time by span (encoder, window attention, decoder),
   the window attention's kernels as the trace names them (at least one
   named by ``SWIN_ATTN_KERNELS``), and ``MODEL_TAG=swin_unetr`` through
   the container on the 140-frame sweep, in this process (no JAX module
   loaded, the engine's frame) and as ``python -m
   att_aspp_unet_tpu_torch.inference`` with ``WEIGHTS`` a state dict;
8. variants: the model variants (v2 gates with ``att_depth`` 4 and 3,
   ``--no_att``, ``--no_aspp``, v2 ``--no_att --no_aspp``, and v1 as the
   yardstick) at full width from the seeded init with random BN statistics:
   the bf16 forward on 8 frames, card against the CPU's plain versions
   (logits within 2e-2 of their range, signs equal on 99 %, psi maps within
   2e-2), and a warm ``predict_case`` on the 140-frame sweep (frames/s); then
   ``predict --gate v2`` with a reference ``.pt`` state dict written from
   ``tests/torch_ref.py::AttentionASPPUNetV2`` (0 missing and 0 unexpected
   keys; the card's frame equals the CPU's on 6 frames around it);
9. calibrate: ``calibrate --ci`` with the trained weights on 32 seeded PNG
   frames and truth masks in two resolution groups (562 x 744, 480 x 640), on
   the card and on the CPU: the same thr.json, per-image Dice within 2e-2,
   the mean curve within 5e-3;
10. png: ``predict`` on a directory of PNG frames with ``--viz_att
   --weights_noatt`` (a seeded no-attention model), card and CPU: equal masks
   and AC rows, panels written; ``--slice_metrics --topk_viz`` on the
   140-frame sweep on the card, and on 6 of its frames on the card and on
   the CPU: equal per-slice CSVs;
11. train: card against CPU at base_c 8, 128 x 128, batch 4 (the augmented
   batch equal; an f64 step's gradients within 1e-4 of each leaf's
   max-abs; an exact-f32 step's loss within 1e-4 relative and its gradients
   within 1e-3 of each leaf's max-abs beyond the CPU's own f32 error; the
   bf16 loss within 2e-2);
   ``cli train`` at full width (base_c 48, 512 x 512, batch 8) on 32
   synthetic PNG pairs with a val dir: 2 epochs with ``--export_npz``, a
   resumed third, one ``--stage finetune`` epoch from the repo's trained
   weights, one ``--differential_lr`` finetune epoch from the port's own
   checkpoint, K2 launched once per train step and val batch; 20 steps on a
   fixed batch (the loss falls; ms per step, images/s, TFLOP/s, peak
   memory); ``cli predict --weights`` with the finetuned export on the
   140-frame sweep (the direct path's output checks, 72 K1 launches), and a
   one-epoch 128-px no-CLAHE scout driving ``predict --cascade``;
12. compat: the reference-API facade ``FetalAbdomenSegmentation`` with the
   repo's weights (``att_aspp``) on the 840-frame case, cold and warm (K1 64,
   K2 1 each; probabilities, masks and frame equal to
   ``AttAsppEngine.predict_roi``), card against CPU on 12 frames (same frame,
   Dice >= 0.98), ``baseline`` (the in-repo plan, seed 0) on 140 frames (K1
   0, K2 1), ``validate`` on the six sweeps and on a duplicate (raises),
   ``save_probabilities`` under a temporary working directory;
13. entry: ``python -m att_aspp_unet_tpu_torch.inference`` in a subprocess
   with ``MODEL_TAG=att_aspp`` and ``WEIGHTS`` on the 840-frame case and
   with ``MODEL_TAG`` unset and ``PLANS`` on 140 frames: the container
   contract, the subprocess's launch counts;
13b. image: the port's container image (``Dockerfile.torch``) without
   docker: its build context staged (less its ``.dockerignore``: no
   ``build/``, nothing of the JAX package), its build step run there with
   no card visible (the kernel libraries and the host ops, timed), the
   runtime stage's copies made read-only with the image's ``test/input`` and
   ``test/output`` links, its ENTRYPOINT twice with its ENV and no compiler
   to be found (``MODEL_TAG=att_aspp`` on the 840-frame case: K1 64, K2 2;
   the default baseline on 140 frames: K2 2): the container contract, each
   output bit-equal to ``[entry]``'s, nothing written into the image's tree;
14. tools: ``split`` → ``leak-check`` (exit 0, then 1) of generated PNG
   pairs, ``predict`` of the val PNGs with the v1 and a seeded ``--no_att``
   model, ``eval-seg``, ``vis-errors``, ``dataset-report``, ``eval-ac`` of
   the generator's true AC against direct and cascade ``predict`` on the six
   sweeps, ``convert`` with the predicted mask volumes; seconds per call and
   the figures skipped without matplotlib;
15. native: the host ops library (``g++``) builds; the 840-frame case's
   deflate, inflate and ``.mha`` round trip native against Python zlib
   (equal bytes, ms), the contour tracer native against Python on the top-5
   candidates of the six sweeps (equal contours, us per trace), and a
   ``predict`` CLI call on a compressed 140-frame sweep that runs the native
   codec and tracer;
16. sharded (after the directory phase): ``AttAsppEngine(devices=...)`` on
   the 140-frame sweep and the 840-frame case and ``BaselineEngine`` on the
   sweep, over every visible card and over card 0 listed twice, against
   the one-device engines (probabilities within 1e-5, frame, mask and AC
   equal, launches the per-shard sums; frames/s);
16b. int8 (after the container phase): ``--int8`` serving with the trained
   weights: the engine's calibration on the 140-frame sweep (K1 8, K2 1),
   the sweep and the 840-frame case direct, a cascade and a bulk group of
   four on those scales, card 0 listed twice, ``infer-container --int8`` on
   the 840-frame case; each beside the bf16 engine (same frame required,
   frames/s, AC, Dice), two frames card against the CPU's plain versions
   (same frame, Dice >= 0.98), the launches each path implies (K3 two per
   pair and micro-batch, no K1 on a served int8 forward);
   ``--save-int8-scales NPZ`` also saves the container's calibration of the
   840-frame case there (``tests/compare_int8_roi_frame.py`` reads it);
16b'. bench (after the native phase, before warm): the port's benchmark
   ``att_aspp_unet_tpu_torch/bench.py`` in this process at its full default
   sizes, the default line with ``--bulk 4``, then ``--int8``, ``--roi``,
   ``--baseline``, ``--train`` (its ``make_sweep`` inputs made by two worker
   processes from the baseline phase on): each printed line parsed and
   naming the card, the direct figure's 226.8 GFLOP per frame, the kernels
   of each path launched (K3 only under ``--int8``) and no plain version on
   a card tensor, the cascade's frame of the case equal to the direct
   path's and ``--int8``'s equal to bf16's;
16c. warm (last): ``cli warm --int8`` in a subprocess on a copy of the
   package with an empty build directory (builds K1, K2, K3 and the host
   ops), then a ``predict --int8`` subprocess that builds nothing;
17. ddp (after the train phase): ``DDP_STEPS`` fixed-batch train steps at
   the CLI's defaults (bf16) and in f64 at base_c 8, 128², in one process
   and through the launcher of data-parallel training, (a) on the data axis
   ``cli train --device cuda`` takes (NCCL) and (b) as two gloo ranks on
   card 0: loss, BatchNorm buffers, parameters (and f64 gradients) against
   the one process, ms per step, each rank's launch counts.

Every path is driven with the launch counters at zero and must have launched
the kernels it runs.  The line before the last is a JSON object with one
entry per kernel; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import csv
import io
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
PEAK_INT8_OPS = 1979e12      # H100 SXM dense int8 tensor-core rate
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
# scout tier of an 840-frame case, the ROI path, one PNG frame with its
# hflip twin, one frame's psi maps, the variants' 8-frame forward
K1_SHAPE_SETS = {"main": (48, 512, 32), "scout": (16, 128, 128),
                 "roi": (48, 224, 16), "png": (48, 512, 2),
                 "psi": (48, 512, 1), "variants": (48, 512, 8)}


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 5) -> float:
    """Milliseconds per call of ``fn`` on the card: one warm-up call, then
    ``reps`` calls back to back between two CUDA events, so that the host's
    time to start a call hides behind the previous call's device time
    (timed one by one, calls made while the sweep generators kept the host
    busy read several times their device time)."""
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


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
               flops=0.0, bytes=0.0, calib_ms=0.0)
    max_err = calib_err = 0.0
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
        calib = label == "main"     # the int8 path's calibration launch
        if calib:
            amax = torch.zeros((), device=dev)
            same = torch.equal(fc.fused_double_cbr(*args, packed=packed,
                                                   absmax=amax), got)
            amax_want = torch.zeros((), device=dev)
        want = fc.fused_double_cbr_reference(
            *args, absmax=amax_want if calib else None).float()
        err = (got.float() - want).abs()
        n_bad = int((err > 2e-2 + 2e-2 * want.abs()).sum())
        max_err = max(max_err, float(err.max()))
        del got, want, err
        if n_bad:
            raise AssertionError(f"K1 {label} {name}: {n_bad} outputs "
                                 "outside rtol/atol 2e-2")
        if calib:
            a, b = float(amax), float(amax_want)
            calib_err = max(calib_err, abs(a - b) / b)
            if not same or abs(a - b) > 2e-2 + 2e-2 * b:
                raise AssertionError(
                    f"K1 {label} {name} calibration launch: absmax {a} "
                    f"against the plain version's {b} (rtol/atol 2e-2), "
                    f"output equal to the served launch's: {same}")

        sb = [t.to(bf)[None, :, None, None] for t in (s1, b1, s2, b2)]

        def library(x, fmt):
            w1o = fc.unpack_conv_weight(w1, cin).contiguous(memory_format=fmt)
            w2o = fc.unpack_conv_weight(w2, cmid).contiguous(memory_format=fmt)

            def run():
                h = F.relu(F.conv2d(x, w1o, padding=1) * sb[0] + sb[1])
                return F.relu(F.conv2d(h, w2o, padding=1) * sb[2] + sb[3])
            return run

        # a launch of a few frames lasts ~0.1 ms: more repetitions
        reps = 5 if N >= 16 else 25
        ms = cuda_ms(lambda: fc.fused_double_cbr(*args, packed=packed), reps)
        calib_ms = (cuda_ms(lambda: fc.fused_double_cbr(
            *args, packed=packed, absmax=amax), reps) if calib else 0.0)
        plain_ms = cuda_ms(lambda: fc.fused_double_cbr_reference(*args), 3)
        lib_cl = cuda_ms(library(x, torch.channels_last), reps)
        lib_nchw = cuda_ms(library(x.contiguous(), torch.contiguous_format),
                           reps)
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
            f"{float(max_err):.4g}" + (
                f"; calibration launch {calib_ms:.3f} ms, absmax "
                f"{float(amax):.6g} vs plain {float(amax_want):.6g}"
                if calib else ""))
        for k, v in (("ms", ms), ("plain_ms", plain_ms), ("lib_cl", lib_cl),
                     ("lib_nchw", lib_nchw), ("bound_ms", b_ms),
                     ("flops", flops), ("bytes", nbytes),
                     ("calib_ms", calib_ms)):
            tot[k] += v
        del x, w1, w2, args
        torch.cuda.empty_cache()
    _, tot["bound_by"] = bound(tot["flops"], tot["bytes"], PEAK_BF16_FLOPS)
    tot["max_abs_err"] = max_err
    log(f"[K1 {label}] all eight pairs (one {N}-frame launch each): kernel "
        f"{tot['ms']:.3f} ms = {tot['flops'] / tot['ms'] / 1e9:.1f} TFLOP/s, "
        f"cuDNN bf16 channel-last {tot['lib_cl']:.3f} ms / NCHW "
        f"{tot['lib_nchw']:.3f} ms, bound {tot['bound_ms']:.3f} ms "
        f"({tot['bound_by']})" + (
            f"; calibration launches (absmax of the intermediate) "
            f"{tot['calib_ms']:.3f} ms, absmax within {calib_err:.3g} "
            "relative of the plain version's" if tot["calib_ms"] else ""))
    return tot


def phase_k1(dev, labels, entry=None):
    """K1 at the shape sets ``labels``.  Returns the kernel's JSON entry (or
    adds to ``entry``): the main path's sums under the contract's keys, the
    other sets' under names of their own."""
    sets = {label: phase_k1_set(dev, label) for label in labels}
    if entry is None:
        main = sets["main"]
        entry = {"name": "fused_double_cbr", "route": "cuda",
                 "source": "att_aspp_unet_tpu_torch/csrc/fused_double_cbr.cu",
                 "replaces": "att_aspp_unet_tpu/ops/pallas/fused_conv.py:140",
                 "max_abs_err": 0.0,
                 "ms": main["ms"], "plain_ms": main["plain_ms"],
                 "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
                 "library_ms": min(main["lib_cl"], main["lib_nchw"]),
                 "calibration_ms": main["calib_ms"]}
    entry["max_abs_err"] = max([entry["max_abs_err"]]
                               + [t["max_abs_err"] for t in sets.values()])
    for label in labels:
        if label == "main":
            continue
        t = sets[label]
        entry.update({f"{label}_ms": t["ms"], f"{label}_plain_ms": t["plain_ms"],
                      f"{label}_bound_ms": t["bound_ms"],
                      f"{label}_bound_by": t["bound_by"],
                      f"{label}_library_ms": min(t["lib_cl"], t["lib_nchw"])})
    return entry


# label -> (base_c, input size, frames per launch) of K3's shape sets: the
# direct path's micro-batch (16 frames with their hflip twins), a cascade's
# tier-2 micro-batch (8 promoted frames with their twins) and the ROI path's
# 16 crops
K3_SHAPE_SETS = {"main": (48, 512, 32), "tier2": (48, 512, 16),
                 "roi": (48, 224, 16)}


def k3_convs(base_c: int, size: int):
    """The sixteen convs of the eight pairs, in forward order: (name, Cin,
    Cout, H = W)."""
    from att_aspp_unet_tpu_torch.ops.kernels import fused_conv as fc

    out = []
    for name, cin, cmid, cout, hw in fc.model_pairs(base_c, size):
        out += [(f"{name}.0", cin, cmid, hw), (f"{name}.1", cmid, cout, hw)]
    return out


def bf16_ulps(a, b) -> int:
    """Largest distance of two bf16 tensors in units of the last place."""
    import torch

    ia = a.contiguous().view(torch.int16).to(torch.int32)
    ib = b.contiguous().view(torch.int16).to(torch.int32)
    ia = torch.where(ia < 0, -32768 - ia, ia)
    ib = torch.where(ib < 0, -32768 - ib, ib)
    return int((ia - ib).abs().max())


def int8_library(xq, wq):
    """The library yardstick of one int8 conv: im2col of the quantized
    channel-last input (K padded to a multiple of 8) and cuBLASLt's int8
    GEMM (``torch._int_mm``); int32 (N, H, W, Cout)."""
    import torch
    import torch.nn.functional as F

    N, H, W, C = xq.shape
    xp = F.pad(xq, (0, 0, 1, 1, 1, 1))
    cols = torch.cat([xp[:, ky:ky + H, kx:kx + W] for ky in range(3)
                      for kx in range(3)], dim=-1).reshape(N * H * W, 9 * C)
    k = cols.shape[1]
    if k % 8:
        cols = F.pad(cols, (0, 8 - k % 8))
        wq = F.pad(wq, (0, 8 - k % 8))
    return torch._int_mm(cols, wq.t()).reshape(N, H, W, -1)


def k3_bound(N, cin, cout, hw, in_bytes, out_bytes):
    """(ms, bound_by, operations, bytes) of one conv: each input element
    read once (``in_bytes`` each), each output written once, the int8
    weights and f32 per-channel parameters, against the int8 rate."""
    ops = 2.0 * N * hw * hw * 9 * cin * cout
    nbytes = (in_bytes * N * cin * hw * hw + out_bytes * N * cout * hw * hw
              + 9 * cin * cout + 4 * (3 * cout + 1))
    return bound(ops, nbytes, PEAK_INT8_OPS) + (ops, nbytes)


def k3_path(packed) -> str:
    return (f"wgmma, {packed.rows} output channels a pass" if packed.rows
            else "mma.sync")


def phase_k3_set(dev, label):
    """K3 at the sixteen conv shapes of one shape set, each pair as the int8
    model serves it (the served form: the first conv reads bf16 and writes
    its result quantized with the second conv's scale, int8; the second
    reads that int8 tensor and writes bf16), the second conv fed the first
    one's kernel output; the main set also the ``--no_aspp`` bridge conv
    (bf16 in and out).  Held to the plain version: int32 accumulators exact
    from either input, bf16 outputs within one ulp, the int8 intermediate
    bit-equal to ``quantize_act`` of the plain bf16 result; the accumulators
    also on the mma.sync path.  Timed: the served form (the path the wrapper
    picks), the bf16-in, bf16-out form on that path, the plain version,
    im2col + ``torch._int_mm``.  Returns the sums over the sixteen."""
    import torch

    from att_aspp_unet_tpu_torch.ops.kernels import int8_conv as ic

    base_c, size, N = K3_SHAPE_SETS[label]
    convs = k3_convs(base_c, size)
    if label == "main":
        convs.append(("bridge", 8 * base_c, 16 * base_c, size // 16))
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    keys = ("ms", "bf16_ms", "plain_ms", "lib_ms", "bound_ms",
            "ops", "bytes", "bf16_bound_ms", "bf16_bytes")
    tot = dict.fromkeys(keys, 0.0)
    tot["max_abs_err"] = 0.0
    no_lib, paths = [], set()
    q_prev = None        # the pair's int8 intermediate, from the kernel
    for name, cin, cout, hw in convs:
        first, second = name.endswith(".0"), name.endswith(".1")
        wq = torch.randint(-127, 128, (cout, 9 * cin), generator=g,
                           device=dev, dtype=torch.int8)
        ws = torch.rand(cout, generator=g, device=dev) * 1e-3 + 1e-4
        sc = torch.rand(cout, generator=g, device=dev) + 0.5
        bi = torch.randn(cout, generator=g, device=dev) * 0.1
        if second:
            # the first conv's kernel output and its scale; x_bf dequantized
            # from it quantizes back to it exactly (the bf16-form input)
            xq, s_x = q_prev
            x = (xq.float() * s_x).to(torch.bfloat16).contiguous(
                memory_format=torch.channels_last)
            if not torch.equal(ic.quantize_act(x, s_x), xq):
                raise AssertionError(f"K3 {label} {name}: the dequantized "
                                     "intermediate does not quantize back")
        else:
            x = (torch.randn(N, cin, hw, hw, generator=g, device=dev) * 2).to(
                torch.bfloat16).contiguous(memory_format=torch.channels_last)
            s_x = torch.full((), 5.0 / 127, device=dev)
            xq = ic.quantize_act(x, s_x).contiguous(
                memory_format=torch.channels_last)
        rest = (wq, ws, s_x, sc, bi)
        packed = ic.prepack_int8_weight(wq)
        mma = ic.prepack_int8_weight(wq, mma_sync=True)
        paths.add(packed.rows != 0)
        # the plain version: the exact integer conv once, then its epilogue
        acc_want = ic.int_conv3x3(xq, wq)
        want = ic.int8_epilogue(acc_want, ws, s_x, sc, bi, torch.bfloat16)
        s_out = ((want.float().amax().clamp_min(1e-6) / 127).reshape(())
                 if first else None)
        served_x = xq if second else x
        ok = [torch.equal(ic.int8_conv3x3(xi, *rest, packed=pk, raw=True),
                          acc_want)
              for xi in (x, xq) for pk in (packed, mma)]
        got = ic.int8_conv3x3(x, *rest, packed=packed)
        ulps = bf16_ulps(got, want)
        err = float((got.float() - want.float()).abs().max())
        served = ic.int8_conv3x3(served_x, *rest, packed=packed, s_out=s_out)
        torch.cuda.synchronize()
        if first:
            q_ok = torch.equal(served, ic.quantize_act(want, s_out))
            q_prev = (served, s_out)
        else:
            q_ok = True
            ulps = max(ulps, bf16_ulps(served, want))
        tot["max_abs_err"] = max(tot["max_abs_err"], err)
        if not all(ok) or ulps > 1 or not q_ok:
            raise AssertionError(
                f"K3 {label} {name}: accumulators exact {ok} (bf16 and int8 "
                f"input, chosen path and mma.sync), outputs {ulps} bf16 ulp "
                f"apart, int8 intermediate bit-equal {q_ok}")
        reps = 5 if N * hw * hw >= 2 ** 21 else 25
        ms = cuda_ms(lambda: ic.int8_conv3x3(served_x, *rest, packed=packed,
                                             s_out=s_out), reps)
        bf16_ms = cuda_ms(lambda: ic.int8_conv3x3(x, *rest, packed=packed),
                          reps)
        plain_ms = cuda_ms(lambda: ic.int8_conv3x3_reference(
            served_x, *rest, s_out=s_out), 1)
        xq_nhwc = xq.permute(0, 2, 3, 1).contiguous()
        try:
            lib_out = int8_library(xq_nhwc, wq)
            lib_ok = torch.equal(lib_out, acc_want.permute(0, 2, 3, 1))
            del lib_out
            lib_ms = cuda_ms(lambda: int8_library(xq_nhwc, wq), 3)
        except (RuntimeError, torch.cuda.OutOfMemoryError) as exc:
            lib_ok, lib_ms = None, None
            no_lib.append(f"{name}: {str(exc).splitlines()[0][:80]}")
        b_ms, bound_by, ops, nbytes = k3_bound(
            N, cin, cout, hw, 1 if second else 2, 1 if first else 2)
        bb_ms, _, _, bf_bytes = k3_bound(N, cin, cout, hw, 2, 2)
        log(f"[K3 {label}] {name} N={N} {cin}->{cout} @{hw}^2 "
            f"{'int8' if second else 'bf16'} in, {'int8' if first else 'bf16'}"
            f" out, {k3_path(packed)}: kernel {ms:.3f} ms "
            f"({ops / ms / 1e9:.1f} TOP/s), bound {b_ms:.3f} ms ({bound_by}); "
            f"bf16 in and out {bf16_ms:.3f} ms (bound {bb_ms:.3f} ms); "
            f"plain {plain_ms:.3f} ms; im2col "
            f"+ torch._int_mm "
            f"{'n/a' if lib_ms is None else f'{lib_ms:.3f} ms'} (its int32 "
            f"equal: {lib_ok}); accumulators exact, outputs within {ulps} "
            f"bf16 ulp, max|err| {err:.4g}"
            + (", int8 intermediate bit-equal" if first else ""))
        if lib_ok is False:
            raise AssertionError(f"K3 {label} {name}: the library yardstick "
                                 "computes another conv")
        if name == "bridge":
            tot.update(bridge_ms=ms, bridge_plain_ms=plain_ms,
                       bridge_library_ms=lib_ms, bridge_bound_ms=b_ms,
                       bridge_bound_by=bound_by, bridge_path=k3_path(packed))
        else:
            for k, v in (("ms", ms), ("bf16_ms", bf16_ms),
                         ("plain_ms", plain_ms), ("lib_ms", lib_ms),
                         ("bound_ms", b_ms), ("ops", ops), ("bytes", nbytes),
                         ("bf16_bound_ms", bb_ms), ("bf16_bytes", bf_bytes)):
                tot[k] = None if v is None or tot[k] is None else tot[k] + v
        del x, xq, wq, acc_want, want, got, served, packed, mma
        if not first:
            q_prev = None
        torch.cuda.empty_cache()
    _, tot["bound_by"] = bound(tot["ops"], tot["bytes"], PEAK_INT8_OPS)
    log(f"[K3 {label}] the sixteen convs (one {N}-frame launch each, served "
        f"form): kernel {tot['ms']:.3f} ms = "
        f"{tot['ops'] / tot['ms'] / 1e9:.1f} TOP/s, bound "
        f"{tot['bound_ms']:.3f} ms (int8 intermediate, {tot['bound_by']}); "
        f"bf16 in and out {tot['bf16_ms']:.3f} ms (bound "
        f"{tot['bf16_bound_ms']:.3f} ms, per-conv bf16 form); plain "
        f"{tot['plain_ms']:.3f} ms, im2col + "
        f"torch._int_mm "
        f"{tot['lib_ms'] if tot['lib_ms'] is None else round(tot['lib_ms'], 3)}"
        f" ms; paths: {'wgmma' if True in paths else ''}"
        f"{' and ' if len(paths) == 2 else ''}"
        f"{'mma.sync' if False in paths else ''}"
        + (f"; no library time for {no_lib}" if no_lib else ""))
    return tot


def phase_k3(dev):
    """K3 at every shape set; returns its JSON entry (the main set under the
    contract's keys, per 32-frame micro-batch over the sixteen convs in the
    served form)."""
    sets = {label: phase_k3_set(dev, label) for label in K3_SHAPE_SETS}
    main = sets["main"]
    entry = {"name": "int8_conv3x3", "route": "cuda",
             "source": "att_aspp_unet_tpu_torch/csrc/int8_conv3x3.cu",
             "replaces": "att_aspp_unet_tpu/nn/quant.py:54",
             "max_abs_err": max(t["max_abs_err"] for t in sets.values()),
             "ms": main["ms"], "plain_ms": main["plain_ms"],
             "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
             "library_ms": main["lib_ms"], "bf16_form_ms": main["bf16_ms"],
             "bf16_form_bound_ms": main["bf16_bound_ms"]}
    for k in ("bridge_ms", "bridge_plain_ms", "bridge_library_ms",
              "bridge_bound_ms", "bridge_bound_by"):
        entry[k] = main[k]
    for label in ("tier2", "roi"):
        t = sets[label]
        entry.update({f"{label}_ms": t["ms"], f"{label}_plain_ms": t["plain_ms"],
                      f"{label}_bound_ms": t["bound_ms"],
                      f"{label}_bound_by": t["bound_by"],
                      f"{label}_library_ms": t["lib_ms"],
                      f"{label}_bf16_form_ms": t["bf16_ms"]})
    return entry


def k2_stacks(dev, sweeps, val):
    """label -> the uint8 stack that a path hands to CLAHE: the whole sweep
    (direct), the 8 promoted frames of a cascade, the 32 of a bulk group of
    four, the container's 128 subsampled frames of the 840-frame case, the
    sweep at the sizes of the scouts (256 px: the scout that was trained
    with CLAHE; 128 px: tiles of 16 x 16 pixels), the whole 840-frame case
    at native size (the baseline), one native frame (a PNG input), the
    calibrate phase's two resolution groups and the batches of a train step
    (8 frames at 512 x 512; 4 at 128 x 128, the card-against-CPU step)."""
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
            "baseline": u8(case), "png": u8(sweeps[0][mid:mid + 1]),
            **{"calibrate_{}x{}".format(*g[0].shape[1:]): u8(g[0])
               for g in val},
            "train": low(512)[mid:mid + 8], "train128": low(128)[:4]}


def phase_k2(dev, sweeps, val):
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
    for label, u8 in k2_stacks(dev, sweeps, val).items():
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


KERNELS = ("fused_double_cbr", "clahe_interp", "int8_conv3x3")


def new_totals():
    return dict.fromkeys(KERNELS, 0)


def _wrappers():
    from att_aspp_unet_tpu_torch.ops.kernels import clahe_interp as ci
    from att_aspp_unet_tpu_torch.ops.kernels import fused_conv as fc
    from att_aspp_unet_tpu_torch.ops.kernels import int8_conv as ic

    return {"fused_double_cbr": fc.fused_double_cbr,
            "clahe_interp": ci.clahe_interp, "int8_conv3x3": ic.int8_conv3x3}


def reset_launches():
    for fn in _wrappers().values():
        fn.launches = 0


def read_launches(where: str, expect=None):
    """The counters since :func:`reset_launches`; exactly ``expect`` = (K1,
    K2[, K3]) launches where that is given (K3 0 where it is left out), and
    every kernel the path runs (K1 and K2 without ``expect``) must have
    launched."""
    return hold_launches(where, {k: fn.launches
                                 for k, fn in _wrappers().items()}, expect)


def hold_launches(where: str, got, expect=None):
    """:func:`read_launches`' check of the counts ``got``."""
    runs = [v for v, e in zip(got.values(), expect or (1, 1)) if e]
    if not runs or min(runs) <= 0:
        raise AssertionError(f"{where}: a kernel never launched: {got}")
    if expect is not None:
        expect = tuple(expect) + (0,) * (len(got) - len(expect))
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


def main_config(conv_lowering="direct", **predict):
    from att_aspp_unet_tpu_torch.config import (Config, ModelConfig,
                                                PredictConfig)

    return Config(model=ModelConfig(base_c=BASE_C,
                                    conv_lowering=conv_lowering),
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


def profiled(fn):
    """``fn()`` once under ``torch.profiler`` (host and card): its result
    and, per program span (``utils/profiling.py``) by name, [calls, host
    seconds]."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from att_aspp_unet_tpu_torch.utils.profiling import name_of

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    spans = {}
    for ev in prof.events():
        name = name_of(ev.name)
        if name and getattr(ev.device_type, "name", "") == "CPU":
            s = spans.setdefault(name, [0, 0.0])
            s[0] += 1
            s[1] += (ev.time_range.end - ev.time_range.start) * 1e-6
    return out, spans


def fmt_spans(spans):
    return ", ".join(f"{k} x{c} {host:.3f} s"
                     for k, (c, host) in spans.items())


def phase_slice(dev, sweep, best_true, truth, variables, thr, tmp):
    """The direct path: the predict CLI on the sweep, with the launch
    counters read around it; output checks; the CPU cross-check; the
    program's spans."""
    from att_aspp_unet_tpu_torch.infer.engine import AttAsppEngine
    from att_aspp_unet_tpu_torch.io import MetaImage, write_mha

    cfg = main_config()
    n = sweep.shape[0]

    # warm-up on the card (first-call costs: cuDNN/cuBLAS handles, allocator)
    engine = AttAsppEngine(cfg, variables, device=dev)
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

    # a warm engine, same sweep, then its spans in a profiled call
    t0 = time.perf_counter()
    f_gpu_full, _, ac_full = engine.predict_case(sweep, SPACING, thr)
    tot = time.perf_counter() - t0
    _, spans = profiled(lambda: engine.predict_case(sweep, SPACING, thr))
    log(f"[direct] warm engine on {n} frames: wall {tot:.3f} s = "
        f"{n / tot:.1f} frames/s; spans of a profiled call: "
        f"{fmt_spans(spans)}")
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
    """One warm ``predict_case`` in its two halves: (result, seconds of the
    submit call on the host, of the collect call, of both)."""
    import torch

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


def check_staged_submit(engine, data, thr, label):
    """A submit half on a pageable host array (as a served case arrives),
    on a warm engine, with synchronising calls set to raise: the staged
    upload (``infer/staging.py``) must neither wait for the card nor read
    anything back.  Its upload equals the plain ``.to(device)`` of the same
    array, and the request's result equals the one served through the plain
    upload, bit for bit.  Prints the staging counters, the host's staging
    time, and the copy stream's time by CUDA events."""
    import numpy as np
    import torch

    from att_aspp_unet_tpu_torch.utils.profiling import counts

    staging = engine._staging
    before = counts()
    # the upload alone: host time, and by events on the copy stream the
    # time to the last byte and the copy of the staged bytes alone
    torch.cuda.synchronize()
    e0, e1, e2, e3 = (torch.cuda.Event(enable_timing=True) for _ in range(4))
    e0.record(staging.stream)
    t0 = time.perf_counter()
    up = engine._to_device(data)
    t_stage = time.perf_counter() - t0
    e1.record(staging.stream)
    slot = staging._slots[(staging._next - 1) % len(staging._slots)]
    again = torch.empty_like(up)
    with torch.cuda.stream(staging.stream):
        e2.record()
        again.view(-1).copy_(slot[:up.numel()], non_blocking=True)
        e3.record()
    torch.cuda.synchronize()
    if not torch.equal(up, torch.as_tensor(data).to(engine.device)):
        raise AssertionError(f"[{label}] the staged upload differs from "
                             ".to(device)")
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        handle = engine.predict_case_submit(data, thr)
        t_submit = time.perf_counter() - t0
    finally:
        torch.cuda.set_sync_debug_mode("default")
    got = engine.predict_case_collect(handle, SPACING)
    after = counts()
    engine._staging = None
    try:
        want = engine.predict_case(data, SPACING, thr)
    finally:
        engine._staging = staging
    if got[0] != want[0] or got[2] != want[2] or \
            not np.array_equal(got[1], want[1]):
        raise AssertionError(f"[{label}] staged: frame {got[0]} AC "
                             f"{got[2]}; plain upload: frame {want[0]} AC "
                             f"{want[2]}")
    delta = {k: after.get(k, 0) - before.get(k, 0)
             for k in ("staged_uploads", "upload_slot_waits")}
    if delta != {"staged_uploads": 2, "upload_slot_waits": 0}:
        raise AssertionError(f"[{label}] counters {delta}: not 2 staged "
                             "uploads without a slot wait")
    mb = up.numel() * up.element_size() / 1e6
    log(f"[{label}] staged upload of {mb:.1f} MB from pageable memory: "
        f"host staging {1e3 * t_stage:.2f} ms, last byte on the card "
        f"{e0.elapsed_time(e1):.2f} ms after the call began, the staged "
        f"bytes' copy alone {e2.elapsed_time(e3):.2f} ms (copy stream); "
        f"submit half with synchronising calls set to raise: returned "
        f"after {1e3 * t_submit:.1f} ms; frame {got[0]}, AC {got[2]:.2f} mm "
        f"equal to the plain upload's; counters {delta}")
    return got


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
    totals = new_totals()

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
    engine = AttAsppEngine(
        main_config(cascade=True, cascade_scout_weights=scout), variables,
        device=dev)
    log(f"[cascade] scout: base_c {engine.scout_model.cfg.base_c} at "
        f"{engine._scout_img_size}^2, CLAHE {engine._scout_clahe}, "
        f"threshold {engine._scout_thr}")
    engine.predict_case(sweeps[0][:32], SPACING, thr)            # warm-up
    results = {}
    for label, data, direct in (("140", sweeps[0], direct_140),
                                ("840", case, None)):
        nn = data.shape[0]
        _, spans = profiled(lambda: engine.predict_case(data, SPACING, thr))
        log(f"[cascade] spans of a profiled call on {nn} frames: "
            f"{fmt_spans(spans)}")
        (f_c, m_c, ac_c), t_sub, t_col, t_all = timed_case(engine, data, thr)
        (f_d, _, ac_d), d_sub, d_col, d_all = timed_case(direct_engine, data,
                                                          thr)
        if direct is not None and (f_d, ac_d) != direct:
            raise AssertionError("the direct path is not repeatable")
        log(f"[cascade] {nn} frames, warm: cascade "
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
        if check_staged_submit(engine, data, thr,
                               f"cascade {nn}")[0] != f_c:
            raise AssertionError("cascade: the staged submit picked "
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


def int8_forward_launches(n_frames: int, batch: int) -> int:
    """K3 launches of one int8 forward: two per pair and micro-batch."""
    return 2 * forward_launches(n_frames, batch)


def scout_launches(n_stack: int) -> int:
    """K1 launches of a cascade's scout tier over ``n_stack`` frames."""
    from att_aspp_unet_tpu_torch.infer.engine import scout_micro_batch

    return forward_launches(n_stack, scout_micro_batch(n_stack, 128, 16))


def phase_int8(dev, sweeps, bests, variables, thr, tmp, save_scales=None):
    """The ``--int8`` serving path with the repo's trained weights: the
    engine calibrates on the 140-frame sweep (K1's calibration launches,
    once), then serves the sweep and the 840-frame case directly, a cascade
    and a bulk group (on the card's calibrated scales, which a new engine
    takes without calibrating), ``infer-container --int8`` on the 840-frame
    case (the ROI path, calibrated on its full frames), and two frames on
    the CPU's plain versions with the same scales.  Gates: the bf16
    engine's frame on every path, mask Dice >= 0.98 against the CPU, the
    launches the path implies (no K1 launch on a served int8 forward)."""
    import numpy as np
    import torch

    from att_aspp_unet_tpu_torch import cli
    from att_aspp_unet_tpu_torch.infer.engine import AttAsppEngine
    from att_aspp_unet_tpu_torch.io import read_json

    totals = new_totals()

    def add(launches):
        for k, v in launches.items():
            totals[k] += v

    sweep, case = sweeps[0], np.concatenate(sweeps)
    n = sweep.shape[0]
    bf = AttAsppEngine(main_config(), variables, device=dev)
    bf.predict_case(sweep[:16], SPACING, thr)                    # warm-up
    eng = AttAsppEngine(main_config("int8"), variables, device=dev)
    # calibration (16 frames: one CLAHE, one K1 launch per pair) and the
    # first case
    reset_launches()
    t0 = time.perf_counter()
    eng.predict_case(sweep, SPACING, thr)
    t_first = time.perf_counter() - t0
    add(read_launches("int8 calibration + first case",
                      (8, 2, int8_forward_launches(n, 16))))
    log(f"[int8] first case, calibration included: {t_first:.3f} s; act "
        f"absmax of d1_0 / u1_conv1: "
        f"{float(eng.model.d1.act_absmax1):.4g} / "
        f"{float(eng.model.u1.pair.act_absmax2):.4g}")
    quant = eng.quant_variables()
    frames = {}
    for label, data in (("140", sweep), ("840", case)):
        nn = data.shape[0]
        reset_launches()
        (f8, m8, ac8), t8s, t8c, t8 = timed_case(eng, data, thr)
        frames[label] = f8
        add(read_launches(f"int8 direct {label}",
                          (0, 1, int8_forward_launches(nn, 16))))
        (fb, mb, acb), _, _, tb = timed_case(bf, data, thr)
        log(f"[int8] direct {label} frames, warm: int8 {t8:.3f} s = "
            f"{nn / t8:.1f} frames/s (submit {t8s:.3f} s, collect {t8c:.3f} "
            f"s), frame {f8}, AC {ac8:.2f} mm; bf16 {tb:.3f} s = "
            f"{nn / tb:.1f} frames/s, frame {fb}, AC {acb:.2f} mm; mask Dice "
            f"{dice(m8, mb):.5f}; int8 is x{tb / t8:.3f}")
        if f8 != fb:
            raise AssertionError(f"int8 direct {label}: frame {f8}, the bf16 "
                                 f"engine's {fb}")

    # card against the CPU's plain versions on the card's scales
    lo = max(0, min(frames["140"], n - 2))
    sub = sweep[lo:lo + 2]
    t0 = time.perf_counter()
    f_cpu, m_cpu, ac_cpu = AttAsppEngine(main_config("int8"), quant,
                                         device="cpu").predict_case(
        sub, SPACING, thr)
    t_cpu = time.perf_counter() - t0
    f_gpu, m_gpu, ac_gpu = eng.predict_case(sub, SPACING, thr)
    d = dice(m_cpu, m_gpu)
    log(f"[int8] frames {lo}..{lo + 1} (the int8 frame {frames['140']} among "
        f"them): card frame {lo + f_gpu} AC {ac_gpu:.2f} mm, CPU plain "
        f"frame {lo + f_cpu} AC {ac_cpu:.2f} mm ({t_cpu:.1f} s), mask Dice "
        f"{d:.5f}, {int(((m_cpu > 0) != (m_gpu > 0)).sum())} pixels differ")
    if f_cpu != f_gpu or d < 0.98:
        raise AssertionError("int8: card and CPU plain versions disagree")

    # the cascade and a bulk group, on the scales calibrated above
    scout = str(REPO / SCOUT_WEIGHTS)
    c8 = AttAsppEngine(main_config("int8", cascade=True,
                                   cascade_scout_weights=scout), quant,
                       device=dev)
    cb = AttAsppEngine(main_config(cascade=True, cascade_scout_weights=scout),
                       variables, device=dev)
    for e in (c8, cb):
        e.predict_case(sweep[:32], SPACING, thr)                 # warm-up
    for label, data in (("140", sweep), ("840", case)):
        nn = data.shape[0]
        reset_launches()
        (f8, m8, ac8), _, _, t8 = timed_case(c8, data, thr)
        add(read_launches(f"int8 cascade {label}",
                          (scout_launches(nn), 1,
                           int8_forward_launches(8, 8))))
        (fb, mb, acb), _, _, tb = timed_case(cb, data, thr)
        log(f"[int8] cascade {label} frames, warm: int8 {t8:.3f} s = "
            f"{nn / t8:.1f} frames/s, frame {f8}, AC {ac8:.2f} mm; bf16 "
            f"{tb:.3f} s = {nn / tb:.1f} frames/s, frame {fb}, AC {acb:.2f} "
            f"mm; mask Dice {dice(m8, mb):.5f}")
        if f8 != fb:
            raise AssertionError(f"int8 cascade {label}: frame {f8}, the "
                                 f"bf16 engine's {fb}")
    S = 4
    group = np.stack(sweeps[:S])
    n_pad = -(-n // 16) * 16
    c8.predict_bulk(group, SPACING, thr)                         # warm-up
    reset_launches()
    t0 = time.perf_counter()
    got8 = c8.predict_bulk(group, SPACING, thr)
    t8 = time.perf_counter() - t0
    add(read_launches("int8 bulk", (scout_launches(S * n_pad), 1,
                                    int8_forward_launches(S * 8, 16))))
    t0 = time.perf_counter()
    gotb = cb.predict_bulk(group, SPACING, thr)
    tb = time.perf_counter() - t0
    log(f"[int8] bulk S={S}: int8 {t8:.3f} s = {S / t8:.2f} sweeps/s, frames "
        f"{[g[0] for g in got8]} ACs {[round(g[2], 2) for g in got8]} mm; "
        f"bf16 {tb:.3f} s = {S / tb:.2f} sweeps/s, frames "
        f"{[g[0] for g in gotb]} ACs {[round(g[2], 2) for g in gotb]} mm")
    if [g[0] for g in got8] != [g[0] for g in gotb]:
        raise AssertionError("int8 bulk: frames differ from the bf16 bulk")
    del c8, cb

    # the int8 engine on card 0 listed twice: bit for bit one device
    two = AttAsppEngine(main_config("int8"), quant, devices=[dev] * 2)
    sizes = shard_sizes(n, two.devices, 16)
    reset_launches()
    got = two.predict_case(sweep, SPACING, thr)
    add(read_launches("int8 sharded 140", (0, len(sizes), sum(
        int8_forward_launches(k, 16) for k in sizes))))
    want = eng.predict_case(sweep, SPACING, thr)
    log(f"[int8] card 0 twice: frame {got[0]} (one device {want[0]}), AC "
        f"{got[2]:.4f} ({want[2]:.4f}), masks equal "
        f"{bool(np.array_equal(got[1], want[1]))}")
    if got[0] != want[0] or got[2] != want[2] or \
            not np.array_equal(got[1], want[1]):
        raise AssertionError("int8 sharded: differs from one device")
    del two, eng, bf
    torch.cuda.empty_cache()

    # the container (ROI path) with --int8, against the bf16 container run
    os.environ["MODEL_TAG"], os.environ["CASE_ID"] = "att_aspp", "case-840"
    argv = ["infer-container", "--input", str(tmp / "cin"), "--output",
            str(tmp / "cout8"), "--weights", str(REPO / MAIN_WEIGHTS),
            "--base_c", str(BASE_C), "--device", dev, "--int8",
            "--no-save-probabilities", "--no-debug-frames"]
    reset_launches()
    t0 = time.perf_counter()
    rc = cli.main(argv)
    wall = time.perf_counter() - t0
    n_sub = min(128, case.shape[0])
    add(read_launches("int8 container", (8, 2, int8_forward_launches(n_sub,
                                                                      16))))
    f8 = read_json(tmp / "cout8/fetal-abdomen-frame-number.json")
    fb = read_json(tmp / "cout/fetal-abdomen-frame-number.json")
    # the ROI path picks the frame with the most pixels above 0.05; with
    # these weights on 224 x 224 crops nearly every pixel of every crop is
    # above it, so the pick is a tie of a few pixels: hold the probabilities
    # (the JAX package's int8 ROI tolerance, mean |diff| < 0.02) and require
    # the same frame, or a pick whose bf16 area is within 0.1 % of the bf16
    # maximum
    probs = {}
    for label, cfg, v in (("bf16", main_config(), variables),
                          ("int8", main_config("int8"), quant)):
        e = AttAsppEngine(cfg, v, device=dev)
        probs[label] = e.predict_roi(case)
        del e
    idx = np.linspace(0, case.shape[0] - 1, n_sub).astype(int).tolist()
    areas = {k: (p > 0.05).sum(dim=(-2, -1)).cpu().numpy()
             for k, p in probs.items()}
    diff = (probs["int8"] - probs["bf16"]).abs()
    mean_diff, max_diff = float(diff.mean()), float(diff.max())
    a_b = areas["bf16"]
    tie = (f8 in idx and fb in idx
           and a_b[idx.index(f8)] >= 0.999 * a_b[idx.index(fb)])
    log(f"[int8] infer-container --int8 on {case.shape[0]} frames: rc {rc}, "
        f"{wall:.2f} s (calibration on 16 full frames, ROI path on {n_sub}); "
        f"frame {f8}, the bf16 container's {fb}; ROI probabilities int8 vs "
        f"bf16 mean |diff| {mean_diff:.3g}, max {max_diff:.3g}; pixels above "
        f"0.05 in the bf16 run: frame {f8} "
        f"{int(a_b[idx.index(f8)]) if f8 in idx else 'n/a'}, frame {fb} "
        f"{int(a_b[idx.index(fb)]) if fb in idx else 'n/a'} of "
        f"{int(probs['bf16'][0].numel())}")
    del probs, diff
    if rc != 0 or mean_diff >= 0.02 or not (f8 == fb or tie):
        raise AssertionError(f"int8 container: rc {rc}, frame {f8} against "
                             f"the bf16 container's {fb} (a tie: {tie}), "
                             f"mean |diff| {mean_diff}")
    if save_scales:
        # the container's own calibration (its configuration, on this case),
        # for the JAX package's int8 engine (tests/compare_int8_roi_frame.py)
        from att_aspp_unet_tpu_torch.config import Config, ModelConfig
        from att_aspp_unet_tpu_torch.utils.npz_weights import \
            save_npz_variables

        e = AttAsppEngine(Config(model=ModelConfig(
            base_c=BASE_C, conv_lowering="int8")), variables, device=dev)
        e.predict_roi(case)
        Path(save_scales).parent.mkdir(parents=True, exist_ok=True)
        save_npz_variables(e.quant_variables(), save_scales)
        log(f"[int8] the container's calibration on the {case.shape[0]}-frame "
            f"case saved to {save_scales}")
        del e
    return totals


def phase_warm(dev, thr, tmp):
    """``cli warm --int8`` in a subprocess, on a copy of the package whose
    build directory is empty (it builds the kernels and the host
    ops), then a ``predict --int8`` subprocess on the 140-frame sweep from
    the same copy, which must build nothing."""
    import shutil

    root = tmp / "warm_checkout"
    shutil.copytree(REPO / "att_aspp_unet_tpu_torch",
                    root / "att_aspp_unet_tpu_torch",
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    build = root / "att_aspp_unet_tpu_torch/build"
    env = dict(os.environ, PYTHONPATH=str(root))
    common = ["--weights", str(REPO / MAIN_WEIGHTS), "--base_c", str(BASE_C),
              "--thr", str(thr), "--int8", "--device", dev]

    def run(args, what):
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-m",
                              "att_aspp_unet_tpu_torch.cli", *args, *common],
                             cwd=root, env=env, capture_output=True,
                             text=True, timeout=600)
        if res.returncode != 0:
            raise AssertionError(f"{what}: rc {res.returncode}\n"
                                 f"{res.stderr[-3000:]}")
        return res.stdout, time.perf_counter() - t0

    def built():
        return {p.name: p.stat().st_mtime_ns for p in build.iterdir()
                if not p.name.endswith(".lock")}

    out, t_warm = run(["warm", "--shapes", f"{N_FRAMES}x{FRAME_HW[0]}x"
                       f"{FRAME_HW[1]}", "--tta"], "warm")
    lines = [line for line in out.splitlines() if line.startswith("[warm]")]
    log(f"[warm] cli warm subprocess into an empty build directory: "
        f"{t_warm:.2f} s wall; {lines}")
    before = built()
    libs = sorted(k for k in before if k.endswith(".so"))
    # the kernels and the host ops (on the CPU: the host ops)
    if len(libs) != (4 if dev == "cuda" else 1) or \
            not any(f"{N_FRAMES}x" in line for line in lines):
        raise AssertionError(f"warm: built {libs}, printed {lines}")
    _, t_pred = run(["predict", "--input_dir", str(tmp / "in140"),
                     "--out_dir", str(tmp / "warm_out")], "predict")
    after = built()
    log(f"[warm] predict --int8 subprocess afterwards: {t_pred:.2f} s wall; "
        f"build directory {'unchanged' if after == before else 'CHANGED'} "
        f"({libs})")
    if after != before or not (tmp / "warm_out/ac_results.csv").exists():
        raise AssertionError("warm: the predict after warm built something "
                             "or wrote no result")


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


def norm_shapes(pu):
    """(B, C, H, W) of each stage's InstanceNorms in one forward of the
    plan: a micro-batch of ``tile_batch`` tiles and their mirror views."""
    views = 4 if pu.use_mirroring and pu.mirror_batch else 1
    h, w = pu.patch_size
    return [(pu.tile_batch * views, min(pu.base_c * 2 ** s, pu.max_c),
             h >> s, w >> s) for s in range(pu.n_stages)]


def hold_fused_norms(where: str, before: int, forwards: int,
                     per_forward: int) -> int:
    """Every norm of ``forwards`` bf16 forwards went through the kernels:
    their launches moved by ``per_forward`` x ``forwards`` since
    ``before``."""
    from att_aspp_unet_tpu_torch.ops.kernels import swin_ops

    got = swin_ops.instance_norm_act.launches - before
    want = per_forward * forwards
    if forwards <= 0 or got != want:
        raise AssertionError(
            f"{where}: the norm kernels launched {got} times over "
            f"{forwards} forwards; each forward's {per_forward} norms "
            f"imply {want}")
    return got


def phase_norm_kernels(dev, pu):
    """The port's InstanceNorm + LeakyReLU kernels at each stage's shape of
    the plan's forward (bf16 channel-last, f32 affine): the statistics
    pass (with its finalize launch) and the apply pass, against the plain
    ``InstanceNorm`` + ``leaky_relu_``.  Bytes: the statistics read the map
    (2 bytes an element), the apply reads and writes it (4), the plain
    path's four passes read three times and write twice (10).  The apply's
    time is the whole call's less the statistics'.  Each shape's output is
    held against ``instance_norm_act_reference`` on the same map and a
    seeded affine, at the card tests' tolerance (rtol 8e-3, atol 2e-2),
    a few samples at a time to bound the f32 reference's memory."""
    import torch
    import torch.nn.functional as F

    from att_aspp_unet_tpu_torch.ops.kernels import swin_ops as sn
    from att_aspp_unet_tpu_torch.ops.kernels.instance_norm import \
        InstanceNorm

    lib = sn._lib()
    for B, C, H, W in norm_shapes(pu):
        g = torch.Generator(device=dev).manual_seed(C + H)
        x = (torch.randn(B, C, H, W, device=dev, generator=g) * 3 + 1) \
            .bfloat16().contiguous(memory_format=torch.channels_last)
        norm = InstanceNorm(C, device=dev)
        with torch.no_grad():
            norm.weight.copy_(torch.rand(C, device=dev, generator=g) + 0.5)
            norm.bias.copy_(torch.randn(C, device=dev, generator=g))
        worst = 0.0
        with torch.no_grad():
            y = sn.instance_norm_act(x, norm, 0.01)
            for i in range(0, B, 16):
                want = sn.instance_norm_act_reference(x[i:i + 16], norm,
                                                      0.01)
                torch.testing.assert_close(
                    y[i:i + 16], want, rtol=8e-3, atol=2e-2,
                    msg=lambda m: f"norm kernels at {B}x{C}x{H}x{W}, "
                                  f"samples {i}..{i + 15}: {m}")
                worst = max(worst, float((y[i:i + 16].float()
                                          - want.float()).abs().max()))
                del want
            del y
        n = x.numel()
        t_stats = cuda_ms(lambda: sn._stats(x, norm, lib), reps=20)
        t_all = cuda_ms(lambda: sn.instance_norm_act(x, norm, 0.01), reps=20)
        t_plain = cuda_ms(lambda: F.leaky_relu_(norm(x), 0.01), reps=20)
        t_apply = t_all - t_stats
        log(f"[baseline] norm kernels at {B}x{C}x{H}x{W}: statistics "
            f"{t_stats:.4f} ms = {2 * n / t_stats / 1e6:.0f} GB/s, apply "
            f"{t_apply:.4f} ms = {4 * n / t_apply / 1e6:.0f} GB/s, both "
            f"{t_all:.4f} ms = {6 * n / t_all / 1e6:.0f} GB/s; plain "
            f"InstanceNorm + leaky_relu_ {t_plain:.4f} ms = "
            f"{10 * n / t_plain / 1e6:.0f} GB/s ({t_plain / t_all:.2f} x); "
            f"max |difference| from the reference {worst:.4g}")
        del x
    torch.cuda.empty_cache()


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
    from att_aspp_unet_tpu_torch.ops.kernels import swin_ops
    from att_aspp_unet_tpu_torch.postprocess import cc
    from att_aspp_unet_tpu_torch.postprocess.refine import \
        postprocess_softmax_stack
    from att_aspp_unet_tpu_torch.tools.probe_baseline import (
        count_iterations, thresholded_labels)
    from att_aspp_unet_tpu_torch.utils.profiling import counts

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
    # forwards of the network, to hold the norm kernels' launches to (one
    # ConvNormAct per conv of the encoder's stages and the decoder's)
    forwards = [0]
    per_forward = pu.conv_per_stage * (2 * pu.n_stages - 1)

    def on_forward(module, *_):
        if isinstance(module, PlainConvUNet):
            forwards[0] += 1

    hook = torch.nn.modules.module.register_module_forward_hook(on_forward)
    reset_launches()
    norms = swin_ops.instance_norm_act.launches
    t0 = time.perf_counter()
    rc = cli.main(argv)
    wall = time.perf_counter() - t0
    # no K1 (conv + InstanceNorm is not K1's conv + folded BN); one CLAHE
    # over the whole case
    launches = read_launches("baseline", (0, 1))
    hold_fused_norms("baseline container", norms, forwards[0], per_forward)
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

    # a warm engine: frames/s, the forward's TFLOP/s, peak memory; the
    # spans of a profiled call on the sweep
    tiles = len(compute_tile_starts(case.shape[1], pu.patch_size[0],
                                    pu.tile_step)) * \
        len(compute_tile_starts(case.shape[2], pu.patch_size[1],
                                pu.tile_step))
    frame_flops = tiles * (4 if pu.use_mirroring else 1) * plain_unet_flops(pu)
    engine = BaselineEngine(
        cfg, PlainConvUNet.from_config(pu, seed=BASELINE_SEED), device=dev)
    engine.postprocess(engine.predict(sweep[:8]))                # warm-up
    kept = {}
    for label, data in (("140", sweep), ("840", case)):
        nn = data.shape[0]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        reads = counts().get("fixed_point_reads", 0)
        norms, forwards[0] = swin_ops.instance_norm_act.launches, 0
        with count_iterations() as iters:
            t0 = time.perf_counter()
            probs = engine.predict(data)
            # the postprocess waits for the forward at its first read anyway
            torch.cuda.synchronize()
            fwd = time.perf_counter() - t0
            seg = engine.postprocess(probs)
            _, f = select_labeled_mask_and_frame(seg)
            t = time.perf_counter() - t0
        if counts()["fixed_point_reads"] - reads != sum(iters):
            raise AssertionError(
                f"baseline {nn}: the fixed_point_reads counter moved by "
                f"{counts()['fixed_point_reads'] - reads}, the exact loops "
                f"ran {iters} iterations")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        for k, v in read_launches(f"baseline engine {nn}", (0, 1)).items():
            totals[k] += v
        fused = hold_fused_norms(f"baseline engine {nn}", norms, forwards[0],
                                 per_forward)
        raw = thresholded_labels(probs)
        stats = []
        for lab in (1, 2):
            m = raw == lab
            comps = len(torch.unique(cc.label_components(m, 6, ndim=3))) - 1
            stats.append(f"class {lab}: {float(m.float().mean()):.5f} of the "
                         f"voxels, {comps} 3-D components, "
                         f"{int((seg == lab).sum())} voxels kept")
        log(f"[baseline] warm engine, {nn} frames: {t:.3f} s = "
            f"{nn / t:.2f} frames/s; predict (enhancement and forward) "
            f"{fwd:.3f} s, postprocess and frame pick {t - fwd:.3f} s; "
            f"forward {frame_flops * nn / 1e12:.2f} TFLOP ({tiles} tiles x 4 mirrors "
            f"x {plain_unet_flops(pu) / 1e9:.1f} GFLOP per frame) in "
            f"{fwd:.3f} s = {frame_flops * nn / fwd / 1e12:.1f} TFLOP/s "
            f"({100 * frame_flops * nn / fwd / PEAK_BF16_FLOPS:.1f} % of the "
            f"bf16 peak); peak memory {peak:.2f} GiB; propagation iterations "
            f"{iters}; frame {f}; after the threshold {'; '.join(stats)}; "
            f"{forwards[0]} forwards, norm kernels launched {fused} "
            f"times ({per_forward} a forward)")
        if label == "140":
            probs140, seg140, f140 = probs, seg, f
        kept[label] = int((seg > 0).sum())
        del probs, seg, raw
        torch.cuda.empty_cache()
    hook.remove()
    if not any(kept.values()):
        raise AssertionError(f"seed {BASELINE_SEED} leaves every class "
                             "empty: the postprocess does no work")
    _, spans = profiled(lambda: engine.postprocess(engine.predict(sweep)))
    log(f"[baseline] spans of a profiled call on {sweep.shape[0]} frames: "
        f"{fmt_spans(spans)}")

    # card against CPU: the forward on 2 frames (the card's bf16 and, TF32
    # off, f32 forwards against the CPU's f32), and the postprocess of the
    # card's 140-frame softmax stack
    lo = min(max(f140, 0), sweep.shape[0] - 2)
    sub = sweep[lo:lo + 2]
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
    phase_norm_kernels(dev, pu)
    return totals


# the model variants of the [variants] phase (the default v1 model first, as
# the yardstick within the call), with the CLI's flags
VARIANTS = [("v1 (default)", {}),
            ("v2, att_depth 4", dict(gate_variant="v2")),
            ("v2, att_depth 3", dict(gate_variant="v2", att_depth=3)),
            ("v1, --no_att", dict(use_att=False)),
            ("v1, --no_aspp", dict(use_aspp=False)),
            ("v2, --no_att --no_aspp", dict(gate_variant="v2", use_att=False,
                                            use_aspp=False))]
VARIANT_SEED = 0             # seeded init: no trained variant weights exist
# the calibrate phase's val set: (seed, frames, H, W) of each resolution group
VAL_GROUPS = [(10, 16, 562, 744), (11, 16, 480, 640)]
N_PNG = 4                    # PNG frames of the [png] phase


def seeded_variables(mcfg, seed: int = VARIANT_SEED):
    """``init_variables`` of the variant with BatchNorm statistics drawn as
    ``tests/torch_ref.py::randomize_bn_stats`` draws them (mean 0.1 N(0, 1),
    var U(0.75, 1.25)), from a CPU generator."""
    import torch

    from att_aspp_unet_tpu_torch.utils.convert import init_variables

    variables = init_variables(mcfg, seed)
    gen = torch.Generator().manual_seed(seed)

    def walk(tree):
        if "mean" in tree:
            tree["mean"][:] = (torch.randn(tree["mean"].shape, generator=gen)
                               * 0.1).numpy()
            tree["var"][:] = (torch.rand(tree["var"].shape, generator=gen)
                              * 0.5 + 0.75).numpy()
            return
        for sub in tree.values():
            walk(sub)

    walk(variables["batch_stats"])
    return variables


def save_flat_npz(path: Path, variables) -> None:
    """A variables tree as the flat ``params/...`` / ``batch_stats/...`` npz
    archive that the CLI reads."""
    import numpy as np

    flat = {}

    def walk(prefix, tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(f"{prefix}/{k}", v)
            else:
                flat[f"{prefix}/{k}"] = np.asarray(v)

    for coll in ("params", "batch_stats"):
        walk(coll, variables[coll])
    np.savez(path, **flat)


def make_val_group(seed: int, n: int, H: int, W: int):
    """The frames of ``make_sweep(n, H, W, seed)`` with the truth masks the
    generator draws for them (0 / 255; zero on the frames without an
    abdomen)."""
    import numpy as np

    from att_aspp_unet_tpu_torch.tools.synthetic import make_frame

    rng = np.random.default_rng(seed)
    best = int(rng.integers(int(0.3 * n), int(0.7 * n)))
    imgs, masks = [], []
    for i in range(n):
        q = max(0.0, 1.0 - abs(i - best) / max(n * 0.25, 1))
        im, m, _ = (make_frame(rng, H, W, positive=False) if q < 0.25 else
                    make_frame(rng, H, W, positive=True, quality=q))
        imgs.append(im)
        masks.append(m)
    return np.stack(imgs), np.stack(masks)


def run_cli(argv, where: str, expect=None, count: bool = True):
    """``cli.main(argv)`` with the launch counters zeroed just before and,
    with ``count``, read just after and held to ``expect``; returns
    (seconds, launches or None, stdout)."""
    import torch

    from att_aspp_unet_tpu_torch import cli

    out = io.StringIO()
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"{where}: cli rc {rc}")
    return wall, read_launches(where, expect) if count else None, \
        out.getvalue()


def phase_variants(dev, sweep, best_true, thr, tmp):
    """Every model variant at full width (base_c 48, 512 x 512, bf16) from the
    seeded init: the forward on 8 frames, card against the CPU's plain
    versions (logits and psi maps), then a warm ``predict_case`` on the
    140-frame sweep; then ``cli predict --gate v2`` with a reference ``.pt``
    state dict of ``tests/torch_ref.py::AttentionASPPUNetV2``."""
    import dataclasses

    import numpy as np
    import torch

    from att_aspp_unet_tpu_torch.config import ModelConfig
    from att_aspp_unet_tpu_torch.infer.engine import AttAsppEngine
    from att_aspp_unet_tpu_torch.io import read_json
    from att_aspp_unet_tpu_torch.preprocess import preprocess_sweep
    from att_aspp_unet_tpu_torch.utils.convert import jax_variables_to_torch

    n = sweep.shape[0]
    lo = min(max(0, best_true - 4), n - 8)
    p = main_config().preprocess
    with torch.no_grad():
        x = preprocess_sweep(torch.as_tensor(sweep[lo:lo + 8]), p.img_size,
                             p.clahe_clip, p.clahe_grid,
                             p.median_kernel)[:, None]
    totals = new_totals()
    rates = {}
    for label, kw in VARIANTS:
        mcfg = dataclasses.replace(ModelConfig(base_c=BASE_C), **kw)
        variables = seeded_variables(mcfg)
        card = jax_variables_to_torch(variables, mcfg, device=dev)
        got, got_psi = card(x.to(dev), return_psi=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want, want_psi = jax_variables_to_torch(variables, mcfg)(
            x, return_psi=True)
        t_cpu = time.perf_counter() - t0
        span = float(want.max() - want.min())
        err = float((got.float().cpu() - want).abs().max())
        sign = float(((got.cpu() > 0) == (want > 0)).float().mean())
        psi_err = [None if w is None else
                   float((g.float().cpu() - w.float()).abs().max())
                   for g, w in zip(got_psi, want_psi)]
        if ([g is None for g in got_psi] != [w is None for w in want_psi]
                or err > 2e-2 * span or sign < 0.99
                or any(e is not None and e > 2e-2 for e in psi_err)):
            raise AssertionError(
                f"variants {label}: card and CPU forwards disagree: max "
                f"|logit diff| {err:.4g} (range {span:.4g}), sign agreement "
                f"{sign:.5f}, psi max |diff| {psi_err}")

        cfg = dataclasses.replace(main_config(), model=mcfg)
        engine = AttAsppEngine(cfg, variables, device=dev, model=card)
        engine.predict_case(sweep[:16], SPACING, thr)          # warm-up
        times = []
        for _ in range(2):
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            frame, _, _ = engine.predict_case(sweep, SPACING, thr)
            times.append(time.perf_counter() - t0)
            got_l = read_launches(f"variants {label}",
                                  (forward_launches(n, 16), 1))
            for k, v in got_l.items():
                totals[k] += v
        rates[label] = n / min(times)
        _, spans = profiled(lambda: engine.predict_case(sweep, SPACING, thr))
        log(f"[variants] {label}: forward on 8 frames {lo}..{lo + 7}, card vs "
            f"CPU plain ({t_cpu:.1f} s): max |logit diff| {err:.4g} of a "
            f"{span:.4g} range (tolerance 2e-2 of it), signs agree on "
            f"{100 * sign:.3f} % (tolerance 99 %), psi [psi3, psi2] max "
            f"|diff| {psi_err} (tolerance 2e-2); warm predict_case on {n} "
            f"frames: {min(times):.3f} s / {max(times):.3f} s = "
            f"{rates[label]:.1f} frames/s (x{rates[label] / rates[VARIANTS[0][0]]:.3f}"
            f" of {VARIANTS[0][0]}), frame {frame}; spans of a profiled "
            f"call {fmt_spans(spans)}")
        del card, engine, got, want
        torch.cuda.empty_cache()

    # a reference .pt state dict through the predict CLI
    sys.path.insert(0, str(REPO / "tests"))
    from torch_ref import AttentionASPPUNetV2, randomize_bn_stats

    torch.manual_seed(VARIANT_SEED)
    ref = AttentionASPPUNetV2(base_c=BASE_C)
    randomize_bn_stats(ref, torch.Generator().manual_seed(VARIANT_SEED))
    torch.save(ref.state_dict(), tmp / "v2_reference.pt")
    argv = ["predict", "--weights", str(tmp / "v2_reference.pt"), "--gate",
            "v2", "--base_c", str(BASE_C), "--input_dir", str(tmp / "in140"),
            "--out_dir", str(tmp / "out_v2pt"), "--thr", str(thr),
            "--device", dev]
    wall, launches, out = run_cli(argv, "variants cli .pt",
                                  (forward_launches(n, 16), 1))
    for k, v in launches.items():
        totals[k] += v
    counts = [s for s in out.splitlines() if "[torch_import]" in s]
    frame = int(read_json(tmp / "out_v2pt/sweep_0/"
                          "fetal-abdomen-frame-number.json"))
    log(f"[variants] cli predict --gate v2 --weights <AttentionASPPUNetV2 "
        f"base_c {BASE_C}>.pt on {n} frames: {wall:.2f} s = {n / wall:.1f} "
        f"frames/s end to end; {counts}; frame {frame}; kernel launches "
        f"{launches}")
    if counts != ["[torch_import] loaded with 0 missing & 0 unexpected keys"]:
        raise AssertionError(f"variants: .pt import reported {counts}")
    # the card's frame against the CPU's on six frames around it
    from att_aspp_unet_tpu_torch.utils.convert import init_variables
    from att_aspp_unet_tpu_torch.utils.torch_import import \
        load_torch_checkpoint

    mcfg = ModelConfig(base_c=BASE_C, gate_variant="v2")
    with contextlib.redirect_stdout(io.StringIO()):
        variables = load_torch_checkpoint(tmp / "v2_reference.pt", mcfg,
                                          init_variables(mcfg, 0))
    cfg = dataclasses.replace(main_config(), model=mcfg)
    lo = min(max(0, frame - 3), n - 6)
    sub = sweep[lo:lo + 6]
    f_card, m_card, _ = AttAsppEngine(cfg, variables, device=dev) \
        .predict_case(sub, SPACING, thr)
    t0 = time.perf_counter()
    f_cpu, m_cpu, _ = AttAsppEngine(cfg, variables, device="cpu") \
        .predict_case(sub, SPACING, thr)
    d = dice(m_card, m_cpu)
    log(f"[variants] the .pt model on frames {lo}..{lo + 5}: card frame "
        f"{lo + f_card}, CPU plain frame {lo + f_cpu} "
        f"({time.perf_counter() - t0:.1f} s), mask Dice {d:.5f}, "
        f"{int(m_card.sum())} / {int(m_cpu.sum())} mask pixels")
    if f_card != f_cpu or d < 0.98:
        raise AssertionError("variants: card and CPU plain versions disagree")
    return totals


def phase_calibrate(dev, val, tmp):
    """``cli calibrate`` with the repo's trained weights on a PNG val set of
    two resolution groups, on the card and on the CPU: the same thr.json, the
    per-image Dice curves within 2e-2 and their mean within 5e-3."""
    import numpy as np

    from att_aspp_unet_tpu_torch.io import read_json, write_gray_png

    vdir = tmp / "val"
    k = 0
    for imgs, masks in val:
        for im, m in zip(imgs, masks):
            write_gray_png(vdir / "images" / f"v{k:02d}.png", im)
            write_gray_png(vdir / "masks" / f"v{k:02d}.png", m)
            k += 1
    n_groups = len(val)
    # one predict_full per group: one micro-batch of 16 frames with their
    # hflip twins, one CLAHE
    expect = (sum(forward_launches(len(g[0]), 16) for g in val), n_groups)
    curves, thrs, secs = {}, {}, {}
    launches = None
    for device in (dev, "cpu"):
        out = tmp / f"cal_{device}"
        argv = ["calibrate", "--weights", str(REPO / MAIN_WEIGHTS),
                "--base_c", str(BASE_C), "--val_dir", str(vdir), "--output_dir", str(out), "--ci",
                "--device", device]
        secs[device], got, _ = run_cli(argv, "calibrate", expect,
                                       count=device == dev)
        launches = launches or got
        thrs[device] = read_json(out / "thr.json")
        with open(out / "calibrate_raw.csv", newline="") as f:
            curves[device] = np.array([r[1:] for r in csv.reader(f)][1:],
                                      float)
    d_img = float(np.abs(curves[dev] - curves["cpu"]).max())
    d_mean = float(np.abs(curves[dev].mean(0) - curves["cpu"].mean(0)).max())
    log(f"[calibrate] cli calibrate --ci on {k} PNGs ({n_groups} resolution "
        f"groups: {[tuple(g[0].shape) for g in val]}): card {secs[dev]:.2f} s "
        f"= {k / secs[dev]:.1f} frames/s, CPU plain {secs['cpu']:.1f} s; "
        f"thr.json card {thrs[dev]}, CPU {thrs['cpu']}; best mean Dice "
        f"{curves[dev].mean(0).max():.4f}; per-image Dice max |diff| "
        f"{d_img:.3g} (tolerance 2e-2), mean-curve max |diff| {d_mean:.3g} "
        f"(tolerance 5e-3); kernel launches {launches}")
    if thrs[dev] != thrs["cpu"] or d_img > 2e-2 or d_mean > 5e-3:
        raise AssertionError("calibrate: card and CPU disagree")
    return launches


def phase_png(dev, sweep, best_true, thr, tmp):
    """``cli predict`` on a directory of PNG frames with ``--viz_att
    --weights_noatt`` (the no-att model at base_c 48 from the seeded init) on
    the card and on the CPU: equal masks, equal AC rows, panels written; then
    ``--slice_metrics --topk_viz`` on the 140-frame sweep on the card, and on
    six of its frames on the card and on the CPU: equal CSV rows."""
    import numpy as np

    from att_aspp_unet_tpu_torch.config import ModelConfig
    from att_aspp_unet_tpu_torch.io import (MetaImage, read_gray_png,
                                            write_gray_png, write_mha)

    n = sweep.shape[0]
    lo = min(max(0, best_true - N_PNG // 2), n - N_PNG)
    pdir = tmp / "png_in"
    for i in range(lo, lo + N_PNG):
        write_gray_png(pdir / f"sweep0_s{i}.png", sweep[i])
    (tmp / "spacing.json").write_text(json.dumps({"sweep0": list(SPACING)}))
    save_flat_npz(tmp / "noatt.npz", seeded_variables(
        ModelConfig(base_c=BASE_C, use_att=False, att_depth=0)))
    # per PNG: predict_full (hflip pair), psi_sweep (one frame), the no-att
    # model's predict_full (hflip pair); each enhances once
    expect = (N_PNG * 3 * forward_launches(1, 16), N_PNG * 3)
    secs, launches = {}, None
    for device in (dev, "cpu"):
        argv = ["predict", "--weights", str(REPO / MAIN_WEIGHTS),
                "--base_c", str(BASE_C), "--input_dir", str(pdir), "--out_dir", str(tmp / f"png_{device}"),
                "--thr", str(thr), "--spacing_json", str(tmp / "spacing.json"),
                "--viz_att", "--weights_noatt", str(tmp / "noatt.npz"),
                "--device", device]
        secs[device], got, _ = run_cli(argv, "png", expect,
                                       count=device == dev)
        launches = launches or got
    stems = [f"sweep0_s{i}" for i in range(lo, lo + N_PNG)]
    masks = {d: [read_gray_png(tmp / f"png_{d}/{s}_mask.png") for s in stems]
             for d in (dev, "cpu")}
    diff = [int((a != b).sum()) for a, b in zip(masks[dev], masks["cpu"])]
    dices = [dice(a, b) for a, b in zip(masks[dev], masks["cpu"])]
    fg = [int((m > 0).sum()) for m in masks[dev]]
    rows = {d: (tmp / f"png_{d}/ac_results.csv").read_text().splitlines()
            for d in (dev, "cpu")}
    panels = sorted(p.name for p in (tmp / f"png_{dev}/panels").iterdir())
    log(f"[png] cli predict --viz_att --weights_noatt on {N_PNG} PNG frames "
        f"{lo}..{lo + N_PNG - 1} ({sweep.shape[1]}x{sweep.shape[2]}): card "
        f"{secs[dev]:.2f} s = {secs[dev] / N_PNG:.3f} s per frame (the CLI "
        f"call, models built and loaded), CPU plain {secs['cpu']:.1f} s; mask "
        f"pixels {fg}, differing from the CPU's {diff} (mask Dice "
        f"{[round(d, 6) for d in dices]}, tolerance 0.999: bf16 rounding at "
        f"the threshold); AC rows card {rows[dev][1:]}, CPU "
        f"{rows['cpu'][1:]}; panels {len(panels)}; kernel launches "
        f"{launches}")
    if (min(dices) < 0.999 or rows[dev] != rows["cpu"]
            or len(panels) != N_PNG):
        raise AssertionError("png: card and CPU disagree or panels missing")

    # a warm engine pair per PNG frame: what the CLI does for each frame
    import dataclasses

    import torch

    from att_aspp_unet_tpu_torch.infer.engine import AttAsppEngine
    from att_aspp_unet_tpu_torch.utils.npz_weights import load_npz_variables

    cfg = main_config()
    na_cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, use_att=False, att_depth=0))
    main_eng = AttAsppEngine(cfg, load_npz_variables(REPO / MAIN_WEIGHTS),
                             device=dev)
    na_eng = AttAsppEngine(na_cfg, load_npz_variables(tmp / "noatt.npz"),
                           device=dev)
    frames = [read_gray_png(pdir / f"{s}.png") for s in stems]

    def one(sl):
        probs = main_eng.predict_full(sl[None])
        main_eng.refine(probs, thr).cpu()
        main_eng.psi_sweep(sl[None])
        na_eng.refine(na_eng.predict_full(sl[None]), thr).cpu()

    one(frames[0])                                   # warm-up
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for sl in frames:
        one(sl)
    per = (time.perf_counter() - t0) / N_PNG
    warm = read_launches("png, warm engines", expect)
    for k, v in warm.items():
        launches[k] += v
    log(f"[png] warm engines, per PNG frame (predict_full + refine, psi "
        f"maps, the no-att model's predict_full + refine): {per:.4f} s; "
        f"kernel launches {warm}")
    del main_eng, na_eng

    # the diagnostics of a sweep: every frame refined, per-slice CSV, top-K
    argv = ["predict", "--weights", str(REPO / MAIN_WEIGHTS), "--base_c",
            str(BASE_C), "--input_dir", str(tmp / "in140"), "--out_dir",
            str(tmp / "diag140"), "--thr",
            str(thr), "--slice_metrics", "--topk_viz", "--device", dev]
    wall, got, _ = run_cli(argv, "png diagnostics",
                           (forward_launches(n, 16), 1))
    for k, v in got.items():
        launches[k] += v
    with open(tmp / "diag140/sweep_0_slices.csv", newline="") as f:
        n_rows = len(list(csv.reader(f))) - 1
    sheet = tmp / "diag140/sweep_0_topk.png"
    log(f"[png] cli predict --slice_metrics --topk_viz on the {n}-frame sweep: "
        f"{wall:.2f} s = {n / wall:.1f} frames/s; {n_rows} CSV rows, top-K "
        f"sheet {sheet.stat().st_size if sheet.exists() else 0} bytes; kernel "
        f"launches {got}")
    if n_rows != n or not sheet.exists():
        raise AssertionError("png: diagnostics outputs missing")
    lo = min(max(0, best_true - 3), n - 6)
    (tmp / "diag_in").mkdir()
    write_mha(tmp / "diag_in/sub.mha", MetaImage(sweep[lo:lo + 6],
                                                 spacing=(0.28, 0.28, 1.0)))
    slices, text = {}, {}
    for device in (dev, "cpu"):
        argv = ["predict", "--weights", str(REPO / MAIN_WEIGHTS),
                "--base_c", str(BASE_C), "--input_dir", str(tmp / "diag_in"),
                "--out_dir", str(tmp / f"diag_{device}"), "--thr", str(thr),
                "--slice_metrics", "--topk_viz", "--device", device]
        _, got, _ = run_cli(argv, "png diagnostics, 6 frames",
                            (forward_launches(6, 16), 1), count=device == dev)
        for k, v in (got or {}).items():
            launches[k] += v
        text[device] = (tmp / f"diag_{device}/ac_results.csv").read_text()
        with open(tmp / f"diag_{device}/sub_slices.csv", newline="") as f:
            slices[device] = np.array([r[2:] for r in csv.reader(f)][1:],
                                      float)
    d_area = np.abs(slices[dev][:, 0] - slices["cpu"][:, 0])
    d_circ = float(np.abs(slices[dev][:, 1] - slices["cpu"][:, 1]).max())
    log(f"[png] --slice_metrics on frames {lo}..{lo + 5}, card vs CPU plain: "
        f"areas card {slices[dev][:, 0].astype(int).tolist()}, differing by "
        f"{d_area.astype(int).tolist()} px (tolerance 0.1 % of the area, at "
        f"least 2 px), circularity max |diff| {d_circ:.3g} (tolerance 1e-3); "
        f"AC row card {text[dev].splitlines()[1:]}, CPU "
        f"{text['cpu'].splitlines()[1:]}")
    if (text[dev] != text["cpu"] or d_circ > 1e-3 or np.any(
            d_area > np.maximum(2, 1e-3 * slices["cpu"][:, 0]))):
        raise AssertionError("png: the slice CSVs or the frame differ")
    return launches


# the [train] phase's data: (seed, positives, negatives) of the synthetic
# train and val PNG pairs at the CLI's 512 x 512 (tools/synthetic.make_dataset)
TRAIN_SET, VAL_SET = (20, 28, 4), (21, 7, 1)
TRAIN_SIZE, TRAIN_BATCH = 512, 8


def make_train_set(seed: int, n_pos: int, n_neg: int):
    from att_aspp_unet_tpu_torch.tools.synthetic import make_dataset

    return make_dataset(n_pos, n_neg, TRAIN_SIZE, seed=seed)


def write_pairs(root: Path, imgs, msks) -> None:
    from att_aspp_unet_tpu_torch.io import write_gray_png

    for i, (im, m) in enumerate(zip(imgs, msks)):
        write_gray_png(root / "images" / f"s{i:03d}.png", im)
        write_gray_png(root / "masks" / f"s{i:03d}.png", m)


def phase_train_parity(dev, imgs, msks):
    """One train step at base_c 8, 128 x 128, batch 4, ASPP dropout 0, from
    the same seeded init and the same CPU-drawn augmentation, on the card and
    on the CPU: the augmented batch equal (K2 against the plain CLAHE blend);
    the model in f64 (the loss stays f32), card against CPU: gradients within
    1e-4 of each leaf's max-abs (the same function); in exact f32 the loss
    within 1e-4 relative and each leaf's gradient within 1e-3 of its max-abs
    of the CPU's, beyond twice the CPU's own f32 error against f64 on that
    leaf (a BN before another train-mode BN has per-channel sums that nearly
    cancel: f32 gets them to ~1e-2 on either device); the bf16 loss within
    2e-2 of the f32 one."""
    import dataclasses

    import torch

    from att_aspp_unet_tpu_torch.config import (Config, ModelConfig,
                                                TrainConfig)
    from att_aspp_unet_tpu_torch.ops.image import resize_bilinear
    from att_aspp_unet_tpu_torch.train.augment import (augment_batch,
                                                       sample_params)
    from att_aspp_unet_tpu_torch.train.train_loop import (create_train_state,
                                                          loss_and_grads)

    t = torch.as_tensor(imgs[:4]).float()
    u8 = resize_bilinear(t, (128, 128)).round().clamp(0, 255).to(torch.uint8)
    m8 = torch.nn.functional.interpolate(
        torch.as_tensor(msks[:4]).float()[:, None], size=(128, 128),
        mode="nearest")[:, 0].to(torch.uint8)
    cfg = Config(model=ModelConfig(base_c=8, compute_dtype="float32",
                                   aspp_dropout=0.0),
                 train=TrainConfig(batch_size=4, seed=SEED))
    params = sample_params(torch.Generator().manual_seed(SEED), 4, 128, 128,
                           cfg.train.augment)

    def step(where, dtype):
        c = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, compute_dtype=dtype))
        x, y = augment_batch(u8.to(where), m8.to(where), c.train.augment,
                             params)
        state = create_train_state(c.model, c.train, 1, where)
        loss, _, grads = loss_and_grads(state, c, x, y)
        return (x.cpu(), y.cpu(), float(loss.detach()),
                {n: g.double().cpu() for n, g in zip(state.opt.names, grads)})

    run = {(w, d): step(w, d) for w in ("cpu", dev)
           for d in ("float32", "float64")}
    xc, yc, lc, gc = run["cpu", "float32"]
    xd, yd, ld, gd = run[dev, "float32"]
    if not all(torch.equal(a, b) for a, b in [(xc, xd), (yc, yd)]
               + [(xc, run[k][0]) for k in run]):
        raise AssertionError(
            f"train: the augmented batch differs on the card: "
            f"{int((xc != xd).sum())} image and {int((yc != yd).sum())} mask "
            "values")

    def worst(got, want):
        errs = sorted(((float((got[n] - want[n]).abs().max())
                        / max(float(want[n].abs().max()), 1e-30), n)
                       for n in want), reverse=True)
        return errs

    g64 = run["cpu", "float64"][3]
    e64 = worst(run[dev, "float64"][3], g64)
    e_card, e_cpu, e_pair = worst(gd, g64), worst(gc, g64), worst(gd, gc)
    cpu_err = {n: e for e, n in e_cpu}
    excess = sorted(((e - 2 * cpu_err[n], n) for e, n in e_pair),
                    reverse=True)
    rel = abs(ld - lc) / abs(lc)
    cfg16 = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, compute_dtype="bfloat16"))
    x, y = augment_batch(u8.to(dev), m8.to(dev), cfg16.train.augment, params)
    state = create_train_state(cfg16.model, cfg16.train, 1, dev)
    l16 = float(loss_and_grads(state, cfg16, x, y)[0].detach())
    rel16 = abs(l16 - lc) / abs(lc)

    def top(errs):
        return ", ".join(f"{n} {e:.2e}" for e, n in errs[:4])

    log(f"[train] card vs CPU, base_c 8, 128^2, batch 4: augmented batch "
        f"equal; exact-f32 step loss card {ld:.7f} CPU {lc:.7f} (rel "
        f"{rel:.2e}, tolerance 1e-4), bf16 loss {l16:.6f} (rel {rel16:.2e} "
        f"of f32, tolerance 2e-2); gradients, max |diff| / leaf max-abs: f64 "
        f"card vs CPU {e64[0][0]:.2e} at {e64[0][1]} (tolerance 1e-4); f32 "
        f"card vs f32 CPU [{top(e_pair)}], beyond twice the CPU's f32 error "
        f"at most {excess[0][0]:.2e} at {excess[0][1]} (tolerance 1e-3); f32 "
        f"card vs f64 [{top(e_card)}], f32 CPU vs f64 [{top(e_cpu)}]")
    if (rel > 1e-4 or rel16 > 2e-2 or e64[0][0] > 1e-4
            or excess[0][0] > 1e-3):
        raise AssertionError("train: the card's step disagrees with the CPU")


def phase_train(dev, sweep, best_true, thr, tmp, train_set, val_set):
    """``cli train`` at full width on synthetic PNG pairs (main, resume,
    finetune from the repo's weights, differential learning rate from the
    port's checkpoint), 20 steps on a fixed batch, then the finetuned export
    served by ``cli predict`` and a one-epoch scout driving the cascade."""
    import numpy as np
    import torch

    from att_aspp_unet_tpu_torch.bench import forward_gflops
    from att_aspp_unet_tpu_torch.config import (Config, ModelConfig,
                                                TrainConfig)
    from att_aspp_unet_tpu_torch.io import read_mha
    from att_aspp_unet_tpu_torch.ops.kernels import clahe_interp as ci
    from att_aspp_unet_tpu_torch.ops.kernels import fused_conv as fc
    from att_aspp_unet_tpu_torch.train.augment import sample_params
    from att_aspp_unet_tpu_torch.train.train_loop import (create_train_state,
                                                          train_step)

    phase_train_parity(dev, *train_set)
    tr, va = tmp / "train_pngs", tmp / "val_pngs"
    write_pairs(tr, *train_set)
    write_pairs(va, *val_set)
    n_tr, n_va = len(train_set[0]), len(val_set[0])
    per_epoch = n_tr // TRAIN_BATCH + -(-n_va // TRAIN_BATCH)
    # card 0 by its index: one process, whose launches this process counts,
    # also where several cards are visible ([ddp] drives those)
    base = ["train", "--train_dir", str(tr), "--val_dir", str(va),
            "--base_c", str(BASE_C), "--img_size", str(TRAIN_SIZE),
            "--batch_size", str(TRAIN_BATCH), "--device", f"{dev}:0"]
    totals = new_totals()

    def train_cli(label, out, epochs_run, *extra):
        """A ``cli train`` call; K2 once per train step and val batch."""
        wall, launches, text = run_cli(
            base + ["--output_dir", str(out), *extra], f"train {label}",
            (0, epochs_run * per_epoch))
        for k, v in launches.items():
            totals[k] += v
        epochs = [ln for ln in text.splitlines() if ln.startswith("epoch")]
        log(f"[train] cli train {label}: {wall:.2f} s, kernel launches "
            f"{launches}; " + "; ".join(epochs))
        return text

    main_out = tmp / "train_main"
    train_cli("main, 2 epochs", main_out, 2, "--epochs", "2", "--export_npz")
    text = train_cli("resumed to 3 epochs", main_out, 1, "--epochs", "3",
                     "--export_npz")
    with open(main_out / "ckpt_main/metrics.csv", newline="") as f:
        rows = list(csv.reader(f))
    if "resumed from" not in text or [r[0] for r in rows[1:]] != \
            ["1", "2", "3"]:
        raise AssertionError(f"train: resume failed: {rows}")
    ft_out = tmp / "train_finetune"
    train_cli("--stage finetune from the repo's weights", ft_out, 1,
              "--stage", "finetune", "--pretrained", str(REPO / MAIN_WEIGHTS),
              "--epochs", "1", "--export_npz")
    train_cli("--stage finetune --differential_lr from the port's "
              "checkpoint", tmp / "train_dlr", 1, "--stage", "finetune",
              "--pretrained", str(main_out / "ckpt_main/best"),
              "--differential_lr", "--epochs", "1")

    # 20 steps on one fixed batch (one augmentation draw) from the seeded
    # init, the warmup of a 20-step epoch: the loss must fall
    cfg = Config(model=ModelConfig(base_c=BASE_C),
                 train=TrainConfig(batch_size=TRAIN_BATCH, epochs=1))
    state = create_train_state(cfg.model, cfg.train, 20, dev)
    imgs, msks = (torch.as_tensor(a[:TRAIN_BATCH]).to(dev) for a in train_set)
    params = sample_params(torch.Generator().manual_seed(SEED), TRAIN_BATCH,
                           TRAIN_SIZE, TRAIN_SIZE, cfg.train.augment)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    metrics, times = [], []
    for _ in range(20):
        t0 = time.perf_counter()
        metrics.append(train_step(state, cfg, imgs, msks, aug_params=params))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = read_launches("train 20 steps", (0, 20))
    for k, v in launches.items():
        totals[k] += v
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = torch.stack(metrics)[:, 0].tolist()
    step_ms = 1e3 * statistics.median(times[3:])
    gflop = forward_gflops(BASE_C, TRAIN_SIZE)
    flops = 3 * gflop * 1e9 * TRAIN_BATCH
    log(f"[train] 20 steps, base_c {BASE_C}, {TRAIN_SIZE}^2, batch "
        f"{TRAIN_BATCH}, bf16: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
        f"(first five {np.mean(losses[:5]):.4f}, last five "
        f"{np.mean(losses[-5:]):.4f}); median {step_ms:.2f} ms per step "
        f"after 3 warm-up steps (min {1e3 * min(times[3:]):.2f}, first "
        f"{1e3 * times[0]:.1f}) = {1e3 * TRAIN_BATCH / step_ms:.1f} images/s, "
        f"{flops / step_ms / 1e9:.1f} TFLOP/s at 3 x "
        f"{gflop:.2f} GFLOP per frame "
        f"({100 * flops / step_ms / 1e-3 / PEAK_BF16_FLOPS:.1f} % of the bf16 "
        f"peak), peak memory {peak:.2f} GiB; kernel launches {launches}")
    if not np.mean(losses[-5:]) < np.mean(losses[:5]):
        raise AssertionError(f"train: the loss did not fall: {losses}")
    del state, imgs, msks, metrics
    torch.cuda.empty_cache()

    # serve what was trained: the finetuned export on the 140-frame sweep
    out = tmp / "out_trained"
    wall, launches, _ = run_cli(
        ["predict", "--weights", str(ft_out / "weights.npz"), "--base_c",
         str(BASE_C), "--input_dir", str(tmp / "in140"), "--out_dir",
         str(out), "--thr", str(thr), "--device", dev],
        "train predict", (forward_launches(sweep.shape[0], 16), 1))
    for k, v in launches.items():
        totals[k] += v
    frame, ac = check_case_output(out, "sweep_0", sweep.shape,
                                  abdomen_frames(sweep.shape[0], best_true),
                                  "train predict")
    log(f"[train] cli predict --weights <finetuned export>: {wall:.2f} s, "
        f"frame {frame} (generator's best {best_true}), AC {ac} mm, kernel "
        f"launches {launches}")

    # a one-epoch scout (128 px, base_c 16, no CLAHE: no K2 in its steps)
    # ranks the cascade's tier 1
    scout = tmp / "train_scout"
    wall, _, text = run_cli(
        base + ["--output_dir", str(scout), "--img_size", "128", "--base_c",
                "16", "--no_clahe", "--epochs", "1", "--export_npz"],
        # (argparse keeps the last --img_size / --base_c)
        "train scout", count=False)
    if fc.fused_double_cbr.launches or ci.clahe_interp.launches:
        raise AssertionError("train scout: a kernel launched where the path "
                             "runs none")
    log(f"[train] cli train --img_size 128 --base_c 16 --no_clahe, 1 epoch: "
        f"{wall:.2f} s, no kernel launches (no CLAHE, no K1 in training)")
    out = tmp / "out_trained_cascade"
    wall, launches, _ = run_cli(
        ["predict", "--weights", str(ft_out / "weights.npz"), "--base_c",
         str(BASE_C), "--input_dir", str(tmp / "in140"), "--out_dir",
         str(out), "--thr", str(thr), "--device", dev, "--cascade",
         "--scout_weights", str(scout / "weights.npz")],
        "train cascade", cascade_launches(sweep.shape[0], 8, 16))
    for k, v in launches.items():
        totals[k] += v
    arr = read_mha(out / "sweep_0" /
                   "images/fetal-abdomen-segmentation/output.mha").array
    if arr.shape != sweep.shape or not set(np.unique(arr)) <= {0, 2}:
        raise AssertionError("train cascade: malformed output")
    log(f"[train] cli predict --cascade --scout_weights <one-epoch scout>: "
        f"{wall:.2f} s, output {arr.shape}, mask on frames "
        f"{np.flatnonzero(arr.reshape(len(arr), -1).any(1)).tolist()}, "
        f"kernel launches {launches}")
    return totals


N_COMPAT_CPU = 12            # frames of the facade's card-vs-CPU case
N_TOOLS_PNG = 16             # PNG pairs of the [tools] phase's dataset
ENTRY_LAUNCHER = r"""
import time
marks = {"start": time.time()}
import atexit, json, os, runpy, sys
import torch
marks["torch_imported"] = time.time()
if os.environ.get("DEVICE", "cuda") != "cpu":
    torch.zeros(1, device=os.environ.get("DEVICE", "cuda"))
    torch.cuda.synchronize()
marks["device_ready"] = time.time()
from att_aspp_unet_tpu_torch.infer import engine as eng
from att_aspp_unet_tpu_torch.ops.kernels import clahe_interp as ci
from att_aspp_unet_tpu_torch.ops.kernels import fused_conv as fc

def timed_init(init):
    def wrapped(self, *a, **kw):
        init(self, *a, **kw)
        if os.environ.get("DEVICE", "cuda") != "cpu":
            torch.cuda.synchronize()
        marks["engine_built"] = time.time()
    return wrapped

for cls in (eng.AttAsppEngine, eng.BaselineEngine):
    cls.__init__ = timed_init(cls.__init__)

def report():
    marks["end"] = time.time()
    print("LAUNCHES " + json.dumps(
        [fc.fused_double_cbr.launches, ci.clahe_interp.launches]), flush=True)
    print("MARKS " + json.dumps(marks), flush=True)

atexit.register(report)
module = sys.argv[1]
sys.argv = [module]
runpy.run_module(module, run_name="__main__", alter_sys=True)
"""
ENTRY_MODULE = "att_aspp_unet_tpu_torch.inference"
# the variables of the entry point's environment; a run sets its own
ENTRY_ENV = ("MODEL_TAG", "WEIGHTS", "PLANS", "DATASET_JSON", "CASE_ID",
             "DEVICE")


def write_case_tree(root: Path, name: str, vol, compressed=False) -> Path:
    """``vol`` as the single case of a container input tree under ``root``."""
    from att_aspp_unet_tpu_torch.io import MetaImage, write_mha

    src = root / "images/stacked-fetal-ultrasound"
    src.mkdir(parents=True)
    write_mha(src / f"{name}.mha", MetaImage(vol, spacing=(0.28,) * 3),
              compressed=compressed)
    return src / f"{name}.mha"


def check_container_contract(out: Path, case_id: str, shape, frames,
                             where: str):
    """The written volume is uint8 {0, 1} of the input's shape with spacing
    0.28, the frame JSON names a frame in ``frames`` and the foreground lies
    only on it; returns (frame, mask pixels)."""
    import numpy as np

    from att_aspp_unet_tpu_torch.io import read_json, read_mha

    vol = read_mha(out / f"images/fetal-abdomen-segmentation/{case_id}.mha")
    frame = read_json(out / "fetal-abdomen-frame-number.json")
    arr = vol.array
    fg = np.flatnonzero(arr.reshape(shape[0], -1).any(axis=1)).tolist()
    log(f"[{where}] volume {arr.shape} {arr.dtype} values "
        f"{sorted(np.unique(arr).tolist())}, spacing {vol.spacing}, mask on "
        f"frames {fg}, frame JSON {frame}")
    if not (arr.shape == tuple(shape) and arr.dtype == np.uint8
            and set(np.unique(arr)) <= {0, 1} and fg == [frame]
            and all(abs(v - 0.28) < 1e-9 for v in vol.spacing)
            and frame in frames and arr.any()):
        raise AssertionError(f"{where}: outputs failed the container contract")
    return frame, int(arr.sum())


def phase_compat(dev, case, sweeps, variables, tmp):
    """The reference-API facade ``FetalAbdomenSegmentation``: ``att_aspp``
    from the repo's weights on the 840-frame case (K1 64, K2 1; equal to
    ``AttAsppEngine.predict_roi`` on the same case), card against CPU on 12
    frames; ``baseline`` (the in-repo plan, seed 0) on 140 frames (K2 1, K1
    0); ``validate`` on the six sweeps and on a duplicate; the probability
    dump relative to the working directory."""
    import numpy as np
    import torch

    from att_aspp_unet_tpu_torch import compat
    from att_aspp_unet_tpu_torch.infer.engine import AttAsppEngine
    from att_aspp_unet_tpu_torch.io import MetaImage, write_mha
    from att_aspp_unet_tpu_torch.models import PlainConvUNet

    n = case.shape[0]
    n_sub = min(128, n)
    idxs = np.linspace(0, n - 1, n_sub).astype(int)
    root = tmp / "compat"
    root.mkdir()
    path = root / "case_840.mha"
    write_mha(path, MetaImage(case, spacing=(0.28,) * 3), compressed=False)
    totals = new_totals()

    def add(launches):
        for k, v in launches.items():
            totals[k] += v

    cfg = main_config()         # the default Config at the main width
    fac = compat.FetalAbdomenSegmentation(str(REPO / MAIN_WEIGHTS),
                                          model_tag="att_aspp", cfg=cfg,
                                          device=dev)
    secs = []
    for run in ("cold", "warm"):
        reset_launches()
        t0 = time.perf_counter()
        probs = fac.predict(str(path))
        masks = fac.postprocess(probs)
        sel, frame = compat.select_fetal_abdomen_mask_and_frame(masks)
        secs.append(time.perf_counter() - t0)
        # 128 subsampled frames in 8 micro-batches of 16 x 8 pairs; one CLAHE
        launches = read_launches(f"compat {run}",
                                 (forward_launches(n_sub, 16), 1))
        add(launches)
    log(f"[compat] att_aspp facade on the {n}-frame case: predict + "
        f"postprocess + select {secs[0]:.3f} s cold, {secs[1]:.3f} s warm per "
        f"case (read .mha, ROI path on {n_sub} frames, probabilities and "
        f"masks to numpy); probs {probs.shape} {probs.dtype}, frame {frame} "
        f"on the subsampled axis (= case frame {idxs[frame]}), "
        f"{int(sel.sum())} mask pixels; launches per case {launches}")
    eng = AttAsppEngine(cfg, variables, device=dev)
    p_eng = eng.predict_roi(case)
    m_eng = eng.postprocess_roi(p_eng).cpu().numpy()
    p_eng = p_eng.cpu().numpy()
    del eng
    s_eng, f_eng = compat.select_fetal_abdomen_mask_and_frame(m_eng)
    diff = float(np.abs(probs - p_eng).max())
    log(f"[compat] AttAsppEngine.predict_roi directly: frame {f_eng}, "
        f"probabilities max |diff| {diff:.3g}, masks equal "
        f"{bool(np.array_equal(masks, m_eng))}")
    if not (frame == f_eng and frame >= 0 and diff <= 1e-6
            and np.array_equal(masks, m_eng) and np.array_equal(sel, s_eng)):
        raise AssertionError("compat: the facade differs from the engine")

    # card against the CPU's plain versions on 12 frames around the pick
    center = int(idxs[frame])
    picks = [int(i) for i in center + 10 * np.arange(-6, 6) if 0 <= i < n]
    small = root / "sub.mha"
    write_mha(small, MetaImage(case[picks], spacing=(0.28,) * 3))
    got = {}
    for device in (dev, "cpu"):
        f = compat.FetalAbdomenSegmentation(str(REPO / MAIN_WEIGHTS),
                                            cfg=cfg, device=device)
        t0 = time.perf_counter()
        m = f.postprocess(f.predict(str(small)))
        got[device] = (*compat.select_fetal_abdomen_mask_and_frame(m),
                       time.perf_counter() - t0)
    (s_g, f_g, _), (s_c, f_c, t_cpu) = got[dev], got["cpu"]
    d = dice(s_g, s_c)
    log(f"[compat] {len(picks)} frames {picks[0]}..{picks[-1]} as a case: card "
        f"frame {f_g}, CPU plain frame {f_c} ({t_cpu:.1f} s), selected-mask "
        f"Dice {d:.5f}")
    if f_g != f_c or d < 0.98:
        raise AssertionError("compat: card and CPU plain versions disagree")

    # the baseline facade: in-repo plan at full width, seeded init
    bcfg = baseline_config()
    bfac = compat.FetalAbdomenSegmentation(
        variables=PlainConvUNet.from_config(bcfg.plain_unet,
                                            seed=BASELINE_SEED),
        model_tag="baseline", cfg=bcfg, device=dev)
    p140 = root / "sweep_0.mha"
    write_mha(p140, MetaImage(sweeps[0], spacing=(0.28,) * 3),
              compressed=False)
    reset_launches()
    t0 = time.perf_counter()
    bprobs = bfac.predict([str(p140)])
    seg = bfac.postprocess(bprobs)
    bsel, bframe = compat.select_fetal_abdomen_mask_and_frame(seg)
    t_b = time.perf_counter() - t0
    add(read_launches("compat baseline", (0, 1)))
    log(f"[compat] baseline facade on {sweeps[0].shape[0]} frames: {t_b:.3f} s "
        f"(cold); softmax {bprobs.shape} {bprobs.dtype}, labels "
        f"{sorted(np.unique(seg).tolist())}, frame {bframe}, "
        f"{int(bsel.sum())} mask pixels")
    if not (bprobs.shape == (3,) + sweeps[0].shape and bframe >= 0
            and set(np.unique(bsel)) <= {0, 1}):
        raise AssertionError("compat: baseline facade outputs")
    del bfac, bprobs, seg
    torch.cuda.empty_cache()

    # validate: the six sweeps pass, a copy of one under a new index fails
    paths = []
    for k, sw in enumerate(sweeps):
        paths.append(root / f"val/case_{k}.mha")
        paths[-1].parent.mkdir(exist_ok=True)
        write_mha(paths[-1], MetaImage(sw, spacing=(0.28,) * 3),
                  compressed=False)
    t0 = time.perf_counter()
    fac.validate(paths)
    t_val = time.perf_counter() - t0
    dup = root / "val/copy_6.mha"
    dup.write_bytes(paths[0].read_bytes())
    try:
        fac.validate(paths + [dup])
    except compat.ValidationError as err:
        log(f"[compat] validate: six sweeps pass ({t_val:.2f} s); with a "
            f"duplicate: ValidationError({err})")
    else:
        raise AssertionError("compat: a duplicate image passed validate")

    # the probability dump lands under the working directory
    cwd = os.getcwd()
    os.chdir(root / "val")
    try:
        reset_launches()
        probs = fac.predict(str(paths[1]), save_probabilities=True)
        add(read_launches("compat save", (forward_launches(
            min(128, sweeps[1].shape[0]), 16), 1)))
        saved = np.load(root / "val/output/probabilities/case_1_prob.npy")
    finally:
        os.chdir(cwd)
    log(f"[compat] save_probabilities: output/probabilities/case_1_prob.npy "
        f"{saved.shape} written under the working directory, equal to the "
        f"returned map: {bool(np.array_equal(saved, probs))}")
    if not np.array_equal(saved, probs):
        raise AssertionError("compat: the saved probabilities differ")
    del fac
    torch.cuda.empty_cache()
    return totals


def run_entry(where: str, module: str, cwd: Path, env, expect):
    """``python -m <module>`` in a subprocess through ``ENTRY_LAUNCHER``:
    its launches held to ``expect`` = (K1, K2), its wall split by the
    launcher's time stamps; returns (launches, wall seconds, stderr)."""
    t0, spawned = time.perf_counter(), time.time()
    res = subprocess.run([sys.executable, "-c", ENTRY_LAUNCHER, module],
                         cwd=cwd, env=env, capture_output=True, text=True,
                         timeout=600)
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(f"{where}: rc {res.returncode}\n"
                             f"{res.stderr[-3000:]}")
    counts = json.loads(res.stdout.split("LAUNCHES ")[-1].splitlines()[0])
    marks = json.loads(res.stdout.split("MARKS ")[-1].splitlines()[0])
    # seconds from the spawn to each mark, and each stage's share
    at = {k: v - spawned for k, v in marks.items()}
    stages = {"interpreter start": at["start"],
              "torch import": at["torch_imported"] - at["start"],
              "CUDA context": at["device_ready"] - at["torch_imported"],
              "port import + weights + engine": (
                  at["engine_built"] - at["device_ready"]),
              "read, serve, write, dumps": at["end"] - at["engine_built"],
              "exit": wall - at["end"]}
    log(f"[{where.split()[0]}] {where.split(' ', 1)[1]}: wall split (s) "
        + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))
    got = hold_launches(where, {"fused_double_cbr": counts[0],
                                "clahe_interp": counts[1]}, expect)
    return got, wall, res.stderr


def entry_runs(case, sweeps):
    """(tag, volume, CASE_ID, launches (K1, K2), frames the pick may name)
    of the entry point's two runs: ``att_aspp`` on the 840-frame case (the
    ROI path on 128 subsampled frames; the debug frames' enhancement is a
    second CLAHE launch) and the baseline on the 140-frame sweep."""
    import numpy as np

    n = case.shape[0]
    return [("att_aspp", case, "case-840",
             (forward_launches(min(128, n), 16), 2),
             np.linspace(0, n - 1, min(128, n)).astype(int).tolist()),
            ("baseline", sweeps[0], "sweep-0", (0, 2),
             list(range(sweeps[0].shape[0])))]


# [swin]: 8 frames of 562 x 744 are 4 tiles of 448 x 576 each, one tile batch
# of 32 (128 tiles with the mirror views)
SWIN_FRAMES = 8
# the port's bf16 SwinUNETR against the plain f32 reference on those tiles:
# the relative RMS error of the logits.  On the H100 at the published widths
# it read 0.0427 on these tiles (argmax equal on 97.5 %) and 0.018 on
# uniform noise; the same model with its relative-position tables zeroed
# has to read above the limit
SWIN_RTOL = 0.08
SWIN_ARGMAX = 0.95
# the kernel that computes the window attention: the port's Triton
# ``window_attn_fwd`` (``ops/kernels/window_attn.py``), by its name prefix
SWIN_ATTN_KERNELS = ("window_attn",)
# the JAX side, which no port path may load
JAX_MODULES = ("jax", "jaxlib", "flax", "att_aspp_unet_tpu")


def phase_swin(dev, sweep, tmp):
    """Swin UNETR at its published widths (feature size 48) from the seeded
    initialisation: the bf16 forward over one tile batch against the plain
    f32 reference (``tests/torch_ref.py::SwinUNETR``, TF32 off; its FLOPs
    counted by ``FlopCounterMode`` on one tile), the window attention's
    kernels as the trace names them (``SWIN_ATTN_KERNELS``), the forward's
    time and its device time by span, then ``MODEL_TAG=swin_unetr`` through
    the container on the 140-frame sweep, in this process (no JAX module
    loaded) and as ``python -m att_aspp_unet_tpu_torch.inference`` with a
    state dict.  K2 launches once per enhancement here (3), K1 never."""
    import copy
    import dataclasses

    import torch

    from att_aspp_unet_tpu_torch.config import (Config, ContainerConfig,
                                                SwinUNETRConfig)
    from att_aspp_unet_tpu_torch.infer import container
    from att_aspp_unet_tpu_torch.infer.engine import BaselineEngine
    from att_aspp_unet_tpu_torch.io import MetaImage, read_json, write_mha
    from att_aspp_unet_tpu_torch.models.sliding_window import \
        compute_tile_starts
    from att_aspp_unet_tpu_torch.models.swin_unetr import SwinUNETR
    from att_aspp_unet_tpu_torch.preprocess.enhance import preprocess_sweep
    from att_aspp_unet_tpu_torch.utils.profiling import name_of
    from torch.utils.flop_counter import FlopCounterMode

    sys.path.insert(0, str(REPO / "tests"))
    from torch_ref import SwinUNETR as Reference

    sc = SwinUNETRConfig()
    cfg = Config(swin_unetr=sc)
    needles = SWIN_ATTN_KERNELS
    model = SwinUNETR.from_config(sc, device=dev, seed=0)
    model = model.to(memory_format=torch.channels_last)
    p = cfg.preprocess
    reset_launches()
    with torch.no_grad():
        x = preprocess_sweep(torch.as_tensor(sweep[:SWIN_FRAMES]).to(dev),
                             None, p.clahe_clip, p.clahe_grid,
                             p.median_kernel)
    th, tw = cfg.plain_unet.patch_size
    step = cfg.plain_unet.tile_step
    tiles = torch.stack([x[f, y0:y0 + th, x0:x0 + tw]
                         for f in range(SWIN_FRAMES)
                         for y0 in compute_tile_starts(x.shape[1], th, step)
                         for x0 in compute_tile_starts(x.shape[2], tw, step)])
    tiles = tiles[:, None].float()
    batch = torch.cat([tiles] + [torch.flip(tiles, v) for v in
                                 ((-1,), (-2,), (-2, -1))])
    from att_aspp_unet_tpu_torch.ops.kernels import swin_ops, window_attn

    kernels = (swin_ops.layer_norm, swin_ops.instance_norm_act,
               swin_ops.stem_convs, window_attn.window_attn)
    before = [k.launches for k in kernels]
    torch.cuda.reset_peak_memory_stats()
    got = model(batch)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launched = {k.__name__: k.launches - b for k, b in zip(kernels, before)}
    log(f"[swin] the port's kernels launched by one forward: {launched}")
    if not all(launched.values()):
        raise AssertionError("[swin] the forward did not go through every "
                             f"one of the port's Swin kernels: {launched}")
    ms = cuda_ms(lambda: model(batch), reps=3)
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = Reference(sc.in_channels, sc.num_classes, sc.feature_size,
                    sc.depths, sc.num_heads, sc.window_size).to(dev).eval()
    ref.load_state_dict({k: v.float() if v.is_floating_point() else v
                         for k, v in model.state_dict().items()})
    with torch.no_grad():
        want = torch.cat([ref(batch[i:i + 16])
                          for i in range(0, batch.shape[0], 16)])
        with FlopCounterMode(display=False) as flops:
            ref(batch[:1])
    gflop = flops.get_total_flops() * batch.shape[0] / 1e9
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 \
        = tf32
    del ref
    err = float((got - want).norm() / want.norm())
    agree = float((got.argmax(1) == want.argmax(1)).float().mean())
    broken = copy.deepcopy(model)
    with torch.no_grad():
        for name, t in broken.named_parameters():
            if name.endswith("relative_position_bias_table"):
                t.zero_()
    err_broken = float((broken(batch) - want).norm() / want.norm())
    del broken
    log(f"[swin] SwinUNETR feature size {sc.feature_size}, heads "
        f"{sc.num_heads}, window {sc.window_size}, seed 0: "
        f"{sum(t.numel() for t in model.parameters()) / 1e6:.2f} M "
        f"parameters; bf16 on {batch.shape[0]} tiles of {th}x{tw} "
        f"({SWIN_FRAMES} frames x {batch.shape[0] // SWIN_FRAMES // 4} tiles "
        f"x 4 views) against the f32 reference: logits relative RMS "
        f"{err:.5f} (limit {SWIN_RTOL}; {err_broken:.5f} with the "
        f"relative-position tables zeroed), argmax equal on {agree:.5f} "
        f"(limit {SWIN_ARGMAX}); "
        f"forward {ms:.2f} ms = {gflop / ms:.1f} TFLOP/s ({gflop:.1f} "
        f"GFLOP), peak {peak:.2f} GiB")
    if not (err < SWIN_RTOL < err_broken and agree > SWIN_ARGMAX):
        raise AssertionError("[swin] the bf16 SwinUNETR is not within its "
                             "tolerance of the f32 reference")

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        model(batch)
        torch.cuda.synchronize()
    kernels, spans = {}, {}
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total", 0)
        if t and getattr(ev.device_type, "name", "") == "CUDA":
            kernels[ev.key] = t / 1e3
    for ev in prof.events():
        name = name_of(ev.name)
        if name:
            spans[name] = spans.get(name, 0.0) + \
                getattr(ev, "device_time_total", 0) / 1e3
    attn = {k: v for k, v in kernels.items()
            if any(n in k for n in needles)}
    total = sum(kernels.values())
    enc = spans.get("swin_encoder", 0.0)
    wa = spans.get("window_attention", 0.0)
    dec = spans.get("swin_decoder", 0.0)
    log(f"[swin] device time of one {batch.shape[0]}-tile forward "
        f"{total:.2f} ms: encoder {enc:.2f} ms (window attention {wa:.2f}, "
        f"its kernels {sum(attn.values()):.2f}), decoder {dec:.2f} ms; the "
        f"window attention's kernels (needles {list(needles)}): "
        + "; ".join(f"{k[:120]} {v:.3f} ms" for k, v in attn.items()))
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    log("[swin] top kernels: " + "; ".join(f"{k[:90]} {v:.2f} ms"
                                           for k, v in top))
    if not attn:
        raise AssertionError("[swin] no kernel of the window attention "
                             f"matched {SWIN_ATTN_KERNELS}")

    n = sweep.shape[0]
    src = tmp / "sin/images/stacked-fetal-ultrasound"
    src.mkdir(parents=True)
    write_mha(src / "sweep_140.mha", MetaImage(sweep, spacing=(0.28,) * 3),
              compressed=False)
    os.environ["MODEL_TAG"] = "swin_unetr"
    os.environ["CASE_ID"] = "swin-140"
    ccfg = dataclasses.replace(cfg, container=ContainerConfig(
        input_path=str(tmp / "sin"), output_path=str(tmp / "sout")))
    t0 = time.perf_counter()
    rc = container.run_from_env(ccfg, model, device=dev,
                                save_probabilities=False, debug_frames=False,
                                log=lambda *a: None)
    wall = time.perf_counter() - t0
    frame = read_json(tmp / "sout/fetal-abdomen-frame-number.json")
    loaded = sorted({m.split(".")[0] for m in sys.modules}
                    & set(JAX_MODULES))
    engine = BaselineEngine(cfg, model, device=dev)
    labels = engine.postprocess(engine.predict(sweep))
    _, want_frame = container.select_labeled_mask_and_frame(labels)
    shares = [float((labels == c).float().mean()) for c in (1, 2)]
    torch.save(model.state_dict(), tmp / "swin.pt")
    # the entry's process needs the card's memory that this one holds
    del engine, model, labels, got, want, batch, tiles, x
    torch.cuda.empty_cache()
    env = dict(os.environ, MODEL_TAG="swin_unetr", CASE_ID="swin-entry",
               WEIGHTS=str(tmp / "swin.pt"), DEVICE=dev)
    (tmp / "sentry/test").mkdir(parents=True)
    (tmp / "sentry/test/input").symlink_to(tmp / "sin")
    t1 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m",
                          "att_aspp_unet_tpu_torch.inference"],
                         cwd=tmp / "sentry", env=dict(
                             env, PYTHONPATH=str(REPO)),
                         capture_output=True, text=True, timeout=900)
    entry_wall = time.perf_counter() - t1
    entry_frame = read_json(tmp / "sentry/test/output/"
                            "fetal-abdomen-frame-number.json") \
        if res.returncode == 0 else None
    log(f"[swin] MODEL_TAG=swin_unetr container on {n} frames: rc {rc}, "
        f"{wall:.2f} s, frame {frame} (engine {want_frame}), class shares "
        f"{shares[0]:.4f} / {shares[1]:.4f}, forbidden modules loaded "
        f"{loaded}; python -m att_aspp_unet_tpu_torch.inference with "
        f"WEIGHTS: rc {res.returncode}, {entry_wall:.2f} s, frame "
        f"{entry_frame}")
    os.environ.pop("MODEL_TAG")
    os.environ.pop("CASE_ID")
    if not (rc == 0 and frame == want_frame == entry_frame and not loaded
            and res.returncode == 0):
        raise AssertionError("[swin] the container's MODEL_TAG=swin_unetr "
                             "path failed: " + res.stderr[-2000:])
    return read_launches("swin", (0, 3))


def phase_entry(dev, case, sweeps, tmp):
    """``python -m att_aspp_unet_tpu_torch.inference`` in a subprocess
    (through a launcher that runs the module as ``-m`` does and prints the
    launch counters at exit): ``MODEL_TAG=att_aspp`` with ``WEIGHTS`` on the
    840-frame case, then ``MODEL_TAG`` unset with ``PLANS`` on 140 frames;
    the container contract on both.  The outputs stay in
    ``tmp/entry_<tag>/test/output`` for ``[image]``."""
    totals = new_totals()
    extras = {"att_aspp": {"MODEL_TAG": "att_aspp",
                           "WEIGHTS": str(REPO / MAIN_WEIGHTS)},
              "baseline": {"PLANS": str(REPO / PLAN_DIR / "plans.json"),
                           "DATASET_JSON": str(REPO / PLAN_DIR /
                                               "dataset.json")}}
    # the entry point writes the debug frames and dumps the probabilities,
    # as the container does
    for tag, vol, case_id, expect, frames in entry_runs(case, sweeps):
        cwd = tmp / f"entry_{tag}"
        write_case_tree(cwd / "test/input", "case", vol)
        env = {k: v for k, v in os.environ.items() if k not in ENTRY_ENV}
        env.update(extras[tag], CASE_ID=case_id, DEVICE=dev,
                   PYTHONPATH=str(REPO))
        got, wall, _ = run_entry(f"entry {tag}", ENTRY_MODULE, cwd, env,
                                 expect)
        for k, v in got.items():
            totals[k] += v
        frame, px = check_container_contract(
            cwd / "test/output", case_id, vol.shape, frames, f"entry {tag}")
        dumps = sorted(p.name for p in (cwd / "output/probabilities").iterdir())
        log(f"[entry] MODEL_TAG={'att_aspp' if tag == 'att_aspp' else '(unset)'}"
            f": {wall:.2f} s wall for {vol.shape[0]} frames (process start, "
            f"model build, read, serve, write, probability dump {dumps}, "
            f"debug frames); frame {frame}, {px} mask pixels; launches {got}")
    return totals


DOCKERFILE = "Dockerfile.torch"
# what of the repository stays out of the port's image: the JAX package,
# its native library, its entry point, bench and the tests
NOT_IN_IMAGE = ("att_aspp_unet_tpu", "native", "inference.py", "bench.py",
                "tests")


def parse_dockerfile(path: Path):
    """The stages of a Dockerfile, each a dict: ``name`` (``AS``), ``base``,
    ``copy`` (list of (``--from`` stage or None, sources, destination)),
    ``run`` (shell commands), ``env`` (list of (key, value) in order),
    ``workdir`` and ``entrypoint`` (the exec form's list)."""
    import re
    import shlex

    stages = []
    for line in re.sub(r"\\\n", " ", path.read_text()).splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        op, _, rest = line.partition(" ")
        op, rest = op.upper(), rest.strip()
        if op == "FROM":
            words = rest.split()
            stages.append({"name": words[2] if len(words) == 3 else None,
                           "base": words[0], "copy": [], "run": [],
                           "env": [], "workdir": "/", "entrypoint": None})
        elif op == "COPY":
            words = shlex.split(rest)
            flags = dict(w[2:].partition("=")[::2] for w in words
                         if w.startswith("--"))
            paths = [w for w in words if not w.startswith("--")]
            stages[-1]["copy"].append((flags.get("from"), paths[:-1],
                                       paths[-1]))
        elif op == "RUN":
            stages[-1]["run"].append(rest)
        elif op == "ENV":
            stages[-1]["env"] += [w.partition("=")[::2]
                                  for w in shlex.split(rest)]
        elif op == "WORKDIR":
            stages[-1]["workdir"] = rest
        elif op == "ENTRYPOINT":
            stages[-1]["entrypoint"] = json.loads(rest)
    return stages


def dockerignore_patterns(path: Path):
    """The patterns of a ``.dockerignore`` file; its ``!`` exceptions are
    refused (the port's has none, and :func:`dockerignored` reads none)."""
    pats = [line.strip() for line in path.read_text().splitlines()
            if line.strip() and not line.strip().startswith("#")]
    if any(p.startswith("!") for p in pats):
        raise ValueError(f"{path}: '!' exceptions are not supported")
    return pats


def dockerignored(rel: str, patterns) -> bool:
    """Whether the build-context path ``rel`` (relative, ``/``-separated)
    is left out by one of ``patterns`` or lies in a directory that is, as
    Docker matches them: ``**`` spans any number of directories, ``*`` and
    ``?`` never a ``/``, and a trailing ``/`` is dropped."""
    import re

    def regex(pat):
        out, i, pat = "", 0, pat.strip("/")
        while i < len(pat):
            if pat.startswith("**/", i):
                out, i = out + "(?:.*/)?", i + 3
            elif pat.startswith("**", i):
                out, i = out + ".*", i + 2
            else:
                out += {"*": "[^/]*", "?": "[^/]"}.get(pat[i],
                                                       re.escape(pat[i]))
                i += 1
        return re.compile(out)

    parts = rel.strip("/").split("/")
    prefixes = ["/".join(parts[:k]) for k in range(1, len(parts) + 1)]
    return any(regex(p).fullmatch(q) for p in patterns for q in prefixes)


def stage_context(stage, root: Path, patterns):
    """Copy the build-context sources of ``stage``'s COPY instructions
    under ``root`` (the stage's filesystem), leaving out what ``patterns``
    leave out."""
    import shutil

    for frm, srcs, dst in stage["copy"]:
        if frm is not None:
            raise ValueError(f"{DOCKERFILE}: the builder copies from {frm}")
        for src in srcs:
            def ignore(d, names, src=src):
                rel = Path(d).relative_to(REPO).as_posix()
                return [n for n in names if dockerignored(f"{rel}/{n}",
                                                          patterns)]

            if dockerignored(src, patterns):
                continue
            target = root / dst.lstrip("/")
            if (REPO / src).is_dir():
                shutil.copytree(REPO / src, target, ignore=ignore)
            else:
                target.parent.mkdir(parents=True, exist_ok=True)
                shutil.copy2(REPO / src, target)


def tree_paths(roots):
    """``roots`` and every file and directory under them."""
    return [q for p in roots for q in [p, *p.rglob("*")]]


def tree_state(roots):
    """Every path under ``roots`` with its size and mtime."""
    return {str(q): (q.stat().st_size, q.stat().st_mtime_ns)
            for q in tree_paths(roots)}


def phase_image(dev, case, sweeps, tmp):
    """The port's container image (``Dockerfile.torch``) built and run the
    way docker would, without docker: (a) the builder stage's COPY sources
    staged under a temporary root, less what ``Dockerfile.torch.dockerignore``
    leaves out (no ``build/``, nothing of the JAX package); (b) its build
    step run there with no card visible: it builds the kernel
    libraries and the host-ops library; (c) the runtime stage's copies from
    the builder, made read-only, with the image's ``test/`` symlinks to
    ``/input`` and ``/output``; (d) its ENTRYPOINT twice, with the runtime
    stage's ENV, ``PYTHONPATH`` the image's working directory and no
    compiler to be found: ``MODEL_TAG=att_aspp`` with the staged weights on
    the 840-frame case (K1 64, K2 2) and ``MODEL_TAG`` unset, the image's
    default baseline, on the 140-frame sweep (K2 2); (e) the container
    contract, each run's volume and frame bit-equal to ``[entry]``'s (same
    code, weights and card), and the staged package and resources
    unchanged: nothing was built or written there."""
    import re
    import shlex
    import shutil

    import numpy as np

    from att_aspp_unet_tpu_torch.io import read_json, read_mha
    from att_aspp_unet_tpu_torch.ops.kernels import _build
    from att_aspp_unet_tpu_torch.utils import native

    stages = parse_dockerfile(REPO / DOCKERFILE)
    builder = next(st for st in stages if st["name"] == "builder")
    runtime = stages[-1]
    patterns = dockerignore_patterns(REPO / f"{DOCKERFILE}.dockerignore")
    broot, iroot = tmp / "image_builder", tmp / "image"

    def expand(env, pairs):
        for k, v in pairs:
            env[k] = re.sub(r"\$\{(\w+)\}", lambda m: env.get(m[1], ""), v)
        return env

    # (a) the build context
    stage_context(builder, broot, patterns)
    app = broot / builder["workdir"].lstrip("/")
    staged = [q.relative_to(app).as_posix() for q in app.rglob("*")]
    tops = sorted(q.name for q in app.iterdir())
    bad = [q for q in staged if {"build", "__pycache__"} & set(q.split("/"))
           or q.endswith(".pyc")] + sorted(set(tops) & set(NOT_IN_IMAGE))
    jax = [q for q in app.rglob("*.py") if re.search(
        r"^\s*(import|from)\s+(jax|flax|optax|att_aspp_unet_tpu)\b",
        q.read_text(), re.M)]
    log(f"[image] {DOCKERFILE}: builder {builder['base']}, runtime "
        f"{runtime['base']}; staged {len(staged)} paths under "
        f"{builder['workdir']}: {tops}")
    if bad or jax or not staged:
        raise AssertionError(f"image: the staged context holds {bad[:5]} "
                             f"{jax[:5]}")

    # (b) the build step, with no card visible
    step = next(r for r in builder["run"] if "ops.kernels._build" in r)
    argv = shlex.split(step)
    if argv[0] != "python":
        raise AssertionError(f"image: unexpected build step {step!r}")
    env = expand(dict(os.environ), builder["env"])
    env.update(CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(app))
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, *argv[1:]], cwd=app, env=env,
                         capture_output=True, text=True, timeout=600)
    t_build = time.perf_counter() - t0
    libs = sorted(q.name for q in (app / "att_aspp_unet_tpu_torch/build")
                  .glob("*.so")) if res.returncode == 0 else []
    want = sorted([_build.library_path(n).name
                   for n in _build.KERNEL_SOURCES]
                  + [native.library_path().name])
    log(f"[image] build step `{step}` with CUDA_VISIBLE_DEVICES=\"\": rc "
        f"{res.returncode}, {t_build:.2f} s wall ({nvidia_smi()}); "
        f"{res.stdout.strip().splitlines()}")
    if libs != want:
        raise AssertionError(f"image: the build step made {libs}, not "
                             f"{want}\n{res.stderr[-3000:]}")
    # the runtime stage is CUDA's base image: no CUDA library but the
    # driver's, which the container toolkit mounts (torch's wheel has its own)
    needs = {lib: re.findall(r"^\s*(lib\S+)", subprocess.run(
        ["ldd", str(app / "att_aspp_unet_tpu_torch/build" / lib)],
        capture_output=True, text=True).stdout, re.M) for lib in libs}
    log(f"[image] shared libraries the built ones need: {needs}")
    if any(n.startswith(("libcudart", "libnvrtc", "libcublas"))
           for v in needs.values() for n in v):
        raise AssertionError("image: a built library needs a CUDA library "
                             "that the runtime image lacks")

    # (c) the runtime stage: copies from the builder, read-only
    locked = []
    for frm, srcs, dst in runtime["copy"]:
        if frm != builder["name"]:
            raise AssertionError(f"image: the runtime copies {srcs} from "
                                 f"{frm or 'the context'}")
        for src in srcs:
            if not (broot / src.lstrip("/")).exists():
                # the builder's venv: the card machine's Python stands in
                if not any(f"venv {src}" in r for r in builder["run"]):
                    raise AssertionError(f"image: COPY --from={frm} {src}")
                continue
            locked.append(iroot / dst.lstrip("/"))
            shutil.copytree(broot / src.lstrip("/"), locked[-1],
                            symlinks=True)
    workdir = iroot / runtime["workdir"].lstrip("/")
    links = [m for r in runtime["run"]
             for m in re.findall(r"ln -s (\S+) (\S+)", r)]
    for target, link in links:
        (iroot / target.lstrip("/")).mkdir(parents=True, exist_ok=True)
        (iroot / link.lstrip("/")).parent.mkdir(parents=True, exist_ok=True)
        (iroot / link.lstrip("/")).symlink_to(iroot / target.lstrip("/"))
    entry = runtime["entrypoint"]
    if entry[:2] != ["python", "-m"] or len(entry) != 3 or len(links) != 2:
        raise AssertionError(f"image: ENTRYPOINT {entry}, links {links}")

    # (d) the ENTRYPOINT, twice; no compiler is to be found, as in the image
    env = {k: v for k, v in os.environ.items() if k not in ENTRY_ENV}
    env["PATH"] = os.pathsep.join(
        d for d in env.get("PATH", "").split(os.pathsep)
        if not (Path(d) / "nvcc").exists())
    env = expand(env, runtime["env"])
    env.update(PYTHONPATH=str(workdir), CUDA_HOME=str(iroot / "no-cuda"),
               CXX=str(iroot / "no-cxx"))
    if dev != "cuda":
        env["DEVICE"] = dev     # a rehearsal on the CPU; the image's: cuda
    extras = {"att_aspp": {"MODEL_TAG": "att_aspp",
                           "WEIGHTS": str(workdir / MAIN_WEIGHTS)},
              "baseline": {}}
    totals = new_totals()
    try:
        for q in tree_paths(locked):
            q.chmod(q.stat().st_mode & ~0o222)
        before = tree_state(locked)
        for tag, vol, case_id, expect, frames in entry_runs(case, sweeps):
            for target, _ in links:         # /input and /output emptied
                for q in (iroot / target.lstrip("/")).iterdir():
                    if q.is_dir():
                        shutil.rmtree(q)
                    else:
                        q.unlink()
            write_case_tree(workdir / "test/input", "case", vol)
            run_env = dict(env, **extras[tag], CASE_ID=case_id)
            got, wall, err = run_entry(f"image {tag}", entry[2], workdir,
                                       run_env, expect)
            for k, v in got.items():
                totals[k] += v
            out = workdir / "test/output"
            frame, px = check_container_contract(out, case_id, vol.shape,
                                                 frames, f"image {tag}")
            ref = tmp / f"entry_{tag}/test/output"
            seg = f"images/fetal-abdomen-segmentation/{case_id}.mha"
            same = (read_json(out / "fetal-abdomen-frame-number.json")
                    == read_json(ref / "fetal-abdomen-frame-number.json")
                    and np.array_equal(read_mha(out / seg).array,
                                       read_mha(ref / seg).array))
            log(f"[image] MODEL_TAG="
                f"{'att_aspp' if tag == 'att_aspp' else '(unset)'} from the "
                f"read-only staged image: {wall:.2f} s wall for "
                f"{vol.shape[0]} frames; frame {frame}, {px} mask pixels; "
                f"launches {got}; volume and frame equal to [entry]'s: "
                f"{same}")
            if not same or "native host ops unavailable" in err:
                raise AssertionError(f"image {tag}: differs from [entry] or "
                                     f"ran without the host ops\n{err[-2000:]}")
        after = tree_state(locked)
    finally:
        for q in tree_paths(locked):
            q.chmod(q.stat().st_mode | 0o200)
    changed = sorted(set(before.items()) ^ set(after.items()))
    log(f"[image] staged package and resources: {len(before)} paths, "
        f"{'unchanged' if not changed else f'CHANGED {changed[:5]}'}")
    if changed:
        raise AssertionError("image: the runs wrote into the image's tree")
    return totals


def phase_tools(dev, sweeps, truths, train_sets, thr, tmp):
    """The offline loop on data made here: PNG pairs (the generator's) →
    ``split`` → ``leak-check`` (exit 0, then 1 with a file in both sets);
    ``predict`` on the val PNGs with the repo's v1 model and a seeded
    ``--no_att`` model, then ``eval-seg``, ``vis-errors`` and
    ``dataset-report``; ``eval-ac`` of a GT table from the generator's true
    circumferences against direct and cascade ``predict`` on the six sweeps;
    ``convert`` on the sweeps with the port's predicted mask volumes."""
    import shutil
    import uuid

    import numpy as np

    from att_aspp_unet_tpu_torch import cli
    from att_aspp_unet_tpu_torch.config import ModelConfig
    from att_aspp_unet_tpu_torch.io import (MetaImage, read_gray_png,
                                            read_mha, write_gray_png,
                                            write_mha)

    totals = new_totals()
    root = tmp / "tools"
    secs = {}

    def offline(argv, expect_rc=0):
        """An offline subcommand: its seconds, the kernels untouched, the
        figures it skipped for want of matplotlib."""
        err = io.StringIO()
        reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(err), \
                contextlib.redirect_stdout(io.StringIO()):
            rc = cli.main(argv)
        secs[argv[0]] = secs.get(argv[0], 0.0) + time.perf_counter() - t0
        skipped = [w.split("skipped ")[-1] for w in err.getvalue().splitlines()
                   if w.startswith("[warn] matplotlib unavailable")]
        from att_aspp_unet_tpu_torch.ops.kernels import clahe_interp as ci
        from att_aspp_unet_tpu_torch.ops.kernels import fused_conv as fc
        if rc != expect_rc or fc.fused_double_cbr.launches or \
                ci.clahe_interp.launches:
            raise AssertionError(f"tools {argv[0]}: rc {rc} (want "
                                 f"{expect_rc}) or a kernel launched")
        if skipped:
            log(f"[tools] {argv[0]}: skipped {len(skipped)} figure(s) for "
                f"want of matplotlib: {[Path(f).name for f in skipped]}")
        return rc

    def predict(argv, where, expect):
        wall, launches, _ = run_cli(argv, where, expect)
        for k, v in launches.items():
            totals[k] += v
        secs[where] = wall
        return launches

    # PNG pairs named by seeded UUIDs (the eval tools key cases so)
    rng = np.random.default_rng(40)
    imgs = np.concatenate([train_sets[1][0], train_sets[0][0]])[:N_TOOLS_PNG]
    msks = np.concatenate([train_sets[1][1], train_sets[0][1]])[:N_TOOLS_PNG]
    for im, m in zip(imgs, msks):
        name = str(uuid.UUID(int=int(rng.integers(1 << 62)) << 64
                             | int(rng.integers(1 << 62)))) + ".png"
        write_gray_png(root / "raw/images" / name, im)
        write_gray_png(root / "raw/masks" / name, m)
    offline(["split", "--raw_root", str(root / "raw"), "--out_root",
             str(root / "ds"), "--train_frac", "0.5"])
    ds = root / "ds"
    offline(["leak-check", "--train", str(ds / "train/images"), "--val",
             str(ds / "val/images"), "--out", str(root / "leak")])
    leaked = sorted((ds / "train/images").iterdir())[0]
    shutil.copy(leaked, root / "leaked.png")
    shutil.copy(leaked, ds / "val/images" / leaked.name)
    offline(["leak-check", "--train", str(ds / "train/images"), "--val",
             str(ds / "val/images"), "--out", str(root / "leak")],
            expect_rc=1)
    (ds / "val/images" / leaked.name).unlink()
    n_val = len(list((ds / "val/images").iterdir()))

    # predict the val PNGs with the v1 model and a seeded --no_att model
    na_cfg = ModelConfig(base_c=BASE_C, use_att=False, att_depth=0)
    save_flat_npz(root / "noatt.npz", seeded_variables(na_cfg))
    common = ["--base_c", str(BASE_C), "--input_dir", str(ds / "val/images"),
              "--thr", str(thr), "--device", dev]
    for label, weights, extra in (("v1", REPO / MAIN_WEIGHTS, []),
                                  ("noatt", root / "noatt.npz",
                                   ["--no_att", "--att_depth", "0"])):
        predict(["predict", "--weights", str(weights), "--out_dir",
                 str(root / f"pred_{label}"), *common, *extra],
                f"predict PNG {label}", (n_val * forward_launches(1, 16),
                                         n_val))
    offline(["eval-seg", "--gt", str(ds / "val/masks"), "--base",
             str(root / "pred_noatt"), "--new", str(root / "pred_v1"),
             "--out_csv", str(root / "seg_eval.csv"), "--plot",
             "--plot_dir", str(root / "plots")])
    rows = (root / "seg_eval.csv").read_text().splitlines()
    offline(["vis-errors", "--csv", str(root / "seg_eval.csv"), "--gt",
             str(ds / "val/masks"), "--base", str(root / "pred_noatt"),
             "--new", str(root / "pred_v1"), "--images",
             str(ds / "val/images"), "--out", str(root / "vis"), "--top",
             "3"])
    overlays = sorted(p.name for p in (root / "vis").glob("*_overlay.png"))
    # dataset-report over the split (flat layout) and a pos / neg tree
    offline(["dataset-report", "--flat_root", str(ds), "--outdir",
             str(root / "rep_flat")])
    for sp in ("train", "val"):
        for p in sorted((ds / sp / "images").iterdir()):
            cls = "pos" if read_gray_png(ds / sp / "masks" / p.name).any() \
                else "neg"
            dst = root / "posneg" / sp / cls
            dst.mkdir(parents=True, exist_ok=True)
            shutil.copy(p, dst / p.name)
    offline(["dataset-report", "--root", str(root / "posneg"), "--outdir",
             str(root / "rep_root")])
    split_stats = (root / "rep_flat/split_stats.csv").read_text().splitlines()
    log(f"[tools] split -> leak-check (exit 0, then 1 with {leaked.name} in "
        f"both) -> predict v1 and --no_att on {n_val} val PNGs -> eval-seg "
        f"({len(rows) - 1} cases; {rows[1][:60]}...) -> vis-errors "
        f"{overlays} -> dataset-report: {split_stats}")

    # eval-ac: the generator's true AC per sweep against direct and cascade
    six = root / "six"
    six.mkdir()
    for k, sw in enumerate(sweeps):
        write_mha(six / f"sweep_{k}.mha",
                  MetaImage(sw, spacing=(0.28, 0.28, 1.0)), compressed=False)
    gt = root / "gt_ac.csv"
    gt.write_text("case_id,sweep_1_ac_mm\n" + "".join(
        f"sweep_{k},{t.circumference_px() * 0.28!r}\n"
        for k, t in enumerate(truths)))
    n6 = sum(sw.shape[0] for sw in sweeps)
    predict(["predict", "--weights", str(REPO / MAIN_WEIGHTS), "--base_c",
             str(BASE_C), "--input_dir", str(six), "--out_dir",
             str(root / "six_direct"), "--thr", str(thr), "--device", dev],
            "predict six direct", (len(sweeps) * forward_launches(
                N_FRAMES, 16), len(sweeps)))
    predict(["predict", "--weights", str(REPO / MAIN_WEIGHTS), "--base_c",
             str(BASE_C), "--input_dir", str(six), "--out_dir",
             str(root / "six_cascade"), "--thr", str(thr), "--device", dev,
             "--cascade", "--scout_weights", str(REPO / SCOUT_WEIGHTS)],
            "predict six cascade", None)
    offline(["eval-ac", "--gt", str(gt), "--baseline",
             str(root / "six_direct/ac_results.csv"), "--new",
             str(root / "six_cascade/ac_results.csv"), "--out",
             str(root / "ac"), "--fps", str(N_FRAMES)])
    metrics = (root / "ac/metrics.csv").read_text().splitlines()
    stats = (root / "ac/stats.txt").read_text().split("\n")[0] \
        if (root / "ac/stats.txt").exists() else "no paired statistics"
    log(f"[tools] eval-ac of direct (baseline) and cascade (new) predict on "
        f"the six sweeps ({n6} frames) against the generator's AC: "
        f"{metrics}; {stats}")
    if len(metrics) != 3:
        raise AssertionError("tools: eval-ac metrics.csv")

    # convert: the sweeps with the predicted mask volumes as their masks
    conv = root / "conv"
    (conv / "images").mkdir(parents=True)
    (conv / "masks").mkdir()
    for k, sw in enumerate(sweeps[:3]):
        pred = read_mha(root / f"six_direct/sweep_{k}/images/"
                        "fetal-abdomen-segmentation/output.mha")
        write_mha(conv / f"images/sweep_{k}.mha",
                  MetaImage(sw, spacing=(0.28, 0.28, 1.0)), compressed=False)
        write_mha(conv / f"masks/sweep_{k}.mha", pred, compressed=False)
    offline(["convert", "--mha_root", str(conv), "--out_root",
             str(root / "conv_png"), "--neg_ratio", "2.0", "--seed", "5"])
    index = json.loads((root / "conv_png/masks/frame_indices.json")
                       .read_text())
    log(f"[tools] convert on 3 sweeps with the predicted masks: "
        f"{ {c: (v['pos'], v['neg']) for c, v in index.items()} } "
        f"(pos, neg frames per case)")
    if not all(v["pos"] for v in index.values()):
        raise AssertionError("tools: convert found no positive frame")
    log("[tools] seconds per CLI call: " + ", ".join(
        f"{k} {v:.2f}" for k, v in secs.items()))
    return totals


def phase_native(dev, case, sweeps, variables, thr, tmp):
    """The native host ops: the library builds, and a cold build into an
    empty directory is timed; deflate, inflate and the ``.mha`` round trip
    of the 840-frame case native against Python zlib (the two deflates in
    parallel threads: each releases the interpreter lock); the contour tracer native against Python on the top-5 candidates
    of the six sweeps; one ``predict`` CLI call on 140 frames through the
    native inflate and tracer (call counts)."""
    import threading
    import zlib

    import numpy as np

    from att_aspp_unet_tpu_torch.infer.engine import AttAsppEngine
    from att_aspp_unet_tpu_torch.io import MetaImage, read_mha, write_mha
    from att_aspp_unet_tpu_torch.measure.contour import trace_contour_python
    from att_aspp_unet_tpu_torch.utils import native

    # built by g++ at the run's first .mha read or write
    ok = native.available()
    log(f"[native] host ops library {native.library_path().name}: available "
        f"{ok}")
    if not ok:
        raise AssertionError("native: the host ops library is unavailable")

    root = tmp / "native"
    root.mkdir()
    # the cost a process pays at its first .mha read or trace when the
    # checkout holds no library yet: the same build into an empty directory
    saved = native.BUILD_DIR
    native.BUILD_DIR = root / "cold_build"
    try:
        t = time.perf_counter()
        native.build()
        cold_s = time.perf_counter() - t
    finally:
        native.BUILD_DIR = saved
    log(f"[native] cold build (g++, empty build directory): {cold_s:.2f} s")
    data = case.tobytes()
    out, ms = {}, {}

    def timed(key, fn):
        t = time.perf_counter()
        out[key] = fn()
        ms[key] = (time.perf_counter() - t) * 1e3

    native.reset_native_calls()
    threads = [threading.Thread(target=timed, args=(
                   "write_mha", lambda: write_mha(
                       root / "case.mha", MetaImage(case, spacing=(0.28,) * 3)))),
               threading.Thread(target=timed, args=(
                   "zlib.compress", lambda: zlib.compress(data, 6)))]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    raw = (root / "case.mha").read_bytes()
    head, payload = raw.split(b"ElementDataFile = LOCAL\n", 1)
    blob = out["zlib.compress"]
    timed("native.inflate", lambda: native.inflate_into(blob, len(data)))
    timed("zlib.decompress", lambda: zlib.decompress(blob, bufsize=len(data)))
    timed("read_mha", lambda: read_mha(root / "case.mha").array)
    calls = native.read_native_calls()
    same = (payload == blob and f"CompressedDataSize = {len(blob)}".encode()
            in head and np.array_equal(out["native.inflate"],
                                       np.frombuffer(data, np.uint8))
            and out["zlib.decompress"] == data
            and np.array_equal(out["read_mha"], case))
    log(f"[native] {len(data) / 1e6:.1f} MB case: .mha write (native deflate, "
        f"level 6) {ms['write_mha']:.0f} ms vs zlib.compress "
        f"{ms['zlib.compress']:.0f} ms, in parallel threads; payload bytes "
        f"equal {payload == blob} ({len(blob) / 1e6:.1f} MB); inflate_into "
        f"native {ms['native.inflate']:.0f} ms vs zlib.decompress "
        f"{ms['zlib.decompress']:.0f} ms; read_mha (native inflate) "
        f"{ms['read_mha']:.0f} ms, volume equal; native calls {calls}")
    if not same or calls.get("deflate") != 1 or calls.get("inflate") != 2:
        raise AssertionError("native: codec bytes or calls")
    del data, raw, payload, blob, out

    # contours of the top-5 candidates of each sweep, native vs Python
    eng = AttAsppEngine(main_config(), variables, device=dev)
    t_nat, t_py, n_tr, n_pts = 0.0, 0.0, 0, 0
    for sw in sweeps:
        _, refined = eng._collect(eng.predict_case_submit(sw, thr))
        areas = (refined > 0).reshape(refined.shape[0], -1).sum(axis=1)
        for i in np.argsort(areas)[::-1][:5]:
            t = time.perf_counter()
            a = native.trace_contour(refined[i])
            t_nat += time.perf_counter() - t
            t = time.perf_counter()
            b = trace_contour_python(refined[i])
            t_py += time.perf_counter() - t
            if not np.array_equal(a, b):
                raise AssertionError("native: contours differ from Python's")
            n_tr += 1
            n_pts += len(a)
    del eng
    log(f"[native] trace_contour on the top-5 candidates of the six sweeps: "
        f"{n_tr} masks, {n_pts} contour points, all equal; native "
        f"{t_nat / n_tr * 1e6:.1f} us vs Python {t_py / n_tr * 1e6:.1f} us "
        f"per trace (x{t_py / t_nat:.0f})")

    # one predict CLI call on a compressed 140-frame sweep
    (root / "in").mkdir()
    write_mha(root / "in/sweep_0.mha",
              MetaImage(sweeps[0], spacing=(0.28, 0.28, 1.0)))
    native.reset_native_calls()
    wall = run_predict_cli(dev, root / "in", root / "out", thr)
    launches = read_launches("native predict", (forward_launches(
        sweeps[0].shape[0], 16), 1))
    calls = native.read_native_calls()
    log(f"[native] cli predict on the compressed 140-frame sweep: {wall:.2f} "
        f"s (read and inflate, predict, trace, write); native "
        f"calls {calls}; kernel launches {launches}")
    # the predict CLI writes its volume uncompressed, as the JAX package's
    # does: no deflate here (the .mha write above held it)
    if calls.get("trace_contour", 0) < 5 or calls.get("inflate", 0) < 1:
        raise AssertionError(f"native: predict took the Python path {calls}")
    return launches


def shard_sizes(n: int, devices, align: int):
    """Frames per shard that ``parallel.mesh.split_frames`` cuts."""
    from att_aspp_unet_tpu_torch.parallel.mesh import pad_to_multiple

    per = pad_to_multiple(n, len(devices) * align) // len(devices)
    return [min(per, n - k * per) for k in range(len(devices))
            if n - k * per > 0]


def sharded_cascade_and_bulk(dev, devs, sweep, case, variables, thr):
    """The cascade (the 140-frame sweep, the 840-frame case) and a bulk
    group of four sweeps over ``devs`` against the one-device engine: the
    scout tier and the tier-2 forward split at their micro-batches, so
    frame, mask and AC must be bit for bit equal."""
    import numpy as np
    import torch

    from att_aspp_unet_tpu_torch.infer.engine import AttAsppEngine

    totals = new_totals()

    def timed(fn):
        if dev != "cpu":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        if dev != "cpu":
            torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    ccfg = main_config(cascade=True,
                       cascade_scout_weights=str(REPO / SCOUT_WEIGHTS))
    c_one = AttAsppEngine(ccfg, variables, device=dev)
    c_two = AttAsppEngine(ccfg, variables, devices=devs)
    for e in (c_one, c_two):
        e.predict_case(sweep[:32], SPACING, thr)                 # warm-up
    for label, data in (("140", sweep), ("840", case)):
        want, t1 = timed(lambda: c_one.predict_case(data, SPACING, thr))
        reset_launches()
        got, t2 = timed(lambda: c_two.predict_case(data, SPACING, thr))
        for k, v in read_launches(f"sharded cascade {label}").items():
            totals[k] += v
        same = (got[0] == want[0] and got[2] == want[2]
                and np.array_equal(got[1], want[1]))
        log(f"[sharded] cascade {label} frames, {len(devs)} shards: frame "
            f"{got[0]} (one device {want[0]}), AC {got[2]:.4f} "
            f"({want[2]:.4f}), masks equal "
            f"{bool(np.array_equal(got[1], want[1]))}; {t2:.3f} s against "
            f"{t1:.3f} s on one device")
        if not same:
            raise AssertionError(f"sharded cascade {label}: differs from "
                                 "one device")
    n = sweep.shape[0]
    group = np.stack([sweep] + [case[k * n:(k + 1) * n] for k in (1, 2, 3)])
    want, t1 = timed(lambda: c_one.predict_bulk(group, SPACING, thr))
    reset_launches()
    got, t2 = timed(lambda: c_two.predict_bulk(group, SPACING, thr))
    for k, v in read_launches("sharded bulk").items():
        totals[k] += v
    same = all(g[0] == w[0] and g[2] == w[2] and np.array_equal(g[1], w[1])
               for g, w in zip(got, want))
    log(f"[sharded] bulk S={group.shape[0]}, {len(devs)} shards: frames "
        f"{[g[0] for g in got]} (one device {[w[0] for w in want]}), all "
        f"masks and ACs equal {same}; {t2:.3f} s against {t1:.3f} s on one "
        "device")
    if not same:
        raise AssertionError("sharded bulk: differs from one device")
    return totals


def phase_sharded(dev, sweep, case, variables, thr, direct_engine):
    """Frame-sharded serving: ``AttAsppEngine(devices=...)`` on the
    140-frame sweep and the 840-frame case, and ``BaselineEngine`` on the
    sweep, with every visible card as the data axis and with card 0 listed
    twice (so that the split and the gather run on a card even where there
    is one); against the one-device engines on the same card: probabilities
    within 1e-5, frame, mask and AC equal, K1 / K2 launches the per-shard
    sums; frames/s beside the one-device engine's.  The cascade (on the
    sweep and the case) and a bulk group of four sweeps with card 0 listed
    twice: frame, mask and AC bit for bit the one-device engine's."""
    import numpy as np
    import torch

    from att_aspp_unet_tpu_torch.infer.container import \
        select_labeled_mask_and_frame
    from att_aspp_unet_tpu_torch.infer.engine import (AttAsppEngine,
                                                      BaselineEngine)
    from att_aspp_unet_tpu_torch.models import PlainConvUNet
    from att_aspp_unet_tpu_torch.parallel.mesh import visible_devices

    cards = visible_devices()
    layouts = [(f"every card ({len(cards)})", cards),
               ("card 0 twice", [cards[0]] * 2)]
    totals = new_totals()

    def add(launches):
        for k, v in launches.items():
            totals[k] += v

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    cfg = main_config()
    one = direct_engine
    for data in (sweep, case):
        n = label = data.shape[0]
        p_one = one.predict_full(data)
        (f1, m1, ac1), t1 = timed(lambda: one.predict_case(data, SPACING, thr))
        t_one = [t1]
        for name, devs in layouts:
            eng = AttAsppEngine(cfg, variables, devices=devs)
            sizes = shard_sizes(n, devs, cfg.predict.frame_batch)
            expect = (sum(forward_launches(s, 16) for s in sizes), len(sizes))
            eng.predict_case(data[:16], SPACING, thr)              # warm-up
            reset_launches()
            p = eng.predict_full(data)
            add(read_launches(f"sharded predict_full {label}, {name}",
                              expect))
            err = float((p - p_one).abs().max())
            reset_launches()
            (f, m, ac), t = timed(lambda: eng.predict_case(data, SPACING,
                                                           thr))
            add(read_launches(f"sharded predict_case {label}, {name}",
                              expect))
            log(f"[sharded] att_aspp {label} frames, {name}: shards {sizes} "
                f"on {[str(d) for d in devs]}; probabilities max |diff| "
                f"{err:.3g} vs one device (tolerance 1e-5); predict_case "
                f"frame {f} (one device {f1}), AC {ac:.4f} mm ({ac1:.4f}), "
                f"masks equal {bool(np.array_equal(m, m1))}; {t:.3f} s = "
                f"{n / t:.1f} frames/s; K1 {expect[0]}, K2 {expect[1]}")
            if err > 1e-5 or f != f1 or ac != ac1 or \
                    not np.array_equal(m, m1):
                raise AssertionError(f"sharded {label}, {name}: the engine "
                                     "disagrees with the one-device engine")
            del eng, p
        # the one-device engine before and after the sharded ones
        t_one.append(timed(lambda: one.predict_case(data, SPACING, thr))[1])
        log(f"[sharded] att_aspp {label} frames, one device: "
            f"{t_one[0]:.3f} s before, {t_one[1]:.3f} s after = "
            f"{n / t_one[1]:.1f} frames/s")
        del p_one
        torch.cuda.empty_cache()

    add(sharded_cascade_and_bulk(dev, [cards[0]] * 2, sweep, case,
                                 variables, thr))

    bcfg = baseline_config()
    pu = bcfg.plain_unet
    base = BaselineEngine(bcfg, PlainConvUNet.from_config(
        pu, seed=BASELINE_SEED), device=dev)
    base.predict(sweep[:8])                                        # warm-up
    p_one, t1 = timed(lambda: base.predict(sweep))
    _, f1 = select_labeled_mask_and_frame(base.postprocess(p_one))
    t_base = [t1]
    for name, devs in layouts:
        eng = BaselineEngine(bcfg, base.model, devices=devs)
        sizes = shard_sizes(sweep.shape[0], devs,
                            eng._frames_per_batch(sweep.shape[-2:]))
        eng.predict(sweep[:8])
        reset_launches()
        p, t = timed(lambda: eng.predict(sweep))
        add(read_launches(f"sharded baseline, {name}", (0, len(sizes))))
        err = float((p - p_one).abs().max())
        seg = eng.postprocess(p)
        _, f = select_labeled_mask_and_frame(seg)
        log(f"[sharded] baseline {sweep.shape[0]} frames, {name}: shards "
            f"{sizes}; softmax max |diff| {err:.3g} vs one device "
            f"(tolerance 1e-5), frame {f} (one device {f1}); {t:.3f} s = "
            f"{sweep.shape[0] / t:.1f} frames/s; K2 {len(sizes)}")
        if err > 1e-5 or f != f1:
            raise AssertionError(f"sharded baseline, {name}: disagrees with "
                                 "the one-device engine")
        del eng, p, seg
    t_base.append(timed(lambda: base.predict(sweep))[1])
    log(f"[sharded] baseline {sweep.shape[0]} frames, one device: "
        f"{t_base[0]:.3f} s before, {t_base[1]:.3f} s after = "
        f"{sweep.shape[0] / t_base[1]:.1f} frames/s")
    del base, p_one
    torch.cuda.empty_cache()
    return totals


DDP_STEPS = 3


def ddp_steps(cfg, imgs, msks, aug, device, n_steps=DDP_STEPS):
    """``n_steps`` train steps on one fixed global batch from the seeded
    init, this process holding its rows of it (one process: all): the loss
    per step, the first step's gradients (f64 runs) and BatchNorm buffers,
    the state dict after the last step, the median ms per step after the
    first."""
    import torch

    from att_aspp_unet_tpu_torch.parallel.mesh import shard_rows
    from att_aspp_unet_tpu_torch.train.train_loop import (TrainState,
                                                          create_train_state,
                                                          make_optimizer,
                                                          train_step)

    f64 = cfg.model.compute_dtype == "float64"
    state = create_train_state(cfg.model, cfg.train, 1, device)
    if f64:
        state.model.double()
        state = TrainState(state.model, make_optimizer(cfg.train, 1,
                                                       state.model))
    grads = []
    update = state.opt.step

    def record(g):
        if f64 and not grads:
            grads.append({n: t.double().cpu().clone() for n, t in
                          zip(state.opt.names, g)})
        update(g)

    state.opt.step = record
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" \
        else (lambda: None)
    losses, times = [], []
    for _ in range(n_steps):
        sync()
        t0 = time.perf_counter()
        m = train_step(state, cfg, shard_rows(imgs), shard_rows(msks),
                       aug_params=aug)
        sync()
        times.append(time.perf_counter() - t0)
        losses.append(float(m[0]))
        if len(losses) == 1:
            bufs = {k: v.detach().cpu().clone() for k, v in
                    state.model.named_buffers()}
    return {"loss": losses, "grads": grads[0] if grads else None,
            "buffers1": bufs,
            "state": {k: v.detach().cpu() for k, v in
                      state.model.state_dict().items()},
            "ms": 1e3 * statistics.median(times[1:])}


def ddp_rank(rank, device, cases, out):
    """One rank of the [ddp] phase: every case, then the launch counts of
    every rank gathered on rank 0; its results to ``<out>/rank<r>.pt``."""
    import torch
    import torch.distributed as dist

    from att_aspp_unet_tpu_torch.ops.kernels import clahe_interp as ci
    from att_aspp_unet_tpu_torch.ops.kernels import fused_conv as fc

    reset_launches()
    res = {name: ddp_steps(*c, device) for name, c in cases.items()}
    counts = [None] * dist.get_world_size()
    dist.all_gather_object(counts, (fc.fused_double_cbr.launches,
                                    ci.clahe_interp.launches))
    res["launches"] = counts
    torch.save(res, Path(out) / f"rank{rank}.pt")


def phase_ddp(dev, train_set):
    """Data-parallel training at the CLI's defaults (base_c 48, 512², global
    batch 8, bf16, augmentation on, ASPP dropout 0.1) and, exactly, in f64
    at base_c 8, 128²: ``DDP_STEPS`` steps on one fixed global batch (one
    augmentation draw) in one process on the card, then (a) through the
    launcher on the data axis that ``cli train --device cuda`` takes (NCCL;
    one rank on a one-card machine) and (b) in two gloo ranks sharing card
    0 (NCCL refuses two ranks on one card).  Gates, with the [train]
    phase's tolerances: f64 loss, first-step gradients and BatchNorm
    buffers, and the buffers and parameters after the last step within 1e-4
    of each leaf's max-abs; bf16 loss within 2e-2 relative, the first
    step's BatchNorm buffers within 2e-2 of each leaf's max-abs (later ones
    follow parameters that bf16 noise has moved apart), no parameter
    further from the one-process run's than two AdamW trajectories can
    diverge in ``DDP_STEPS`` steps; every rank's parameters and buffers
    equal; K2 once per step on every rank.  Two ranks on one card time the
    plumbing, not a speed-up."""
    import dataclasses
    import shutil

    import torch

    from att_aspp_unet_tpu_torch.config import (Config, MeshConfig,
                                                ModelConfig, TrainConfig)
    from att_aspp_unet_tpu_torch.ops.image import resize_bilinear
    from att_aspp_unet_tpu_torch.parallel.mesh import (backend_for,
                                                       make_mesh_for_batch,
                                                       run_ranks)
    from att_aspp_unet_tpu_torch.train.augment import sample_params
    from att_aspp_unet_tpu_torch.train.train_loop import make_lr_schedule

    imgs, msks = (torch.as_tensor(a[:TRAIN_BATCH]) for a in train_set)
    full = Config(model=ModelConfig(base_c=BASE_C),
                  train=TrainConfig(batch_size=TRAIN_BATCH, epochs=1))
    small = Config(model=ModelConfig(base_c=8, compute_dtype="float64"),
                   train=TrainConfig(batch_size=TRAIN_BATCH, epochs=1))
    u8 = resize_bilinear(imgs.float(), (128, 128)).round().clamp(
        0, 255).to(torch.uint8)
    m8 = torch.nn.functional.interpolate(
        msks.float()[:, None], size=(128, 128), mode="nearest")[:, 0].to(
            torch.uint8)

    def draw(size):
        return sample_params(torch.Generator().manual_seed(SEED),
                             TRAIN_BATCH, size, size, full.train.augment)

    cases = {f"bf16 base_c {BASE_C} {TRAIN_SIZE}^2":
             (full, imgs, msks, draw(TRAIN_SIZE)),
             "f64 base_c 8 128^2": (small, u8, m8, draw(128))}
    one = {name: ddp_steps(*c, dev) for name, c in cases.items()}
    torch.cuda.empty_cache()
    # two runs whose gradients differ apart by bf16 rounding: each AdamW
    # step moves an element by at most about 2 lr (|m| / sqrt(v) after the
    # bias corrections, plus the weight decay), each run its own way
    sched = make_lr_schedule(full.train, 1)
    drift = 2 * 2 * sum(sched(k) for k in range(DDP_STEPS)) * \
        (1 + full.train.weight_decay)

    def worst(got, want):
        return max((float((got[k].double() - w.double()).abs().max())
                    / max(float(w.double().abs().max()), 1e-30), k)
                   for k, w in want.items())

    totals = new_totals()
    runs = [("(a) launcher", make_mesh_for_batch(MeshConfig(), TRAIN_BATCH)),
            ("(b) two ranks on card 0", [torch.device(dev)] * 2)]
    for label, devs in runs:
        out = Path(tempfile.mkdtemp(prefix="ddp_"))
        t0 = time.perf_counter()
        run_ranks(ddp_rank, devs, cases, str(out))
        wall = time.perf_counter() - t0
        res = [torch.load(out / f"rank{r}.pt", weights_only=False)
               for r in range(len(devs))]
        shutil.rmtree(out)
        counts = res[0]["launches"]
        for k1, k2 in counts:
            totals["fused_double_cbr"] += k1
            totals["clahe_interp"] += k2
        if any(c != (0, DDP_STEPS * len(cases)) for c in counts):
            raise AssertionError(f"ddp {label}: launches per rank {counts}, "
                                 f"expected (0, {DDP_STEPS * len(cases)})")
        for name, want in one.items():
            got = res[0][name]
            same = all(torch.equal(r[name]["state"][k], got["state"][k])
                       for r in res[1:] for k in got["state"])
            rel = max(abs(a - b) / abs(b) for a, b in zip(got["loss"],
                                                          want["loss"]))
            bufs = {k: v for k, v in want["state"].items()
                    if k.endswith((".mean", ".var"))}
            params = {k: v for k, v in want["state"].items() if k not in bufs}
            e_buf1 = worst(got["buffers1"], want["buffers1"])
            e_buf = worst({k: got["state"][k] for k in bufs}, bufs)
            e_par = worst({k: got["state"][k] for k in params}, params)
            d_par = max(float((got["state"][k].double() - v.double()).abs()
                              .max()) for k, v in params.items())
            line = (f"[ddp] {label}, {name}: {len(devs)} rank(s), "
                    f"{backend_for(devs)}, launcher wall {wall:.1f} s; loss "
                    f"{['%.6f' % v for v in got['loss']]} vs one process "
                    f"{['%.6f' % v for v in want['loss']]} (max rel "
                    f"{rel:.2e}); BN buffers after step 1 {e_buf1[0]:.2e} at "
                    f"{e_buf1[1]}, after step {DDP_STEPS} {e_buf[0]:.2e} at "
                    f"{e_buf[1]}, parameters {e_par[0]:.2e} at {e_par[1]} of "
                    f"the leaf's max-abs (max |diff| {d_par:.2e})")
            if want["grads"] is not None:
                e_g = worst(got["grads"], want["grads"])
                line += f", first-step gradients {e_g[0]:.2e} at {e_g[1]}"
                ok = max(rel, e_buf1[0], e_buf[0], e_par[0], e_g[0]) <= 1e-4
            else:
                line += f" (AdamW drift bound {drift:.2e})"
                ok = rel <= 2e-2 and e_buf1[0] <= 2e-2 and d_par <= drift
            log(line + f"; ranks equal {same}; {got['ms']:.2f} ms per step "
                f"(one process {want['ms']:.2f} ms); launches per rank "
                f"{counts}")
            if not (ok and same):
                raise AssertionError(f"ddp {label}, {name}: the ranks "
                                     "disagree with the one-process run")
    log(f"[ddp] cli train --device cuda takes {len(runs[0][1])} data "
        f"device(s) here ({[str(d) for d in runs[0][1]]}): the [train] "
        f"phase's CLI runs are its one-card form")
    return totals


# the runs of the port's benchmark (att_aspp_unet_tpu_torch/bench.py): label,
# its flags, and whether each of K1, K2, K3 runs on that path (the baseline
# has no K1 conv + BN pair, training convolves with cuDNN)
BENCH_RUNS = [("default", ["--bulk", "4"], (True, True, False)),
              ("int8", ["--int8"], (True, True, True)),
              ("roi", ["--roi"], (True, True, False)),
              ("baseline", ["--baseline"], (False, True, False)),
              ("train", ["--train"], (False, True, False))]
# make_sweep inputs of the serving runs beyond chip_smoke's own six sweeps:
# (frames, seed) of the 840-frame case and of the bulk group's four sweeps
BENCH_SWEEPS = [(840, 1)] + [(N_FRAMES, 10 + s) for s in range(4)]


def make_bench_sweep(n: int, seed: int, path: str) -> str:
    """A ``make_sweep`` input of the benchmark, saved to ``path`` (.npy).  A
    returned array would be unpickled by the pool's thread in this process
    while a later phase runs, holding the interpreter lock for the second or
    so that 351 MB take and stalling what that phase times."""
    import numpy as np

    from att_aspp_unet_tpu_torch.tools.synthetic import make_sweep

    np.save(path, make_sweep(n, *FRAME_HW, seed=seed)[0])
    return path


@contextlib.contextmanager
def plain_on_card():
    """Names of the kernels whose plain version was called on a CUDA
    tensor while the block ran (the wrappers call their plain version
    through the module attribute)."""
    from att_aspp_unet_tpu_torch.ops.kernels import clahe_interp as ci
    from att_aspp_unet_tpu_torch.ops.kernels import fused_conv as fc
    from att_aspp_unet_tpu_torch.ops.kernels import int8_conv as ic

    calls = []
    saved = [(m, n, getattr(m, n)) for m, n in (
        (fc, "fused_double_cbr_reference"), (ci, "clahe_interp_reference"),
        (ic, "int8_conv3x3_reference"))]

    def counted(name, fn):
        def call(x, *a, **kw):
            if x.is_cuda:
                calls.append(name)
            return fn(x, *a, **kw)
        return call

    for m, n, fn in saved:
        setattr(m, n, counted(n, fn))
    try:
        yield calls
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)


def phase_bench(made):
    """The port's benchmark in this process, each run at its full default
    size: the default line with ``--bulk 4``, ``--int8``, ``--roi``,
    ``--baseline``, ``--train``.  ``made`` holds the ``make_sweep`` inputs
    already made (see ``bench.synthetic_sweep``).  Each run's line printed
    once and parsed, naming the H100, a positive value; the direct figure's
    FLOPs per frame 226.8; each kernel of the path launched and no other,
    no plain version called on a card tensor; the cascade's pick on the
    case equal to the direct path's, and ``--int8``'s equal to bf16's."""
    from att_aspp_unet_tpu_torch import bench

    smi = nvidia_smi()
    totals, lines = new_totals(), {}
    for label, argv, runs in BENCH_RUNS:
        out = io.StringIO()
        reset_launches()
        t0 = time.perf_counter()
        with plain_on_card() as plain, contextlib.redirect_stdout(out):
            line = bench.main(argv, made)
        wall = time.perf_counter() - t0
        got = {k: fn.launches for k, fn in _wrappers().items()}
        printed = out.getvalue().splitlines()
        log(f"[bench] {label} ({smi}), {wall:.1f} s: {printed[-1]}")
        log(f"[bench] {label}: picks {line['_picks']}, kernel launches "
            f"{got}")
        picks = line.pop("_picks")
        lines[label] = (line, picks)
        if len(printed) != 1 or json.loads(printed[0]) != line:
            raise AssertionError(f"bench {label}: printed {printed}")
        if "H100" not in line["device"] or not line["value"] > 0:
            raise AssertionError(f"bench {label}: {line}")
        wrong = [k for k, run in zip(KERNELS, runs) if (got[k] > 0) != run]
        if wrong or plain:
            raise AssertionError(f"bench {label}: launches {got} (path "
                                 f"runs {runs}), plain versions on the "
                                 f"card: {sorted(set(plain))}")
        for k, v in got.items():
            totals[k] += v
    for label in ("default", "int8"):
        line, picks = lines[label]
        if line["direct_case_gflop_per_frame"] != 226.8:
            raise AssertionError(f"bench {label}: "
                                 f"{line['direct_case_gflop_per_frame']}")
        if picks["case"][0] != picks["direct"][0]:
            raise AssertionError(f"bench {label}: the cascade picked frame "
                                 f"{picks['case'][0]} of the case, the "
                                 f"direct path {picks['direct'][0]}")
    if lines["int8"][1]["case"][0] != lines["default"][1]["case"][0]:
        raise AssertionError("bench: --int8 picked another frame of the "
                             "case than bf16")
    return totals


def nvidia_smi() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]


def host_library(name: str) -> str:
    """The version of a host library (without importing it), or
    "missing"."""
    import zlib
    from importlib import metadata, util

    if name == "zlib":
        return zlib.ZLIB_RUNTIME_VERSION
    if util.find_spec(name) is None:
        return "missing"
    try:
        return metadata.version({"PIL": "pillow"}.get(name, name))
    except metadata.PackageNotFoundError:
        return "present"


def make_seeded_sweep(seed: int):
    from att_aspp_unet_tpu_torch.tools.synthetic import make_sweep

    return make_sweep(N_FRAMES, *FRAME_HW, seed=seed)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--save-int8-scales", default=None, metavar="NPZ",
                    help="also save the int8 container's calibrated "
                         "variables (with their quant collection) there")
    ap.add_argument("--only", choices=["swin", "baseline"], default=None,
                    help="build the kernels and run this phase alone: "
                         "swin on the first seeded sweep, baseline on it "
                         "and on the six-sweep case")
    args = ap.parse_args(argv)
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
    smi = nvidia_smi()
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}; "
        + ", ".join(f"{m} {host_library(m)}"
                    for m in ("PIL", "pandas", "matplotlib", "zlib")))
    t_start = time.perf_counter()
    if args.only:
        phase_build()
        with tempfile.TemporaryDirectory() as tmp:
            if args.only == "swin":
                launches = phase_swin(dev, make_seeded_sweep(SEED)[0],
                                      Path(tmp))
            else:
                with ProcessPoolExecutor(
                        max_workers=N_SWEEPS,
                        mp_context=multiprocessing.get_context(
                            "spawn")) as pool:
                    sweeps = [m[0] for m in pool.map(
                        make_seeded_sweep,
                        range(SEED, SEED + N_SWEEPS))]
                launches = phase_baseline(dev, sweeps[0],
                                          np.concatenate(sweeps), Path(tmp))
        log(f"[done] {time.perf_counter() - t_start:.1f} s, launches "
            f"{launches}")
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    # the six sweeps are generated by worker processes (numpy only) while
    # the kernels build; the kernels are timed after that, with the host's
    # cores free (busy cores delayed the launches that were timed)
    with ProcessPoolExecutor(
            max_workers=N_SWEEPS,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        futures = [pool.submit(make_seeded_sweep, SEED + k)
                   for k in range(N_SWEEPS)]
        val_futures = [pool.submit(make_val_group, *g) for g in VAL_GROUPS]
        train_futures = [pool.submit(make_train_set, *t)
                         for t in (TRAIN_SET, VAL_SET)]
        phase_build()
        t0 = time.perf_counter()
        made = [f.result() for f in futures]
        val = [f.result() for f in val_futures]
        train_sets = [f.result() for f in train_futures]
    sweeps = [m[0] for m in made]
    bests = [m[1] for m in made]
    log(f"[data] {N_SWEEPS} synthetic sweeps {sweeps[0].shape} seeds "
        f"{SEED}..{SEED + N_SWEEPS - 1}, best frames {bests} (waited "
        f"{time.perf_counter() - t0:.1f} s after the build)")
    k1 = phase_k1(dev, tuple(K1_SHAPE_SETS))
    k2 = phase_k2(dev, sweeps, val)
    k3 = phase_k3(dev)
    variables, thr = load_main()
    totals = new_totals()

    def add(launches):
        for k, v in launches.items():
            totals[k] += v

    # the benchmark's own inputs are made by two workers beside the phases
    # from [baseline] on (after the host-paced serving figures)
    with tempfile.TemporaryDirectory() as tmp, ProcessPoolExecutor(
            max_workers=2, mp_context=multiprocessing.get_context(
                "spawn")) as bench_pool:
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
        del cascade_engine
        torch.cuda.empty_cache()
        add(phase_sharded(dev, sweeps[0], np.concatenate(sweeps), variables,
                          thr, direct_engine))
        del direct_engine
        torch.cuda.empty_cache()
        add(phase_variants(dev, sweeps[0], bests[0], thr, tmp))
        add(phase_calibrate(dev, val, tmp))
        add(phase_png(dev, sweeps[0], bests[0], thr, tmp))
        torch.cuda.empty_cache()
        case = np.concatenate(sweeps)
        abdomen_case = [k * N_FRAMES + i for k, b in enumerate(bests)
                        for i in abdomen_frames(N_FRAMES, b)]
        add(phase_container(dev, case, abdomen_case, variables, tmp))
        add(phase_int8(dev, sweeps, bests, variables, thr, tmp,
                       args.save_int8_scales))
        torch.cuda.empty_cache()
        bench_inputs = {(n, *FRAME_HW, seed): bench_pool.submit(
            make_bench_sweep, n, seed, str(tmp / f"bench_{n}_{seed}.npy"))
            for n, seed in BENCH_SWEEPS}
        add(phase_baseline(dev, sweeps[0], case, tmp))
        torch.cuda.empty_cache()
        add(phase_swin(dev, sweeps[0], tmp))
        torch.cuda.empty_cache()
        add(phase_train(dev, sweeps[0], bests[0], thr, tmp, *train_sets))
        torch.cuda.empty_cache()
        add(phase_ddp(dev, train_sets[0]))
        torch.cuda.empty_cache()
        add(phase_compat(dev, case, sweeps, variables, tmp))
        add(phase_entry(dev, case, sweeps, tmp))
        add(phase_image(dev, case, sweeps, tmp))
        add(phase_tools(dev, sweeps, [m[2] for m in made], train_sets, thr,
                        tmp))
        add(phase_native(dev, case, sweeps, variables, thr, tmp))
        t0 = time.perf_counter()
        made = {(N_FRAMES, *FRAME_HW, SEED): sweeps[0]}
        made.update({k: np.load(f.result())
                     for k, f in bench_inputs.items()})
        log(f"[bench] inputs {sorted(made)} (waited "
            f"{time.perf_counter() - t0:.1f} s)")
        add(phase_bench(made))
        del made
        phase_warm(dev, thr, tmp)
    k1["launches"] = totals["fused_double_cbr"]
    k2["launches"] = totals["clahe_interp"]
    k3["launches"] = totals["int8_conv3x3"]
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(f"gpu: {smi}")
    print(json.dumps({"kernels": [k1, k2, k3]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
