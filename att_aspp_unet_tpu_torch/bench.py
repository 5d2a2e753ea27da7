"""Benchmark of the port: sweep-inference throughput of the Attention-ASPP-UNet
on one card, the counterpart of the repository's root ``bench.py``.

    python -m att_aspp_unet_tpu_torch.bench [--bulk 4] [--int8] [--tta]
        [--no-cascade] [--forward-only | --no-postprocess | --roi
         | --baseline | --train] [--device cpu]

Same flags, defaults, modes and measurements as ``bench.py``, and the same
one JSON line on stdout (diagnostics go to stderr, prefixed ``[bench]``):

- default: the two-tier cascade on the 140-frame sweep (sequential median,
  dispatch-only, pipelined mean at depth ``--pipeline``) and on the 840-frame
  case, the headline ``e2e_case_frames_per_sec_512``; beside it the direct
  path's dispatch-only figure on the case (``cascade=False``), its FLOPs per
  frame and MFU, the hflip-TTA case figure, and with ``--bulk S`` a group of
  S sweeps through ``predict_bulk``.  The trained weights
  (``resources/synthetic``) and the distilled scout serve at base_c 48 and
  512 px; otherwise, or with ``--random-weights``, the seeded initialisation
  with the 0.97 quantile of the probabilities as the threshold;
- ``--forward-only``: ``predict_sweep_probs`` alone; ``--no-postprocess``:
  ``AttAsppEngine.predict_full``;
- ``--roi``: the container's ROI path (``predict_roi`` -> ``postprocess_roi``
  -> ``select_mask_and_frame``) on an 840-frame case, cases/s;
- ``--baseline``: ``BaselineEngine.predict`` -> ``postprocess``
  (``--tile-batch``, ``--mirror-batch``);
- ``--train``: ``create_train_state`` + ``train_step`` at 512 px, batch 8;
- ``--int8``: ``ModelConfig.conv_lowering="int8"``; every engine's first run
  includes its calibration.

Every input is on the device before a timed window starts, and every timed
window ends in ``torch.cuda.synchronize()`` (a host clock, as in
``bench.py``).  The line adds to ``bench.py``'s keys the device it ran on
(``device``: ``torch.cuda.get_device_name``, or ``"cpu"``), ``device_count``
and the card's ``power_limit`` (``nvidia-smi``); ``direct_case_mfu`` is
against the H100's dense bf16 peak, 989 TFLOP/s, and null on the CPU.
``--device`` defaults to ``cuda`` and raises without a card; ``--device cpu``
runs the kernels' plain versions and is there for the tests.

Not ported: the remote-TPU backend retry (``_await_backend``), the TPU-only
``--lowering`` and ``--c1-pad`` with the key ``direct_case_c1_pad`` (the port
serves the direct and int8 lowerings), and the JAX compilation cache (the
kernels are built once into the package's ``build/`` directory).  ``--train``
trains with the direct lowering, the port's only training lowering.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
import time
from collections import deque
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .config import (Config, ModelConfig, PredictConfig, PreprocessConfig,
                     TrainConfig)
from .device import resolve_device

REPO = Path(__file__).resolve().parents[1]
# distilled scouts in order of preference: the 128-px no-CLAHE scout, the
# 256-px no-CLAHE scout, the 256-px CLAHE scout
SCOUTS = ("synthetic_scout_noclahe128", "synthetic_scout_noclahe",
          "synthetic_scout")
H100_BF16_PEAK_TFLOPS = 989.0    # dense bf16 tensor-core rate, SXM, 700 W
SPACING = (0.28, 0.28)


def forward_gflops(base_c: int = 48, size: int = 512, in_ch: int = 1,
                   num_classes: int = 1, tta: bool = False) -> float:
    """Conv-layer FLOPs (2 x multiply-adds) of one v1 Attention-ASPP-UNet
    forward over a ``size`` x ``size`` frame, in GFLOP: the encoder pairs,
    the five-branch ASPP and its projection, per decoder level the 2x2
    transposed conv, the v1 gate and the pair, and the 1x1 head.
    BatchNorm, ReLU and pooling are left out.  hflip TTA doubles it."""
    def conv(k, ci, co, s):
        return 2.0 * k * k * ci * co * s * s

    c, S = base_c, size
    f = 0.0
    for (s, ci, co) in ((S, in_ch, c), (S // 2, c, 2 * c),
                        (S // 4, 2 * c, 4 * c), (S // 8, 4 * c, 8 * c)):
        f += conv(3, ci, co, s) + conv(3, co, co, s)
    b, ci, co = S // 16, 8 * c, 16 * c
    f += conv(1, ci, co, b) + 3 * conv(3, ci, co, b) + \
        2 * ci * co + conv(1, 5 * co, co, b)
    for (s, gi, fo, gated) in ((S // 8, 16 * c, 8 * c, True),
                               (S // 4, 8 * c, 4 * c, True),
                               (S // 2, 4 * c, 2 * c, True),
                               (S, 2 * c, c, False)):
        f += 2.0 * 4 * gi * fo * (s // 2) ** 2      # ConvTranspose 2x2 s2
        if gated:
            f += 2 * conv(1, fo, fo // 2, s) + conv(1, fo // 2, 1, s)
        f += conv(3, 2 * fo, fo, s) + conv(3, fo, fo, s)
    f += conv(1, c, num_classes, S)
    return f * (2.0 if tta else 1.0) / 1e9


def quantile(x: torch.Tensor, q: float) -> float:
    """The ``q`` quantile of every element of ``x`` with linear interpolation
    between the two order statistics around ``q * (n - 1)`` (``np.quantile``'s
    and ``jnp.quantile``'s default).  ``torch.quantile`` takes at most 2**24
    elements; ``kthvalue`` takes any number."""
    flat = x.reshape(-1).float()
    pos = (flat.numel() - 1) * q
    lo = math.floor(pos)
    a = float(flat.kthvalue(lo + 1).values)
    t = pos - lo
    if t == 0.0:
        return a
    b = float(flat.kthvalue(lo + 2).values)
    # np.quantile's lerp: from the nearer end
    return b - (b - a) * (1.0 - t) if t >= 0.5 else a + (b - a) * t


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def wait(dev: torch.device) -> None:
    """Wait for the device; every timed window ends here."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def free(dev: torch.device) -> None:
    """Return the cached blocks of a freed engine to the card."""
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def upload(host: np.ndarray, dev: torch.device) -> torch.Tensor:
    """``host`` on the device, the copy finished."""
    out = torch.as_tensor(host).to(dev)
    wait(dev)
    return out


def random_frames(rng: np.random.Generator, shape) -> np.ndarray:
    return (rng.random(shape) * 255).astype(np.uint8)


def synthetic_sweep(made: dict, n: int, H: int, W: int, seed: int
                    ) -> np.ndarray:
    """``tools/synthetic.make_sweep`` frames, made once per process: ``made``
    maps (n, H, W, seed) to frames; a caller may fill it beforehand."""
    key = (n, H, W, seed)
    if key not in made:
        from .tools.synthetic import make_sweep

        t0 = time.perf_counter()
        made[key] = make_sweep(n, H, W, seed=seed)[0]
        log(f"make_sweep({n}, {H}, {W}, seed={seed}) "
            f"{time.perf_counter() - t0:.1f}s")
    return made[key]


def device_keys(dev: torch.device) -> dict:
    """The keys that name what ran: the card's name, the number of cards and
    the card's power limit (``nvidia-smi``), or the CPU."""
    if dev.type == "cpu":
        return {"device": "cpu", "device_count": 1, "power_limit": None}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.splitlines()[0]
    return {"device": torch.cuda.get_device_name(dev),
            "device_count": torch.cuda.device_count(),
            "power_limit": smi.split(",")[-1].strip()}


def first_run(label: str, fn: Callable):
    t0 = time.perf_counter()
    out = fn()
    log(f"{label}first run {time.perf_counter() - t0:.1f}s")
    return out


def dispatch_only(dev, submit: Callable, collect: Callable, n: int):
    """``bench.py``'s dispatch-only figure: ``n`` submits back to back, then
    one wait for the device; (seconds per submit, last collected result).
    The handles are collected after the window."""
    t0 = time.perf_counter()
    handles = [submit() for _ in range(n)]
    wait(dev)
    sec = (time.perf_counter() - t0) / n
    return sec, [collect(h) for h in handles][-1]


def pipelined(submit: Callable, collect: Callable, iters: int, depth: int):
    """``bench.py``'s pipelined figure: ``depth`` submits in flight before
    the window, then ``iters`` times submit one and collect the oldest, then
    collect the rest; (mean seconds over ``iters + depth``, seconds between
    successive collects, last collected result).  A collect reads its result
    back, so the window ends with the device idle."""
    q = deque(submit() for _ in range(depth))
    t0 = time.perf_counter()
    stamps = [t0]
    out = None
    for _ in range(iters):
        q.append(submit())
        out = collect(q.popleft())
        stamps.append(time.perf_counter())
    while q:
        out = collect(q.popleft())
        stamps.append(time.perf_counter())
    steps = [b - a for a, b in zip(stamps, stamps[1:])]
    return (stamps[-1] - t0) / (iters + depth), steps, out


def fmt(times) -> List[str]:
    return ["%.3f" % t for t in times]


def median(times) -> float:
    return sorted(times)[len(times) // 2]


# ---------------------------------------------------------------- serving


@dataclasses.dataclass(frozen=True)
class Trained:
    """What ``resources/`` gives the serving modes at base_c 48 and 512 px:
    the main model's weights and thresholds, and the distilled scout."""

    weights: Path
    thr: Optional[float]          # for this run's TTA mode (thr.json)
    thr_tta: Optional[float]      # for the hflip-TTA figure
    scout: Optional[Path]         # the scout's weights.npz, if one serves
    scout_thr: float = 0.0
    scout_meta: Optional[dict] = None   # its summary.json


def find_trained(args, root: Path = REPO / "resources") -> Optional[Trained]:
    """The trained weights the serving modes use, by ``bench.py``'s rule;
    None with ``--random-weights``, outside base_c 48 at 512 px or without
    ``synthetic/weights.npz``."""
    syn = root / "synthetic"
    if (args.random_weights or args.base_c != 48 or args.img_size != 512
            or not (syn / "weights.npz").exists()):
        return None
    thr = thr_tta = None
    if (syn / "thr.json").exists():
        cal = json.loads((syn / "thr.json").read_text())
        key = "best_thr_tta" if args.tta else "best_thr_no_tta"
        thr = float(cal.get(key, cal["best_thr"]))
        thr_tta = float(cal.get("best_thr_tta", cal["best_thr"]))
    scout = next((root / n / "weights.npz" for n in SCOUTS
                  if (root / n / "weights.npz").exists()), None)
    if not (args.cascade and args.scout_model and scout is not None):
        return Trained(syn / "weights.npz", thr, thr_tta, None)
    scout_thr = 0.0
    if (scout.parent / "thr.json").exists():
        scal = json.loads((scout.parent / "thr.json").read_text())
        scout_thr = float(scal.get("best_thr_no_tta", scal["best_thr"]))
    meta = (json.loads((scout.parent / "summary.json").read_text())
            if (scout.parent / "summary.json").exists() else {})
    return Trained(syn / "weights.npz", thr, thr_tta, scout, scout_thr, meta)


def serving_config(args, trained: Optional[Trained] = None) -> Config:
    """The serving modes' configuration from the flags; a trained scout pins
    the cascade's tier-1 size and width (from its ``summary.json``) and
    threshold."""
    cfg = Config(
        preprocess=PreprocessConfig(img_size=args.img_size),
        model=ModelConfig(base_c=args.base_c,
                          conv_lowering="int8" if args.int8 else "direct"),
        predict=PredictConfig(frame_batch=args.batch,
                              tta_hflip=bool(args.tta),
                              cascade=bool(args.cascade),
                              cascade_img_size=args.cascade_size or 256,
                              cascade_scouts=args.cascade_scouts))
    if trained is None or trained.scout is None:
        return cfg
    meta = trained.scout_meta or {}
    return dataclasses.replace(cfg, predict=dataclasses.replace(
        cfg.predict,
        cascade_img_size=int(meta.get("img_size", args.cascade_size or 256)),
        cascade_scout_weights=str(trained.scout),
        cascade_scout_base_c=int(meta.get("base_c", 16)),
        cascade_scout_thr=trained.scout_thr))


def bench_serving(args, cfg: Config, dev: torch.device,
                  trained: Optional[Trained] = None,
                  made: Optional[dict] = None) -> dict:
    """The default mode, ``--forward-only`` and ``--no-postprocess`` with
    ``cfg`` (:func:`serving_config`); ``trained`` None serves the seeded
    initialisation.  Returns the line, with the last collected
    (best_frame, ac_mm) of each timed engine under ``_picks``."""
    from .infer.engine import AttAsppEngine, predict_sweep_probs
    from .utils.convert import init_variables, jax_variables_to_torch
    from .utils.npz_weights import load_npz_variables

    made = {} if made is None else made
    rng = np.random.default_rng(0)
    pc = cfg.predict
    if trained is not None:
        variables = load_npz_variables(trained.weights)
        log(f"trained synthetic weights, thr={trained.thr}")
        if trained.scout is not None:
            log(f"distilled scout {trained.scout.parent.name} base_c="
                f"{pc.cascade_scout_base_c} size={pc.cascade_img_size} "
                f"thr={pc.cascade_scout_thr} "
                f"clahe={(trained.scout_meta or {}).get('use_clahe', True)}")
        host_sweep = synthetic_sweep(made, args.frames, args.height,
                                     args.width, 0)
    else:
        variables = init_variables(cfg.model, seed=0)
        host_sweep = random_frames(rng, (args.frames, args.height,
                                         args.width))
    sweep = upload(host_sweep, dev)

    if args.forward_only:
        x = upload(rng.random((args.frames, args.img_size, args.img_size))
                   .astype(np.float32), dev)
        model = jax_variables_to_torch(variables, cfg.model, device=dev)

        def run():
            with torch.no_grad():
                predict_sweep_probs(model, x, args.batch, bool(args.tta))
            wait(dev)
        metric = "forward_frames_per_sec_512"
    elif args.no_postprocess:
        engine = AttAsppEngine(cfg, variables, device=dev)

        def run():
            engine.predict_full(sweep)
            wait(dev)
        metric = "sweep_frames_per_sec_512"
    else:
        engine = AttAsppEngine(cfg, variables, device=dev)
        if trained is not None and trained.thr is not None:
            thr = trained.thr
        else:
            # random weights give near-uniform probabilities: the 97th
            # percentile makes the masks blobby islands
            thr = quantile(engine.predict_full(sweep), 0.97)
        metric = "e2e_frames_per_sec_512"

    def case_fns(eng, data, t):
        return (lambda: eng.predict_case_submit(data, t),
                lambda h: eng.predict_case_collect(h, SPACING)[::2])

    picks: Dict[str, object] = {}
    if metric == "e2e_frames_per_sec_512":
        submit, collect = case_fns(engine, sweep, thr)
        first_run("", lambda: collect(submit()))
        seq_times = []
        for _ in range(args.iters):
            t0 = time.perf_counter()
            collect(submit())
            seq_times.append(time.perf_counter() - t0)
        seq_fps = args.frames / median(seq_times)
        log(f"sequential times={fmt(seq_times)} median fps={seq_fps:.1f}")
        disp, _ = dispatch_only(dev, submit, collect, 2 * args.iters)
        disp_fps = args.frames / disp
        log(f"dispatch-only {disp:.3f} s/sweep ({disp_fps:.1f} f/s)")
        depth = max(1, args.pipeline)
        best, steps, picks["sweep"] = pipelined(submit, collect, args.iters,
                                                depth)
        times = [best]
        log(f"pipelined times between collects={fmt(steps)}")
    else:
        first_run("", run)
        times = []
        for _ in range(args.iters):
            t0 = time.perf_counter()
            run()
            times.append(time.perf_counter() - t0)
        best = median(times)
    fps = args.frames / best
    log(f"times={fmt(times)} median fps={fps:.1f} "
        f"sweep/s={fps / args.frames:.2f}")

    line = {"metric": metric, "value": round(fps, 1),
            "unit": "frames/sec/chip", "vs_baseline": round(fps / 500.0, 3)}
    if metric != "e2e_frames_per_sec_512":
        return line
    line["mode"] = f"pipelined_depth{depth}"
    line["sequential_fps"] = round(seq_fps, 1)
    line["dispatch_only_fps"] = round(disp_fps, 1)
    line["serving_mode"] = "cascade" if args.cascade else "direct"
    line["tta"] = bool(args.tta)
    if args.cascade:
        line["cascade"] = {"scouts": args.cascade_scouts,
                           "low_size": pc.cascade_img_size}

    # ---- the full challenge case (the container's input unit) ----
    has_case = bool(args.case_frames and args.case_frames != args.frames)
    if has_case:
        ncf = args.case_frames
        host_case = (synthetic_sweep(made, ncf, args.height, args.width, 1)
                     if trained is not None else
                     random_frames(rng, (ncf, args.height, args.width)))
        case = upload(host_case, dev)
        submit, collect = case_fns(engine, case, thr)
        first_run("case ", lambda: collect(submit()))
        case_disp, _ = dispatch_only(dev, submit, collect, 2 * args.iters)
        case_pipe, steps, picks["case"] = pipelined(submit, collect,
                                                    args.iters, depth)
        case_fps = ncf / case_pipe
        log(f"case({ncf}) dispatch-only {case_disp:.3f} s "
            f"({ncf / case_disp:.1f} f/s), pipelined {case_pipe:.3f} s "
            f"({case_fps:.1f} f/s); times between collects={fmt(steps)}")
        line.update({
            "metric": "e2e_case_frames_per_sec_512",
            "value": round(case_fps, 1),
            "vs_baseline": round(case_fps / 500.0, 3),
            "case_frames": ncf,
            "case_dispatch_only_fps": round(ncf / case_disp, 1),
            "sweep_frames": args.frames,
            "sweep_pipelined_fps": round(fps, 1),
        })
        del line["sequential_fps"], line["dispatch_only_fps"]
        line["sweep_sequential_fps"] = round(seq_fps, 1)
        line["sweep_dispatch_only_fps"] = round(disp_fps, 1)
        if args.cascade:
            sc_c = pc.cascade_scout_base_c or args.base_c
            g_eff = (forward_gflops(sc_c, pc.cascade_img_size)
                     + pc.cascade_scouts / ncf
                     * forward_gflops(args.base_c, args.img_size,
                                      tta=bool(args.tta)))
            line["cascade_effective_gflop_per_frame"] = round(g_eff, 2)

    # ---- the exhaustive (direct) figure on the same input ----
    if args.cascade and args.direct_figure:
        dengine = AttAsppEngine(dataclasses.replace(
            cfg, predict=dataclasses.replace(pc, cascade=False)), variables,
            device=dev)
        d_in, d_n = (case, args.case_frames) if has_case \
            else (sweep, args.frames)
        submit, collect = case_fns(dengine, d_in, thr)
        first_run("direct ", lambda: collect(submit()))
        d_disp, picks["direct"] = dispatch_only(dev, submit, collect,
                                                max(2, args.iters))
        del dengine, submit, collect
        free(dev)
        log(f"direct({d_n}) dispatch-only {d_disp:.3f} s "
            f"({d_n / d_disp:.1f} f/s)")
        line["direct_case_dispatch_only_fps"] = round(d_n / d_disp, 1)
        line["direct_case_frames"] = d_n
        g_dir = forward_gflops(args.base_c, args.img_size,
                               tta=bool(args.tta))
        line["direct_case_gflop_per_frame"] = round(g_dir, 1)
        line["direct_case_mfu"] = (
            round((d_n / d_disp) * g_dir / 1e3 / H100_BF16_PEAK_TFLOPS, 4)
            if dev.type == "cuda" else None)

    # ---- the hflip-TTA case figure (what the predict CLI ships) ----
    if has_case:
        if args.tta:
            line["tta_case_fps"] = line["case_dispatch_only_fps"]
        else:
            tengine = AttAsppEngine(dataclasses.replace(
                cfg, predict=dataclasses.replace(pc, tta_hflip=True)),
                variables, device=dev)
            tthr = trained.thr_tta if (trained is not None and
                                       trained.thr_tta is not None) else thr
            submit, collect = case_fns(tengine, case, tthr)
            first_run("tta case ", lambda: collect(submit()))
            t_disp, picks["tta"] = dispatch_only(dev, submit, collect,
                                                 max(2, args.iters))
            del tengine, submit, collect
            free(dev)
            log(f"tta case({args.case_frames}) dispatch-only {t_disp:.3f} s "
                f"({args.case_frames / t_disp:.1f} f/s)")
            line["tta_case_fps"] = round(args.case_frames / t_disp, 1)

    # ---- bulk multi-sweep serving (--bulk S) ----
    if args.bulk and args.cascade:
        S = args.bulk
        if trained is not None:
            host_group = np.stack([synthetic_sweep(
                made, args.frames, args.height, args.width, 10 + s)
                for s in range(S)])
        else:
            host_group = random_frames(rng, (S, args.frames, args.height,
                                             args.width))
        group = upload(host_group, dev)
        submit = lambda: engine.predict_bulk_submit(group, thr)  # noqa: E731

        def collect(h):
            return [r[::2] for r in engine.predict_bulk_collect(h, SPACING)]

        first_run(f"bulk({S}) ", lambda: collect(submit()))
        bulk_disp, picks["bulk"] = dispatch_only(dev, submit, collect,
                                                 2 * args.iters)
        bulk_fps = S * args.frames / bulk_disp
        log(f"bulk({S}x{args.frames}) dispatch-only {bulk_disp:.3f} s/group "
            f"({bulk_fps:.1f} f/s, {S / bulk_disp:.1f} sweeps/s)")
        line["bulk"] = {"group_sweeps": S,
                        "dispatch_only_fps": round(bulk_fps, 1),
                        "sweeps_per_sec": round(S / bulk_disp, 2),
                        "frame_batch": pc.bulk_frame_batch}
    line["_picks"] = picks
    return line


# ------------------------------------------------------------- other modes


def roi_config(args) -> Config:
    return Config(model=ModelConfig(base_c=args.base_c))


def bench_roi(args, cfg: Config, dev: torch.device) -> dict:
    """The container's ROI path (linspace subsample, centroid crop, forward,
    paste-back, postprocess, max-area frame) on a random case, seeded
    initialisation; cases/s."""
    from .infer.engine import AttAsppEngine, select_mask_and_frame
    from .utils.convert import init_variables

    engine = AttAsppEngine(cfg, init_variables(cfg.model, seed=0),
                           device=dev)
    rng = np.random.default_rng(0)
    case = random_frames(rng, (args.frames, args.height, args.width))

    def run():
        masks = engine.postprocess_roi(engine.predict_roi(case))
        frame = select_mask_and_frame(masks)[1]
        wait(dev)
        return frame

    first_run("", run)
    times = []
    for _ in range(args.iters):
        t0 = time.perf_counter()
        frame = run()
        times.append(time.perf_counter() - t0)
    best = median(times)
    log(f"times={fmt(times)}")
    return {"metric": "roi_container_cases_per_sec",
            "value": round(1.0 / best, 2), "unit": "cases/sec/chip",
            "vs_baseline": round((1.0 / best) / 1.0, 3),
            "_picks": {"roi": frame}}


def baseline_config(args) -> Config:
    cfg = Config()
    overrides = {}
    if args.tile_batch is not None:
        overrides["tile_batch"] = args.tile_batch
    if args.mirror_batch is not None:
        overrides["mirror_batch"] = bool(args.mirror_batch)
    if overrides:
        cfg = dataclasses.replace(cfg, plain_unet=dataclasses.replace(
            cfg.plain_unet, **overrides))
    return cfg


def bench_baseline(args, cfg: Config, dev: torch.device) -> dict:
    """The nnU-Net-style path (enhancement, Gaussian-weighted sliding-window
    tiles with mirror TTA, softmax postprocess) with the seeded
    initialisation of seed 0; native frames/s."""
    from .infer.engine import BaselineEngine
    from .models import PlainConvUNet

    engine = BaselineEngine(cfg, PlainConvUNet.from_config(cfg.plain_unet,
                                                           seed=0),
                            device=dev)
    rng = np.random.default_rng(0)
    sweep = upload(random_frames(rng, (args.frames, args.height,
                                       args.width)), dev)

    def run():
        engine.postprocess(engine.predict(sweep))
        wait(dev)

    first_run("", run)
    times = []
    for _ in range(args.iters):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    fps = args.frames / median(times)
    log(f"times={fmt(times)}")
    return {"metric": "baseline_sliding_window_frames_per_sec_native",
            "value": round(fps, 2), "unit": "frames/sec/chip",
            "vs_baseline": round(fps / 500.0, 4)}


def train_config(args) -> Config:
    if args.int8:
        # int8 is serving-only post-training quantization
        raise SystemExit("--train supports lowering direct, not 'int8'")
    return Config(preprocess=PreprocessConfig(img_size=args.img_size),
                  model=ModelConfig(base_c=args.base_c),
                  train=TrainConfig(batch_size=8))


def bench_train(args, cfg: Config, dev: torch.device) -> dict:
    """Training-step throughput: augment, forward, backward, AdamW on a
    fixed random batch; samples/s."""
    from .train.train_loop import create_train_state, train_step

    S, B = cfg.preprocess.img_size, cfg.train.batch_size
    state = create_train_state(cfg.model, cfg.train, steps_per_epoch=100,
                               device=dev)
    rng = np.random.default_rng(0)
    imgs = upload(random_frames(rng, (B, S, S)), dev)
    msks = np.zeros((B, S, S), np.uint8)
    msks[:, S // 4: 3 * S // 4, S // 4: 3 * S // 4] = 255
    msks = upload(msks, dev)

    train_step(state, cfg, imgs, msks)
    wait(dev)
    times = []
    for _ in range(args.iters):
        t0 = time.perf_counter()
        train_step(state, cfg, imgs, msks)
        wait(dev)
        times.append(time.perf_counter() - t0)
    sps = B / median(times)
    log(f"train times={fmt(times)}")
    return {"metric": "train_samples_per_sec_512_bs8",
            "value": round(sps, 2), "unit": "samples/sec/chip",
            "vs_baseline": round(sps / 100.0, 3)}


# --------------------------------------------------------------------- main


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=None,
                    help="one sweep (140; --roi: 840)")
    ap.add_argument("--case-frames", type=int, default=840,
                    help="also measure one full challenge case and make it "
                         "the headline; 0 skips it")
    ap.add_argument("--height", type=int, default=562)
    ap.add_argument("--width", type=int, default=744)
    ap.add_argument("--img-size", type=int, default=512)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--base-c", type=int, default=48)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--pipeline", type=int, default=2,
                    help="sweeps kept in flight (submit i+k before "
                         "collecting i); 1 = sequential only")
    ap.add_argument("--tta", action="store_true", help="hflip TTA")
    ap.add_argument("--no-tta", action="store_true",
                    help="deprecated: TTA is already off by default")
    ap.add_argument("--forward-only", action="store_true",
                    help="the network alone, no pre- or postprocess")
    ap.add_argument("--no-postprocess", action="store_true",
                    help="stop after the blurred probability maps")
    ap.add_argument("--train", action="store_true",
                    help="the train step instead")
    ap.add_argument("--tile-batch", type=int, default=None,
                    help="baseline: patch tiles per micro-batch")
    ap.add_argument("--mirror-batch", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="baseline: the 4 mirror views as one forward")
    ap.add_argument("--baseline", action="store_true",
                    help="the nnU-Net baseline path instead")
    ap.add_argument("--roi", action="store_true",
                    help="the container's ROI path instead")
    ap.add_argument("--int8", action="store_true",
                    help="serve the 3x3 convs int8 (calibrated on the "
                         "first sweep of each engine)")
    ap.add_argument("--random-weights", action="store_true",
                    help="seeded init + percentile threshold even where "
                         "trained weights exist")
    ap.add_argument("--cascade", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="two-tier serving (default); --no-cascade benches "
                         "the exhaustive full-resolution path")
    ap.add_argument("--cascade-scouts", type=int, default=8)
    ap.add_argument("--direct-figure", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="with the cascade, also the direct path's "
                         "dispatch-only figure on the same input")
    ap.add_argument("--bulk", type=int, default=0,
                    help="also a group of N sweeps through predict_bulk "
                         "(cascade only)")
    ap.add_argument("--cascade-size", type=int, default=None,
                    help="scout resolution; default the distilled scout's "
                         "training size, else 256")
    ap.add_argument("--scout-model", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="rank with the distilled scout where present")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    if args.frames is None:
        args.frames = 840 if args.roi else 140
    return args


def main(argv=None, made: Optional[dict] = None) -> dict:
    """Run one mode and print its JSON line; returns the line, with the
    picks of the timed engines under ``_picks`` (not printed).  ``made``:
    see :func:`synthetic_sweep`."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    log(f"device={dev} torch={torch.__version__}")
    if args.train:
        line = bench_train(args, train_config(args), dev)
    elif args.baseline:
        line = bench_baseline(args, baseline_config(args), dev)
    elif args.roi:
        line = bench_roi(args, roi_config(args), dev)
    else:
        trained = find_trained(args)
        line = bench_serving(args, serving_config(args, trained), dev,
                             trained, made)
    picks = line.pop("_picks", {})
    line.update(device_keys(dev))
    if picks:
        log(f"picks {json.dumps(picks)}")
    print(json.dumps(line), flush=True)
    return {**line, "_picks": picks}


if __name__ == "__main__":
    main()
