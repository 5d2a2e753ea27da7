"""Host-side costs around the port's benchmark, on one card.

    python -m att_aspp_unet_tpu_torch.tools.probe_host [--blocks 4]

1. While two worker processes make the benchmark's synthetic inputs (the
   840-frame case and the four bulk sweeps, as chip_smoke makes them beside
   its later phases, each saved to a file): blocks of fixed-batch train
   steps and ``import torch`` subprocesses, against the same after the
   workers are done.
2. The train step (base_c 48, 512 x 512, batch 8, bf16) with its
   augmentation drawn on the host every step (``train_step(aug_params=None)``,
   as ``cli train`` and ``bench --train`` run it) against one reused draw
   (chip_smoke's fixed-batch steps), in alternating blocks; and
   ``sample_params`` alone.
3. The submit halves of the benchmark's cascade and direct engines on its
   840-frame case, bf16 and int8 (after the first case, which calibrates),
   with the case on the card and synchronising calls set to raise: when the
   call returned and when the device had finished.

Prints the card's name and power limit.  Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import multiprocessing
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import torch

from .. import bench
from ..config import Config, ModelConfig, PreprocessConfig, TrainConfig
from ..infer.engine import AttAsppEngine
from ..ops.kernels import _build
from ..train.augment import sample_params
from ..train.train_loop import create_train_state, train_step
from ..utils.npz_weights import load_npz_variables
from .synthetic import make_sweep

H, W = 562, 744
INPUTS = [(840, 1)] + [(140, 10 + s) for s in range(4)]


def _frames(n: int, seed: int, path: str) -> str:
    np.save(path, make_sweep(n, H, W, seed=seed)[0])
    return path


def _import_s() -> float:
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-c", "import torch; torch.cuda.init()"],
                   check=True)
    return time.perf_counter() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--blocks", type=int, default=4)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: the probe needs one GPU", file=sys.stderr)
        return 2
    _build.build_all()
    cfg = Config(preprocess=PreprocessConfig(img_size=512),
                 model=ModelConfig(base_c=48),
                 train=TrainConfig(batch_size=8))
    state = create_train_state(cfg.model, cfg.train, 100, "cuda")
    rng = np.random.default_rng(0)
    imgs = torch.as_tensor((rng.random((8, 512, 512)) * 255)
                           .astype(np.uint8)).cuda()
    msks = torch.zeros((8, 512, 512), dtype=torch.uint8, device="cuda")
    msks[:, 128:384, 128:384] = 255
    drawn = sample_params(torch.Generator().manual_seed(0), 8, 512, 512,
                          cfg.train.augment)

    def steps_ms(params, n=12) -> float:
        """Median ms per step of ``n`` steps after two warm-up steps."""
        times = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            train_step(state, cfg, imgs, msks, aug_params=params)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return round(1e3 * statistics.median(times[2:]), 2)

    # 1. the input workers beside train steps and imports
    with tempfile.TemporaryDirectory() as tmp, ProcessPoolExecutor(
            2, mp_context=multiprocessing.get_context("spawn")) as pool:
        futures = [pool.submit(_frames, n, s, f"{tmp}/{n}_{s}.npy")
                   for n, s in INPUTS]
        t0 = time.perf_counter()
        busy = []
        while not all(f.done() for f in futures):
            busy.append((steps_ms(drawn), round(_import_s(), 2)))
        case = np.load(futures[0].result())
        t_made = time.perf_counter() - t0
    idle = [(steps_ms(drawn), round(_import_s(), 2)) for _ in range(3)]
    print(f"[probe_host] (ms per fixed-batch step, s per import torch) with "
          f"two input workers busy ({t_made:.1f} s): {busy}; idle: {idle}")

    # 2. the augmentation drawn every step against one draw
    out = {"drawn every step": [], "one draw": []}
    for i in range(args.blocks):
        order = (None, drawn) if i % 2 == 0 else (drawn, None)
        for params in order:
            out["one draw" if params is drawn else "drawn every step"] \
                .append(steps_ms(params))
    t = []
    for s in range(10):
        t0 = time.perf_counter()
        sample_params(torch.Generator().manual_seed(s), 8, 512, 512,
                      cfg.train.augment)
        t.append(time.perf_counter() - t0)
    print(f"[probe_host] ms per train step: {out}; sample_params alone "
          f"{1e3 * statistics.median(t):.2f} ms")
    del state
    torch.cuda.empty_cache()

    # 3. the benchmark's submit halves with synchronising calls raising
    on_card = torch.as_tensor(case).cuda()
    for flags in ([], ["--int8"]):
        bargs = bench.parse_args(flags)
        trained = bench.find_trained(bargs)
        scfg = bench.serving_config(bargs, trained)
        variables = load_npz_variables(trained.weights)
        for cascade in (True, False):
            engine = AttAsppEngine(dataclasses.replace(
                scfg, predict=dataclasses.replace(scfg.predict,
                                                  cascade=cascade)),
                variables)
            engine.predict_case(on_card, bench.SPACING, trained.thr)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                t0 = time.perf_counter()
                handle = engine.predict_case_submit(on_card, trained.thr)
                t1 = time.perf_counter()
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            frame = engine.predict_case_collect(handle, bench.SPACING)[0]
            print(f"[probe_host] submit {flags or ['bf16']} cascade="
                  f"{cascade}: returned after {t1 - t0:.3f} s, the device "
                  f"finished after {t2 - t0:.3f} s; frame {frame}; collects "
                  f"repeated with the exact loops: {engine.exact_repeats}")
            del engine
            torch.cuda.empty_cache()
    keys = bench.device_keys(torch.device("cuda"))
    print(f"[probe_host] {keys['device']}, {keys['power_limit']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
