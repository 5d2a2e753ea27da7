"""Probe the baseline's PlainConvUNet on the card at the in-repo plan's full
width.

    python -m att_aspp_unet_tpu_torch.tools.probe_baseline [--seeds 0-7]
        [--frames 4] [--batch 128]

1. For each seed of the seeded initialisation (``models/plain_unet.py``
   ``init_weights``), the warm :class:`BaselineEngine` on ``--frames``
   frames of the synthetic sweep of seed 0: the voxel share of classes 1
   and 2 after the 0.5 threshold, their 6-connected 3-D components and the
   propagation iterations the labelling took, and the frame the container's
   ladder picks.  A seed whose classes are empty leaves the postprocess
   nothing to do; one whose class covers a third of the voxels makes a
   speckled, percolating component that takes many iterations.
2. One conv -> InstanceNorm -> LeakyReLU block of stage 0 (32 channels at
   448 x 576, ``--batch`` patches, bf16 channel-last): the conv with
   cuDNN's default algorithm choice and with ``cudnn.benchmark``, the
   block's norm and LeakyReLU through the port's kernels (as the block runs
   them on a card), through the plain ``InstanceNorm`` and through
   ``F.instance_norm``: milliseconds (CUDA events) and the largest
   difference of the kernels and of the plain module from
   ``F.instance_norm``.
"""

from __future__ import annotations

import argparse
import contextlib
import statistics
import time

import torch
import torch.nn.functional as F


def _seeds(spec: str):
    lo, _, hi = spec.partition("-")
    return range(int(lo), int(hi or lo) + 1)


def _ms(fn, reps: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


@contextlib.contextmanager
def count_iterations():
    """Within the block, the propagation iterations of every connected-
    component labelling, one entry per labelling (``postprocess/cc``)."""
    from ..postprocess import cc

    orig, iters = cc.fixed_point, []

    def counting(propagate, labels, max_iters):
        n = [0]

        def step(lab):
            n[0] += 1
            return propagate(lab)
        out = orig(step, labels, max_iters)
        iters.append(n[0])
        return out

    cc.fixed_point = counting
    try:
        yield iters
    finally:
        cc.fixed_point = orig


def thresholded_labels(probs: torch.Tensor) -> torch.Tensor:
    """(C, N, H, W) probabilities -> the argmax labels after the 0.5 soft
    threshold, before any component is dropped."""
    return torch.argmax(torch.where(probs < 0.5, torch.zeros(
        (), device=probs.device), probs), dim=0)


def probe_seeds(seeds, n_frames: int) -> None:
    from ..config import Config
    from ..infer.container import select_labeled_mask_and_frame
    from ..infer.engine import BaselineEngine
    from ..models.plain_unet import PlainConvUNet
    from ..postprocess import cc
    from ..postprocess.refine import postprocess_softmax_stack
    from .synthetic import make_sweep

    sweep, best, _ = make_sweep(140, 562, 744, seed=0)
    frames = sweep[best - n_frames // 2:best - n_frames // 2 + n_frames]
    cfg = Config()
    for seed in seeds:
        engine = BaselineEngine(
            cfg, PlainConvUNet.from_config(cfg.plain_unet, seed=seed))
        probs = engine.predict(frames)
        seg = thresholded_labels(probs)
        shares, comps = [], []
        for lab in (1, 2):
            fg = seg == lab
            shares.append(float(fg.float().mean()))
            comps.append(len(torch.unique(
                cc.label_components(fg, 6, ndim=3))) - 1)
        with count_iterations() as iters:
            t0 = time.perf_counter()
            out = postprocess_softmax_stack(probs, 0.5)
            torch.cuda.synchronize()
            t_post = time.perf_counter() - t0
        _, frame = select_labeled_mask_and_frame(out)
        print(f"[seeds] seed {seed}: class shares {shares[0]:.5f} / "
              f"{shares[1]:.5f}, 3-D components {comps[0]} / {comps[1]}, "
              f"propagation iterations {iters}, postprocess "
              f"{t_post:.3f} s, kept voxels "
              f"{int((out == 1).sum())} / {int((out == 2).sum())}, "
              f"frame {frame} of {n_frames}", flush=True)


def probe_norm(batch: int) -> None:
    from ..models.plain_unet import SLOPE, ConvNormAct
    from ..ops.kernels.swin_ops import instance_norm_act

    torch.manual_seed(0)
    blk = ConvNormAct(32, 32, 1, device="cuda", dtype=torch.bfloat16,
                      param_dtype=torch.float32)
    with torch.no_grad():
        blk.norm.weight.uniform_(0.5, 1.5)
        blk.norm.bias.normal_(0.0, 0.1)
    x = torch.randn(batch, 32, 448, 576, device="cuda").to(torch.bfloat16) \
        .contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        y = blk.conv(x)

        def kernels():
            return instance_norm_act(y, blk.norm, SLOPE)

        def plain():
            return F.leaky_relu_(blk.norm(y), SLOPE)

        def library():
            z = F.instance_norm(y, weight=blk.norm.weight,
                                bias=blk.norm.bias, eps=1e-5)
            return F.leaky_relu_(z, SLOPE)

        lib = library().float()
        err = [float((f().float() - lib).abs().max())
               for f in (kernels, plain)]
        conv_ms = _ms(lambda: blk.conv(x))
        torch.backends.cudnn.benchmark = True
        try:
            bench_ms = _ms(lambda: blk.conv(x))
        finally:
            torch.backends.cudnn.benchmark = False
        print(f"[norm] stage-0 block, {batch} x 32 x 448 x 576 bf16 "
              f"channel-last: conv {conv_ms:.3f} ms (cudnn.benchmark "
              f"{bench_ms:.3f} ms); InstanceNorm + LeakyReLU: the port's "
              f"kernels {_ms(kernels):.3f} ms, the plain module "
              f"{_ms(plain):.3f} ms, F.instance_norm {_ms(library):.3f} ms; "
              f"max |difference| from F.instance_norm: kernels "
              f"{err[0]:.4g}, plain {err[1]:.4g}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="probe_baseline")
    ap.add_argument("--seeds", default="0-7")
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--batch", type=int, default=128)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_baseline measures on a CUDA device")
    print(f"[env] {torch.cuda.get_device_name(0)}, torch {torch.__version__}")
    probe_norm(args.batch)
    probe_seeds(_seeds(args.seeds), args.frames)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
