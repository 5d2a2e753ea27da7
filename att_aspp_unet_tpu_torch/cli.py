"""Command line of the port.

``python -m att_aspp_unet_tpu_torch.cli predict`` takes the JAX package's
``predict`` flags for ``.mha`` sweeps (``--weights`` npz, ``--input_dir``,
``--out_dir``, ``--thr``, ``--no_tta``, ``--base_c``, ``--spacing_json``,
``--cascade``, ``--bulk N`` and the ``--scout_*`` flags) plus ``--device``
(default ``cuda``).  hflip TTA is on unless ``--no_tta``, as in the
reference predict CLI.

``python -m att_aspp_unet_tpu_torch.cli infer-container`` runs the
Grand-Challenge container contract on one case (``MODEL_TAG`` and ``CASE_ID``
of the environment override ``--model-tag`` and ``--case-id``).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from .config import Config, ContainerConfig, ModelConfig, PredictConfig


def _load_npz(path) -> dict:
    from .utils.npz_weights import load_npz_variables

    weights = Path(path)
    if weights.suffix != ".npz":
        raise SystemExit(f"--weights {weights}: this port reads flat-npz "
                         "archives only (.pt import is not ported yet)")
    if not weights.exists():
        raise SystemExit(f"weights not found: {weights}")
    return load_npz_variables(weights)


def cmd_predict(args) -> int:
    from .infer.predict_cli import predict_directory

    if args.bulk == 1 or args.bulk < 0:
        # 1 would silently serve the per-case path while the user believes
        # groups are active
        raise SystemExit("--bulk takes a group size >= 2 (or 0 to disable)")
    if not args.cascade:
        # the scout flags only affect the cascade's tier-1 ranking; without
        # --cascade they would be silently ignored
        for flag in ("scout_weights", "scout_thr", "scout_base_c",
                     "scout_no_clahe"):
            if getattr(args, flag):
                raise SystemExit(f"--{flag} requires --cascade")
        if args.scout_rank != "refined":
            raise SystemExit("--scout_rank requires --cascade")
        if args.bulk:
            raise SystemExit("--bulk requires --cascade")
    cfg = Config(model=ModelConfig(base_c=args.base_c),
                 predict=PredictConfig(
                     tta_hflip=not args.no_tta, cascade=args.cascade,
                     cascade_scout_weights=args.scout_weights,
                     cascade_scout_base_c=args.scout_base_c,
                     cascade_scout_thr=args.scout_thr,
                     cascade_scout_clahe=(False if args.scout_no_clahe
                                          else None),
                     cascade_scout_rank=args.scout_rank))
    predict_directory(cfg, _load_npz(args.weights), Path(args.input_dir),
                      Path(args.out_dir),
                      spacing_json=(Path(args.spacing_json)
                                    if args.spacing_json else None),
                      threshold=args.thr, bulk_group=args.bulk,
                      device=args.device)
    return 0


def cmd_infer_container(args) -> int:
    from .infer.container import run_from_env

    cfg = Config(model=ModelConfig(base_c=args.base_c),
                 container=ContainerConfig(
                     input_path=args.input, output_path=args.output,
                     model_tag=args.model_tag, case_id=args.case_id))
    return run_from_env(cfg, _load_npz(args.weights), device=args.device,
                        save_probabilities=not args.no_save_probabilities,
                        debug_frames=not args.no_debug_frames)


def _device_flag(ap) -> None:
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch versions of the kernels)")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="att_aspp_unet_tpu_torch")
    sp = ap.add_subparsers(dest="cmd", required=True)
    pr = sp.add_parser("predict", help="predict a directory of .mha sweeps")
    pr.add_argument("--weights", required=True)
    pr.add_argument("--input_dir", required=True)
    pr.add_argument("--out_dir", default="./preds")
    pr.add_argument("--spacing_json")
    pr.add_argument("--thr", type=float)
    pr.add_argument("--no_tta", "--no-tta", dest="no_tta", action="store_true",
                    help="disable hflip TTA")
    pr.add_argument("--base_c", type=int, default=48)
    pr.add_argument("--cascade", action="store_true",
                    help="two-tier sweep serving: scout all frames at low "
                         "resolution, full-resolution forward only on the "
                         "top candidates")
    pr.add_argument("--bulk", type=int, default=0,
                    help="group up to N consecutive same-shape .mha cases "
                         "into one bulk cascade; requires --cascade; outputs "
                         "equal per-case serving")
    pr.add_argument("--scout_weights", default=None,
                    help="npz checkpoint of a distilled scout for the "
                         "cascade's tier-1 ranking forward (served masks "
                         "always come from the main model); e.g. "
                         "resources/synthetic_scout_noclahe128/weights.npz")
    pr.add_argument("--scout_base_c", type=int, default=None,
                    help="scout width; default reads base_c from the "
                         "summary.json next to --scout_weights (fallback 16)")
    pr.add_argument("--scout_thr", type=float, default=0.0,
                    help="scout's rank threshold (0 = from the thr.json next "
                         "to --scout_weights, else the main threshold)")
    pr.add_argument("--scout_no_clahe", action="store_true",
                    help="skip CLAHE in the scout tier's preprocessing; "
                         "usually unnecessary: use_clahe is read from the "
                         "summary.json next to the weights")
    pr.add_argument("--scout_rank", default="refined",
                    choices=("refined", "closed"),
                    help="tier-1 rank key: refined-area proxy (default) or "
                         "closed area only")
    _device_flag(pr)
    pr.set_defaults(fn=cmd_predict)

    ic = sp.add_parser("infer-container",
                       help="the Grand-Challenge container contract on the "
                            "case under --input")
    ic.add_argument("--input", default="./test/input")
    ic.add_argument("--output", default="./test/output")
    ic.add_argument("--model-tag", default="baseline",
                    choices=["baseline", "att_aspp"])
    ic.add_argument("--case-id", default="output")
    ic.add_argument("--weights", required=True)
    ic.add_argument("--base_c", type=int, default=48)
    ic.add_argument("--no-save-probabilities", action="store_true",
                    help="do not dump the ROI probability stack to "
                         "output/probabilities/<sweep>_prob.npy")
    ic.add_argument("--no-debug-frames", action="store_true",
                    help="do not write three frames as raw and enhanced "
                         "PNGs (writing them needs PIL)")
    _device_flag(ic)
    ic.set_defaults(fn=cmd_infer_container)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
