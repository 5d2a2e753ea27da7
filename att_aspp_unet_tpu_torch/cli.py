"""Command line of the port: ``python -m att_aspp_unet_tpu_torch.cli predict``.

Takes the JAX package's ``predict`` flags for the direct ``.mha`` path
(``--weights`` npz, ``--input_dir``, ``--out_dir``, ``--thr``, ``--no_tta``,
``--base_c``, ``--spacing_json``) plus ``--device`` (default ``cuda``).
hflip TTA is on unless ``--no_tta``, as in the reference predict CLI.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from .config import Config, ModelConfig, PredictConfig


def cmd_predict(args) -> int:
    from .infer.predict_cli import predict_directory
    from .utils.npz_weights import load_npz_variables

    weights = Path(args.weights)
    if weights.suffix != ".npz":
        raise SystemExit(f"--weights {weights}: this port reads flat-npz "
                         "archives only (.pt import is not ported yet)")
    if not weights.exists():
        raise SystemExit(f"weights not found: {weights}")
    cfg = Config(model=ModelConfig(base_c=args.base_c),
                 predict=PredictConfig(tta_hflip=not args.no_tta))
    predict_directory(cfg, load_npz_variables(weights), Path(args.input_dir),
                      Path(args.out_dir),
                      spacing_json=(Path(args.spacing_json)
                                    if args.spacing_json else None),
                      threshold=args.thr, device=args.device)
    return 0


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
    pr.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch versions of the kernels)")
    pr.set_defaults(fn=cmd_predict)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
