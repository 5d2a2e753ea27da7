"""Command line of the port.

Every subcommand takes the model flags of the JAX package's CLI: ``--base_c``,
``--gate v1|v2``, ``--no_att``, ``--no_aspp``, ``--att_depth`` and
``--deterministic`` (reseeds the RNGs, cuDNN picks deterministic
algorithms), plus ``--device`` (default ``cuda``; ``cpu`` runs the plain
PyTorch versions of the kernels).  Weights of the Attention-ASPP-UNet are
the JAX package's flat ``.npz`` archives, a checkpoint that ``train`` wrote
(``ckpt_main/best``, ...) or a reference PyTorch ``.pt`` / ``.pth`` state
dict (imported non-strictly, with the missing and unexpected key counts
printed).

``python -m att_aspp_unet_tpu_torch.cli predict`` predicts a directory of
PNG / JPG frames and ``.mha`` sweeps with the JAX package's ``predict``
flags (``--weights``, ``--input_dir``, ``--out_dir``, ``--thr``,
``--no_tta``, ``--spacing_json``, ``--cascade``, ``--bulk N``, the
``--scout_*`` flags, ``--slice_metrics``, ``--topk_viz``, ``--viz_att``,
``--weights_noatt``).  hflip TTA is on unless ``--no_tta``, as in the
reference predict CLI.

``python -m att_aspp_unet_tpu_torch.cli calibrate`` scans thresholds over
``<val_dir>/images/*.png`` against ``<val_dir>/masks`` and writes
``<output_dir>/thr.json`` (``--ci``: the per-threshold CI tables and plots);
hflip TTA is on unless ``--no-tta``.

``python -m att_aspp_unet_tpu_torch.cli train`` trains the model on
``<train_dir>/images`` + ``masks`` (``--neg_dir``, ``--val_dir``, else a
positive-only 10 % val split) with the JAX package's flags: ``--stage
main|finetune`` (``--pretrained``), ``--epochs``, ``--batch_size``, ``--lr``,
``--differential_lr``, ``--img_size``, ``--no_clahe``, ``--edge_w`` /
``--no_edge_loss``, ``--neg_bce_w``, ``--seed``, ``--export_npz``.  It writes
``<output_dir>/ckpt_main`` (or ``ckpt_finetune``) with ``best``, ``last`` and
``metrics.csv``, resumes from ``last``, and writes ``summary.json`` (and with
``--export_npz`` the flat f16 ``weights.npz`` that ``predict --weights`` and
``--scout_weights`` read).  The JAX CLI's TPU-only ``--lowering`` is not
taken.

``python -m att_aspp_unet_tpu_torch.cli infer-container`` runs the
Grand-Challenge container contract on one case (``MODEL_TAG`` and ``CASE_ID``
of the environment override ``--model-tag`` and ``--case-id``).  The default
model is ``baseline``, the nnU-Net-style PlainConvUNet: its architecture
comes from ``--plans`` / ``--dataset-json`` (nnU-Net's ``plans.json`` and
``dataset.json``), its weights from an nnU-Net ``.pth`` / ``.pt`` checkpoint
or the JAX package's flat ``.npz``; without ``--weights`` it runs on the
initialisation of seed 0, to exercise the contract.  ``att_aspp`` needs
``--weights``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from pathlib import Path

from .config import (CalibrateConfig, Config, ContainerConfig, LossConfig,
                     ModelConfig, PredictConfig, TrainConfig)


def _config(args, **parts) -> Config:
    """The configuration of the model flags (and ``parts``); with
    ``--deterministic`` the RNGs are reseeded (``--seed``, default 2025)."""
    if args.deterministic:
        from .utils.seeding import set_seed
        set_seed(getattr(args, "seed", 2025))
    model = ModelConfig(base_c=args.base_c, use_att=not args.no_att,
                        use_aspp=not args.no_aspp, att_depth=args.att_depth,
                        gate_variant=args.gate)
    return Config(model=model, **parts)


def load_variables(path, cfg: ModelConfig) -> dict:
    """The JAX-layout variables of the Attention-ASPP-UNet ``cfg`` from a
    flat ``.npz`` archive, a checkpoint of this package's ``train`` or a
    reference ``.pt`` / ``.pth`` state dict (into the seeded
    ``init_variables(cfg, 0)`` template, non-strict)."""
    weights = Path(path)
    if weights.is_dir():
        raise SystemExit(f"{weights}: a checkpoint directory (the JAX "
                         "package's Orbax format) is not read here; export "
                         "it with the JAX package's train --export_npz and "
                         "pass the weights.npz")
    if not weights.exists():
        raise SystemExit(f"weights not found: {weights}")
    if weights.suffix == ".npz":
        from .utils.npz_weights import load_npz_variables
        return load_npz_variables(weights)
    if weights.suffix in (".pt", ".pth"):
        from .utils.convert import init_variables
        from .utils.torch_import import load_torch_checkpoint
        return load_torch_checkpoint(weights, cfg, init_variables(cfg, 0))
    from .train.train_loop import read_checkpoint
    from .utils.convert import checkpoint_variables
    try:
        return checkpoint_variables(read_checkpoint(weights)["model"], cfg)
    except ValueError as err:
        raise SystemExit(f"{weights}: expected a flat .npz archive, a "
                         "checkpoint of this package's train or a PyTorch "
                         f".pt / .pth state dict ({err})") from None


def _load_baseline(weights, cfg: Config):
    """The baseline's PlainConvUNet on the CPU: from an nnU-Net checkpoint
    (``.pth`` / ``.pt``), from the JAX package's flat ``.npz``, or, without
    weights, from the initialisation of seed 0."""
    from .models.plain_unet import PlainConvUNet

    if weights is None:
        print("[warn] no --weights given: using random init (smoke mode)")
        return PlainConvUNet.from_config(cfg.plain_unet, seed=0)
    path = Path(weights)
    if not path.exists():
        raise SystemExit(f"weights not found: {path}")
    if path.suffix in (".pth", ".pt"):
        from .utils.nnunet_import import load_nnunet_checkpoint
        return load_nnunet_checkpoint(path, cfg.plain_unet)
    if path.suffix == ".npz":
        from .utils.convert import jax_plain_unet_to_torch
        from .utils.npz_weights import load_npz_variables
        return jax_plain_unet_to_torch(load_npz_variables(path),
                                       cfg.plain_unet)
    raise SystemExit(f"--weights {path}: expected an nnU-Net .pth / .pt "
                     "checkpoint or a flat .npz archive")


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
    cfg = _config(args, predict=PredictConfig(
        tta_hflip=not args.no_tta, cascade=args.cascade,
        cascade_scout_weights=args.scout_weights,
        cascade_scout_base_c=args.scout_base_c,
        cascade_scout_thr=args.scout_thr,
        cascade_scout_clahe=False if args.scout_no_clahe else None,
        cascade_scout_rank=args.scout_rank))
    noatt = None
    if args.weights_noatt:
        # the comparison model of the attention panels: gate-free with
        # att_depth 0, the same width and bridge
        na_cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, use_att=False, att_depth=0))
        noatt = (na_cfg, load_variables(args.weights_noatt, na_cfg.model))
    predict_directory(cfg, load_variables(args.weights, cfg.model),
                      Path(args.input_dir), Path(args.out_dir),
                      spacing_json=(Path(args.spacing_json)
                                    if args.spacing_json else None),
                      threshold=args.thr, slice_metrics=args.slice_metrics,
                      topk_viz=args.topk_viz, viz_att=args.viz_att,
                      noatt=noatt, bulk_group=args.bulk, device=args.device)
    return 0


def cmd_calibrate(args) -> int:
    from .infer.calibrate import calibrate

    cfg = _config(args, predict=PredictConfig(tta_hflip=not args.no_tta),
                  calibrate=CalibrateConfig(with_ci=args.ci))
    calibrate(cfg, load_variables(args.weights, cfg.model),
              Path(args.val_dir), Path(args.output_dir), device=args.device)
    return 0


def cmd_infer_container(args) -> int:
    from .infer.container import run_from_env

    cfg = _config(args, container=ContainerConfig(
                     input_path=args.input, output_path=args.output,
                     model_tag=args.model_tag, case_id=args.case_id))
    if args.plans:
        from .utils.nnunet_import import load_plans_config
        cfg = dataclasses.replace(cfg, plain_unet=load_plans_config(
            Path(args.plans), dataset_json=(Path(args.dataset_json)
                                            if args.dataset_json else None),
            base=cfg.plain_unet))
    # the weights are read for the model that will serve, which MODEL_TAG
    # of the environment may choose over --model-tag
    if os.getenv("MODEL_TAG", args.model_tag) == "baseline":
        model = _load_baseline(args.weights, cfg)
    elif args.weights is None:
        raise SystemExit("the att_aspp model needs --weights (a flat .npz or "
                         "a .pt / .pth state dict)")
    else:
        model = load_variables(args.weights, cfg.model)
    return run_from_env(cfg, model, device=args.device,
                        save_probabilities=not args.no_save_probabilities,
                        debug_frames=not args.no_debug_frames)


def cmd_train(args) -> int:
    from .io import write_json
    from .train.data import (ArrayDataset, collect_pairs,
                             positive_only_val_split)
    from .train.train_loop import fit, read_checkpoint
    from .utils.convert import checkpoint_variables
    from .utils.npz_weights import save_npz_variables

    if args.stage == "finetune" and not args.pretrained:
        raise SystemExit("--pretrained required for --stage finetune")
    no_clahe = bool(args.no_clahe)
    cfg = _config(args, train=TrainConfig(
        seed=args.seed, stage=args.stage, batch_size=args.batch_size,
        epochs=args.epochs, lr=args.lr,
        differential_lr=args.differential_lr,
        loss=LossConfig(edge_weight=0.0 if args.no_edge_loss else args.edge_w,
                        neg_bce_weight=args.neg_bce_w)))
    # scout distillation: a lower --img_size and a CLAHE-free enhance chain,
    # recorded in summary.json so that serving adopts them
    cfg = dataclasses.replace(
        cfg,
        preprocess=dataclasses.replace(
            cfg.preprocess, img_size=args.img_size,
            clahe_clip=0.0 if no_clahe else cfg.preprocess.clahe_clip),
        train=dataclasses.replace(cfg.train, augment=dataclasses.replace(
            cfg.train.augment, use_clahe=not no_clahe)))
    imgs, msks = collect_pairs(Path(args.train_dir) / "images",
                               Path(args.train_dir) / "masks")
    if args.neg_dir:
        neg_imgs, _ = collect_pairs(Path(args.neg_dir) / "images", None)
        imgs += neg_imgs
        msks += [None] * len(neg_imgs)
    pos = sum(m is not None for m in msks)
    print(f"Train samples: pos={pos}, neg={len(msks) - pos}")
    if args.val_dir:
        val_imgs, val_msks = collect_pairs(Path(args.val_dir) / "images",
                                           Path(args.val_dir) / "masks")
        tr_pair = (imgs, msks)
    else:
        tr_pair, (val_imgs, val_msks) = positive_only_val_split(
            imgs, msks, cfg.train.seed, cfg.train.val_frac)
    S = cfg.preprocess.img_size
    train_ds = ArrayDataset.from_paths(*tr_pair, S)
    val_ds = ArrayDataset.from_paths(val_imgs, val_msks, S)

    init_variables = None
    if args.stage == "finetune":
        init_variables = load_variables(args.pretrained, cfg.model)
        print(f"loaded pretrained {args.pretrained}")

    out = fit(cfg, train_ds, val_ds, Path(args.output_dir),
              init_variables=init_variables, device=args.device)
    print(f"best Dice {out['best_dice']:.4f} → {out['best_path']}")

    out_root = Path(args.output_dir)
    if args.export_npz:
        # compact f16 weights next to summary.json: the layout predict
        # --weights and --scout_weights read
        best = Path(out["best_path"])
        if not best.exists():
            raise SystemExit(f"no best checkpoint at {best} to export")
        save_npz_variables(checkpoint_variables(
            read_checkpoint(best)["model"], cfg.model),
            out_root / "weights.npz")
        print(f"exported {out_root / 'weights.npz'}")
    # provenance + the serving knobs that the engine adopts from the
    # summary.json next to a scout's weights (img_size, use_clahe, base_c)
    write_json(out_root / "summary.json", {
        "best_val_dice": out["best_dice"],
        "epochs_run": out["epochs_run"],
        "img_size": S,
        "base_c": cfg.model.base_c,
        "use_clahe": not no_clahe,
        "stage": cfg.train.stage,
    }, indent=2)
    return 0


def _common_flags(ap) -> None:
    """The model flags and ``--device``."""
    ap.add_argument("--base_c", type=int, default=48)
    ap.add_argument("--no_att", action="store_true",
                    help="no attention gates")
    ap.add_argument("--no_aspp", action="store_true",
                    help="a single ConvBNReLU bridge instead of the ASPP")
    ap.add_argument("--att_depth", type=int, default=4,
                    help="v2 gates on u4 (>= 4) and u3 (>= 3)")
    ap.add_argument("--gate", choices=["v1", "v2"], default="v1")
    ap.add_argument("--deterministic", action="store_true",
                    help="reseed the RNGs (with train's --seed, else 2025) "
                         "and make cuDNN pick deterministic algorithms")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch versions of the kernels)")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="att_aspp_unet_tpu_torch")
    sp = ap.add_subparsers(dest="cmd", required=True)
    pr = sp.add_parser("predict", help="predict a directory of PNG / JPG "
                       "frames and .mha sweeps")
    pr.add_argument("--weights", required=True)
    pr.add_argument("--input_dir", required=True)
    pr.add_argument("--out_dir", default="./preds")
    pr.add_argument("--spacing_json")
    pr.add_argument("--thr", type=float)
    pr.add_argument("--no_tta", "--no-tta", dest="no_tta", action="store_true",
                    help="disable hflip TTA")
    pr.add_argument("--slice_metrics", action="store_true",
                    help="per .mha sweep: refine every frame and write the "
                         "per-slice area / circularity CSV")
    pr.add_argument("--topk_viz", action="store_true",
                    help="per .mha sweep: refine every frame and write the "
                         "top-K candidate sheet")
    pr.add_argument("--viz_att", action="store_true",
                    help="write per-PNG attention panels (raw | prob | mean "
                         "psi | mask) to <out>/panels")
    pr.add_argument("--weights_noatt",
                    help="no-attention checkpoint for the panel's second row "
                         "(--viz_att)")
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
    _common_flags(pr)
    pr.set_defaults(fn=cmd_predict)

    ca = sp.add_parser("calibrate", help="pick the threshold of best mean "
                       "Dice over a val set of PNGs")
    ca.add_argument("--weights", required=True)
    ca.add_argument("--val_dir", required=True,
                    help="holds images/*.png and masks/*.png of the same names")
    ca.add_argument("--output_dir", default="./checkpoints")
    ca.add_argument("--ci", action="store_true",
                    help="also write the per-threshold statistics with a "
                         "t-distribution 95 %% CI and plots")
    ca.add_argument("--no_tta", "--no-tta", dest="no_tta", action="store_true",
                    help="disable hflip TTA")
    _common_flags(ca)
    ca.set_defaults(fn=cmd_calibrate)

    tr = sp.add_parser("train", help="train the model on a directory of "
                       "PNG images and masks")
    tr.add_argument("--stage", choices=["main", "finetune"], default="main")
    tr.add_argument("--seed", type=int, default=2025)
    tr.add_argument("--train_dir", required=True,
                    help="holds images/ and masks/ (same file names)")
    tr.add_argument("--neg_dir", help="holds images/ of negatives (no mask)")
    tr.add_argument("--val_dir", help="holds images/ and masks/; default: a "
                    "positive-only 10 %% split of the training pairs")
    tr.add_argument("--output_dir", default="./checkpoints")
    tr.add_argument("--pretrained", help="weights to finetune (a flat .npz, "
                    "a checkpoint of train, or a .pt / .pth state dict)")
    tr.add_argument("--epochs", type=int, default=120)
    tr.add_argument("--batch_size", type=int, default=8)
    tr.add_argument("--lr", type=float, default=3e-4)
    tr.add_argument("--edge_w", type=float, default=0.05)
    tr.add_argument("--no_edge_loss", action="store_true",
                    help="drop the Sobel edge-loss term (same as --edge_w 0)")
    tr.add_argument("--neg_bce_w", type=float, default=0.05)
    tr.add_argument("--differential_lr", action="store_true",
                    help="attention parameters at lr, the backbone at 0.5 lr")
    tr.add_argument("--img_size", type=int, default=512,
                    help="network input resolution; lower it to distill a "
                         "cascade scout (serving reads it from summary.json)")
    tr.add_argument("--no_clahe", action="store_true",
                    help="train on a CLAHE-free enhance chain (recorded in "
                         "summary.json; a scout trained so skips CLAHE)")
    tr.add_argument("--export_npz", action="store_true",
                    help="after training, export the best checkpoint as the "
                         "flat f16 weights.npz in --output_dir")
    _common_flags(tr)
    tr.set_defaults(fn=cmd_train)

    ic = sp.add_parser("infer-container",
                       help="the Grand-Challenge container contract on the "
                            "case under --input")
    ic.add_argument("--input", default="./test/input")
    ic.add_argument("--output", default="./test/output")
    ic.add_argument("--model-tag", default="baseline",
                    choices=["baseline", "att_aspp"])
    ic.add_argument("--case-id", default="output")
    ic.add_argument("--weights",
                    help="baseline: nnU-Net .pth / .pt checkpoint or flat "
                         ".npz (default: the initialisation of seed 0); "
                         "att_aspp: flat .npz or .pt / .pth (required)")
    ic.add_argument("--plans", help="nnU-Net plans.json for the baseline "
                    "model architecture")
    ic.add_argument("--dataset-json", help="nnU-Net dataset.json "
                    "(num_classes / in_channels)")
    ic.add_argument("--no-save-probabilities", action="store_true",
                    help="do not dump the probability stack to "
                         "output/probabilities/<sweep>_prob.npy")
    ic.add_argument("--no-debug-frames", action="store_true",
                    help="do not write three frames as raw and enhanced "
                         "PNGs (writing them needs PIL)")
    _common_flags(ic)
    ic.set_defaults(fn=cmd_infer_container)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
