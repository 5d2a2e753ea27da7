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
``--weights_noatt``, ``--int8``).  hflip TTA is on unless ``--no_tta``, as
in the reference predict CLI.  ``--int8`` (``predict`` and
``infer-container``) serves the 3x3 ConvBNReLU convs post-training-quantized
to int8 (``nn/quant.py``, kernel K3), calibrated on the first sweep.

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
``--scout_weights`` read).  As the JAX CLI shards the batch over every
device, ``--device cuda`` trains on every visible card that the batch size
admits (``parallel.make_mesh_for_batch``), one process per card in an NCCL
group, and computes what one card would; ``--device cpu`` is one process.
The JAX CLI's TPU-only ``--lowering`` is not taken.

``python -m att_aspp_unet_tpu_torch.cli infer-container`` runs the
Grand-Challenge container contract on one case (``MODEL_TAG`` and ``CASE_ID``
of the environment override ``--model-tag`` and ``--case-id``), with the
models and weights of ``infer/models.py``'s table.  The default model is
``baseline``, the nnU-Net-style PlainConvUNet, its architecture from
``--plans`` / ``--dataset-json`` (nnU-Net's ``plans.json`` and
``dataset.json``); without ``--weights`` the labeled networks run on the
initialisation of seed 0, to exercise the contract, and ``att_aspp``
exits.  ``python -m att_aspp_unet_tpu_torch.inference`` runs the same
contract driven by the environment alone (``WEIGHTS``, ``MODEL_TAG``,
``PLANS``, ``DATASET_JSON``, ``CASE_ID``, ``DEVICE``).

The offline tools take the JAX package's flags, defaults and exit codes and
need no card: ``eval-seg`` (Dice / IoU / HD95 of a new and a baseline model
against GT masks, ``seg_eval.csv``), ``eval-ac`` (AC agreement of two
``ac_results.csv`` with a per-sweep GT table; ``--fps`` frames per sweep),
``vis-errors`` (overlays of the worst ΔDice cases), ``convert`` (``.mha``
volume pairs to PNG frames with negative sampling), ``split`` (seeded
train / val split), ``leak-check`` (exit 1 when a file is in both sets) and
``dataset-report`` (split statistics, LaTeX table).  Their figures need
matplotlib; without it each figure is skipped with a ``[warn]`` line and the
tables are written all the same.

``python -m att_aspp_unet_tpu_torch.cli warm`` prepares a deployment so
that its first case pays no build: it builds the CUDA kernels
(``_build.KERNEL_SOURCES``; ``nvcc``, on a card) and the host ops
(``g++``) into the package's build directory, then serves one all-zero
sweep per ``--shapes`` entry through ``predict_case`` (and a ``--bulk N``
group) with the JAX package's flags.
The JAX package's ``--export-aot``, ``--roi``, ``--c1_pad`` and
``--lowering`` (XLA executables and TPU-only lowerings) are refused.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

from .config import (CalibrateConfig, Config, ContainerConfig, LossConfig,
                     ModelConfig, PredictConfig, PreprocessConfig,
                     TrainConfig)
from .infer.models import SERVED, entry_config, load_model, load_variables


def _config(args, **parts) -> Config:
    """The configuration of the model flags (and ``parts``); with
    ``--deterministic`` the RNGs are reseeded (``--seed``, default 2025);
    ``--int8`` serves the int8 path."""
    if args.deterministic:
        from .utils.seeding import set_seed
        set_seed(getattr(args, "seed", 2025))
    model = ModelConfig(base_c=args.base_c, use_att=not args.no_att,
                        use_aspp=not args.no_aspp, att_depth=args.att_depth,
                        gate_variant=args.gate,
                        conv_lowering=("int8" if getattr(args, "int8", False)
                                       else "direct"))
    return Config(model=model, **parts)


def _serving_predict_config(args, tta: bool) -> PredictConfig:
    """The ``PredictConfig`` of the serving flags (``--cascade``, ``--bulk``
    and the ``--scout_*`` flags), refusing combinations that would be
    silently ignored."""
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
    return PredictConfig(
        tta_hflip=tta, cascade=args.cascade,
        cascade_scout_weights=args.scout_weights,
        cascade_scout_base_c=args.scout_base_c,
        cascade_scout_thr=args.scout_thr,
        cascade_scout_clahe=False if args.scout_no_clahe else None,
        cascade_scout_rank=args.scout_rank)


def cmd_predict(args) -> int:
    from .infer.predict_cli import predict_directory

    cfg = _config(args, predict=_serving_predict_config(args,
                                                        not args.no_tta))
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


# The JAX CLI's warm flags that the port does not take, with the reason.
WARM_REFUSED = {
    "--export-aot": "serializes XLA executables; the port runs eagerly and "
                    "has none (ROADMAP item 10)",
    "--roi": "only chooses what --export-aot serializes",
    "--c1_pad": "a TPU-only channel padding (ROADMAP item 10)",
    "--lowering": "TPU-only lowerings (ROADMAP item 10); --int8 is the int8 "
                  "path",
}


def cmd_warm(args) -> int:
    """Build what a deployment's first case would otherwise build, then
    serve one all-zero sweep per declared shape (and a ``--bulk`` group)."""
    import time

    import numpy as np

    from .device import resolve_device
    from .infer.engine import AttAsppEngine
    from .infer.predict_cli import load_threshold
    from .ops.kernels import _build
    from .utils import native

    for flag, why in WARM_REFUSED.items():
        if getattr(args, flag.lstrip("-").replace("-", "_")):
            raise SystemExit(f"{flag} is not taken: {why}")
    cfg = _config(args, preprocess=PreprocessConfig(img_size=args.img_size),
                  predict=_serving_predict_config(args, bool(args.tta)))
    device = resolve_device(args.device)
    if device.type == "cuda":
        t0 = time.perf_counter()
        built = _build.build_all()
        print(f"[warm] kernels {', '.join(_build.KERNEL_SOURCES)}: built "
              f"{sorted(built) or 'none'} in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    ok = native.available()
    print(f"[warm] host ops: {'ready' if ok else 'unavailable'} in "
          f"{time.perf_counter() - t0:.1f}s")
    if args.weights:
        variables = load_variables(args.weights, cfg.model)
    else:
        from .utils.convert import init_variables
        variables = init_variables(cfg.model, 0)
    engine = AttAsppEngine(cfg, variables, device=device)
    # the threshold a deployment serves: --thr, else thr.json, else the
    # configured one (as predict resolves it)
    thr = (float(args.thr) if args.thr is not None
           else load_threshold(cfg, Path(args.thr_json)))
    for spec in args.shapes.split(","):
        n, h, w = (int(t) for t in spec.lower().split("x"))
        t0 = time.perf_counter()
        engine.predict_case(np.zeros((n, h, w), np.uint8), (0.28, 0.28),
                            threshold=thr)
        print(f"[warm] {spec}: thr {thr:.3f} ran in "
              f"{time.perf_counter() - t0:.1f}s")
        if args.bulk > 1:
            t0 = time.perf_counter()
            engine.predict_bulk(np.zeros((args.bulk, n, h, w), np.uint8),
                                (0.28, 0.28), threshold=thr)
            print(f"[warm] bulk {args.bulk}x{spec}: thr {thr:.3f} ran in "
                  f"{time.perf_counter() - t0:.1f}s")
    return 0


def cmd_calibrate(args) -> int:
    from .infer.calibrate import calibrate

    cfg = _config(args, predict=PredictConfig(tta_hflip=not args.no_tta),
                  calibrate=CalibrateConfig(with_ci=args.ci))
    calibrate(cfg, load_variables(args.weights, cfg.model),
              Path(args.val_dir), Path(args.output_dir), device=args.device)
    return 0


def cmd_infer_container(args) -> int:
    from .infer.container import run

    # the weights are read for the tag that serves, MODEL_TAG's if it is set
    cfg = entry_config(_config(args, container=ContainerConfig(
        input_path=args.input, output_path=args.output,
        model_tag=args.model_tag, case_id=args.case_id)),
        args.plans, args.dataset_json)
    model = load_model(cfg.container.model_tag, args.weights, cfg)
    return run(cfg, model, device=args.device,
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


def cmd_eval_seg(args) -> int:
    from .evals.seg_metrics import evaluate_directories

    evaluate_directories(Path(args.gt), Path(args.base), Path(args.new),
                         out_csv=Path(args.out_csv),
                         new_suffix=args.new_suffix,
                         plot_dir=Path(args.plot_dir) if args.plot else None)
    return 0


def cmd_eval_ac(args) -> int:
    from .evals.ac_analysis import analyze_ac

    analyze_ac(args.gt, args.baseline, args.new, args.out,
               frames_per_sweep=args.fps)
    return 0


def cmd_vis_errors(args) -> int:
    from .evals.visualize import render_worst_cases

    render_worst_cases(Path(args.csv), Path(args.gt), Path(args.base),
                       Path(args.new), Path(args.out),
                       img_dir=Path(args.images) if args.images else None,
                       top=args.top, alpha=args.alpha, edge=args.edge)
    return 0


def cmd_convert(args) -> int:
    from .tools.convert import convert_frames_with_negatives

    convert_frames_with_negatives(
        args.mha_root, args.out_root, topk=args.topk,
        neighbor_pad=args.neighbor_pad, min_area_mm2=args.min_area_mm2,
        min_area_px=args.min_area_px, neg_strategy=args.neg_strategy,
        neg_ratio=args.neg_ratio, neg_cap=args.neg_cap,
        neg_stride=args.neg_stride, seed=args.seed,
        export_neg_only=args.export_neg_only,
        neg_total_cap=args.neg_total_cap)
    return 0


def cmd_split(args) -> int:
    from .tools.split import split_train_val

    split_train_val(args.raw_root, args.out_root, args.train_frac, args.seed)
    return 0


def cmd_leak_check(args) -> int:
    from .tools.leak_check import check_split_leak

    res = check_split_leak(args.train, args.val, args.out,
                           recursive=args.recursive, by_stem=args.by_stem)
    return 1 if res["present"] else 0


def cmd_dataset_report(args) -> int:
    from .evals.reports import (load_flat_images_masks, load_from_directory,
                                load_from_frame_index, make_dataset_reports)

    if args.frame_index:
        rows = load_from_frame_index(Path(args.frame_index))
    elif args.flat_root:
        rows = load_flat_images_masks(Path(args.flat_root),
                                      split_name_override=args.flat_split_name)
    elif args.root:
        rows = load_from_directory(Path(args.root))
    else:
        raise SystemExit("one of --frame_index / --flat_root / --root required")
    if not rows:
        raise SystemExit("no frames found")
    make_dataset_reports(rows, Path(args.outdir))
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
    pr.add_argument("--int8", action="store_true",
                    help="serve the forward's 3x3 convs on the int8 tensor "
                         "cores (post-training quantization, auto-calibrated; "
                         "nn/quant.py)")
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
    ic.add_argument("--model-tag", default="baseline", choices=list(SERVED))
    ic.add_argument("--case-id", default="output")
    ic.add_argument("--weights",
                    help="baseline: nnU-Net .pth / .pt checkpoint or flat "
                         ".npz (default: the initialisation of seed 0); "
                         "swin_unetr: .pt / .pth state dict (default: the "
                         "initialisation of seed 0); "
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
    ic.add_argument("--int8", action="store_true",
                    help="att_aspp tag: serve the forward's 3x3 convs on the "
                         "int8 tensor cores (post-training quantization, "
                         "nn/quant.py)")
    _common_flags(ic)
    ic.set_defaults(fn=cmd_infer_container)

    wm = sp.add_parser("warm", help="build the kernels and the host ops and "
                       "serve one zero sweep per declared shape, so that a "
                       "deployment's first case pays no build")
    wm.add_argument("--shapes", default="140x562x744",
                    help="comma list of NxHxW sweep shapes to serve once")
    wm.add_argument("--weights", help="optional weights (random init "
                    "without; shapes, not values, matter here)")
    wm.add_argument("--cascade", action="store_true")
    wm.add_argument("--scout_weights", default=None,
                    help="warm the distilled-scout cascade (same flag as "
                         "predict)")
    wm.add_argument("--scout_base_c", type=int, default=None,
                    help="scout width; default reads base_c from the "
                         "summary.json next to --scout_weights (fallback 16)")
    wm.add_argument("--scout_thr", type=float, default=0.0,
                    help="scout ranking threshold (0 = from the thr.json "
                         "next to --scout_weights, as predict)")
    wm.add_argument("--scout_no_clahe", action="store_true",
                    help="match a deployment serving --scout_no_clahe")
    wm.add_argument("--scout_rank", default="refined",
                    choices=("refined", "closed"),
                    help="match the deployment's tier-1 rank key")
    wm.add_argument("--bulk", type=int, default=0,
                    help="also serve a predict --bulk N group per shape "
                         "(requires --cascade)")
    wm.add_argument("--thr", type=float, default=None,
                    help="serving threshold; default resolves thr.json as "
                         "predict does")
    wm.add_argument("--thr_json", default="./checkpoints/thr.json")
    wm.add_argument("--int8", action="store_true",
                    help="warm the int8 path (calibrated on the zero sweep)")
    wm.add_argument("--tta", action="store_true")
    wm.add_argument("--img-size", type=int, default=512)
    # the JAX CLI's flags that the port refuses (WARM_REFUSED)
    wm.add_argument("--export-aot", default=None, metavar="DIR",
                    help=argparse.SUPPRESS)
    wm.add_argument("--roi", action="store_true", help=argparse.SUPPRESS)
    wm.add_argument("--c1_pad", type=int, default=0, help=argparse.SUPPRESS)
    wm.add_argument("--lowering", default=None, help=argparse.SUPPRESS)
    _common_flags(wm)
    wm.set_defaults(fn=cmd_warm)

    es = sp.add_parser("eval-seg", help="Dice / IoU / HD95 of a new and a "
                       "baseline model's masks against GT masks")
    es.add_argument("--gt", required=True)
    es.add_argument("--base", required=True)
    es.add_argument("--new", required=True)
    es.add_argument("--out_csv", default="seg_eval.csv")
    es.add_argument("--new_suffix", default="_mask")
    es.add_argument("--plot", action="store_true")
    es.add_argument("--plot_dir", default="plots")
    es.set_defaults(fn=cmd_eval_seg)

    ea = sp.add_parser("eval-ac", help="AC agreement of two models' "
                       "ac_results.csv with a per-sweep GT table")
    ea.add_argument("--gt", required=True)
    ea.add_argument("--baseline", required=True)
    ea.add_argument("--new", required=True)
    ea.add_argument("--out", default="ac_analysis_results")
    ea.add_argument("--fps", type=int, default=140,
                    help="frames per sweep of the stacked cases "
                         "(ContainerConfig.frames_per_sweep)")
    ea.set_defaults(fn=cmd_eval_ac)

    ve = sp.add_parser("vis-errors", help="overlays of the worst ΔDice "
                       "cases of a seg_eval.csv")
    ve.add_argument("--csv", required=True)
    ve.add_argument("--gt", required=True)
    ve.add_argument("--base", required=True)
    ve.add_argument("--new", required=True)
    ve.add_argument("--out", default="vis")
    ve.add_argument("--images")
    ve.add_argument("--top", type=int, default=10)
    ve.add_argument("--alpha", type=float, default=0.35)
    ve.add_argument("--edge", type=int, default=2)
    ve.set_defaults(fn=cmd_vis_errors)

    cv = sp.add_parser("convert", help=".mha volume pairs to PNG frame "
                       "pairs with negative sampling")
    cv.add_argument("--mha_root", required=True)
    cv.add_argument("--out_root", required=True)
    cv.add_argument("--topk", type=int, default=3)
    cv.add_argument("--neighbor_pad", type=int, default=0)
    cv.add_argument("--min_area_mm2", type=float, default=80.0)
    cv.add_argument("--min_area_px", type=int, default=100)
    cv.add_argument("--neg_strategy", default="random",
                    choices=["all", "random", "stride"])
    cv.add_argument("--neg_ratio", type=float, default=0.0)
    cv.add_argument("--neg_cap", type=int, default=5)
    cv.add_argument("--neg_stride", type=int, default=5)
    cv.add_argument("--seed", type=int, default=2025)
    cv.add_argument("--export_neg_only", action="store_true")
    cv.add_argument("--neg_total_cap", type=int, default=0)
    cv.set_defaults(fn=cmd_convert)

    spx = sp.add_parser("split", help="seeded train / val split of "
                        "<raw_root>/{images,masks}")
    spx.add_argument("--raw_root", default="./raw")
    spx.add_argument("--out_root", default=".")
    spx.add_argument("--train_frac", type=float, default=0.8)
    spx.add_argument("--seed", type=int, default=42)
    spx.set_defaults(fn=cmd_split)

    lc = sp.add_parser("leak-check", help="files present in both the train "
                       "and the val set (exit 1 if any)")
    lc.add_argument("--train", default="train/images")
    lc.add_argument("--val", default="val/images")
    lc.add_argument("--out", default="check_results")
    lc.add_argument("-r", "--recursive", action="store_true")
    lc.add_argument("--by-stem", action="store_true")
    lc.set_defaults(fn=cmd_leak_check)

    dr = sp.add_parser("dataset-report", help="split statistics, LaTeX "
                       "table and plots of a PNG dataset")
    dr.add_argument("--frame_index")
    dr.add_argument("--flat_root")
    dr.add_argument("--flat_split_name")
    dr.add_argument("--root")
    dr.add_argument("--outdir", default="reports")
    dr.set_defaults(fn=cmd_dataset_report)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
