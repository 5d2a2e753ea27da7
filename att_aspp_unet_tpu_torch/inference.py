"""Container entry point (Grand-Challenge contract), driven by the
environment as the repository's root ``inference.py`` is:

    python -m att_aspp_unet_tpu_torch.inference

Reads the single case under ``./test/input/images/stacked-fetal-ultrasound``
and writes ``./test/output/images/fetal-abdomen-segmentation/<case>.mha`` and
``./test/output/fetal-abdomen-frame-number.json`` (the ``ContainerConfig``
defaults).  The environment:

- ``MODEL_TAG``: ``baseline`` (default), ``swin_unetr`` or ``att_aspp``;
- ``WEIGHTS``: the checkpoint.  ``baseline`` reads an nnU-Net ``.pth`` /
  ``.pt`` or a flat ``.npz`` and without one runs on the initialisation of
  seed 0, to exercise the contract; ``swin_unetr`` reads a ``.pt`` /
  ``.pth`` state dict, and without one runs on seed 0 likewise;
  ``att_aspp`` reads a flat ``.npz``, a checkpoint of ``cli train`` or a
  ``.pt`` / ``.pth`` state dict, and without one exits with a message;
- ``PLANS`` and ``DATASET_JSON``: nnU-Net's ``plans.json`` and
  ``dataset.json`` for the baseline's architecture;
- ``CASE_ID``: the name of the output volume (default ``output``);
- ``DEVICE``: the torch device (default ``cuda``; ``cpu`` runs the plain
  PyTorch versions of the kernels).
"""

from __future__ import annotations

import dataclasses
import os
import sys
from pathlib import Path


def main() -> int:
    from .cli import load_labeled, load_variables
    from .config import Config
    from .infer.container import LABELED_TAGS, run_from_env

    cfg = Config()
    weights = os.getenv("WEIGHTS")
    tag = os.getenv("MODEL_TAG", "baseline")
    plans = os.getenv("PLANS")          # nnU-Net plans.json (baseline arch)
    if plans:
        from .utils.nnunet_import import load_plans_config
        ds = os.getenv("DATASET_JSON")
        cfg = dataclasses.replace(cfg, plain_unet=load_plans_config(
            Path(plans), dataset_json=Path(ds) if ds else None,
            base=cfg.plain_unet))
    if tag in LABELED_TAGS:
        variables = load_labeled(tag, weights, cfg)
    elif weights:
        variables = load_variables(Path(weights), cfg.model)
    else:
        raise SystemExit("MODEL_TAG=att_aspp needs WEIGHTS (a flat .npz or a "
                         ".pt / .pth state dict)")
    return run_from_env(cfg, variables, device=os.getenv("DEVICE", "cuda"))


if __name__ == "__main__":
    sys.exit(main())
