"""Container entry point (Grand-Challenge contract), driven by the
environment as the repository's root ``inference.py`` is:

    python -m att_aspp_unet_tpu_torch.inference

Reads the single case under ``./test/input/images/stacked-fetal-ultrasound``
and writes ``./test/output/images/fetal-abdomen-segmentation/<case>.mha`` and
``./test/output/fetal-abdomen-frame-number.json`` (the ``ContainerConfig``
defaults).  The environment:

- ``MODEL_TAG`` (default ``baseline``) and ``WEIGHTS``: the model and its
  checkpoint, as ``infer/models.py``'s table reads them (without one the
  labeled networks run on the initialisation of seed 0, ``att_aspp`` exits);
- ``PLANS`` and ``DATASET_JSON``: nnU-Net's ``plans.json`` and
  ``dataset.json`` for the baseline's architecture;
- ``CASE_ID``: the name of the output volume (default ``output``);
- ``DEVICE``: the torch device (default ``cuda``; ``cpu`` runs the plain
  PyTorch versions of the kernels).
"""

from __future__ import annotations

import os
import sys


def main() -> int:
    from .config import Config
    from .infer.container import run
    from .infer.models import entry_config, load_model

    cfg = entry_config(Config(), os.getenv("PLANS"), os.getenv("DATASET_JSON"))
    model = load_model(cfg.container.model_tag, os.getenv("WEIGHTS"), cfg,
                       weights_name="WEIGHTS")
    return run(cfg, model, device=os.getenv("DEVICE", "cuda"))


if __name__ == "__main__":
    sys.exit(main())
