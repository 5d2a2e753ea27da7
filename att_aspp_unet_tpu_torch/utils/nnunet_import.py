"""nnU-Net v2 plans and ``checkpoint_final.pth`` files -> the port's
baseline model.

Counterpart of ``att_aspp_unet_tpu/utils/nnunet_import.py``.  The port's
:class:`PlainConvUNet` carries nnU-Net v2's parameter names, so a checkpoint
loads without a layout change once it is normalised: the containers
``{"network_weights": ...}`` (nnU-Net trainer output) and
``{"state_dict": ...}`` are unwrapped and the ``module.`` (DDP) and
``_orig_mod.`` (``torch.compile``) prefixes stripped.  Only the
full-resolution head ``decoder.seg_layers.{n-2}`` is read; the
deep-supervision heads are ignored.
"""

from __future__ import annotations

import dataclasses
import json
import pickle
import re
from pathlib import Path
from typing import Dict, Optional

import torch

from ..config import PlainUNetConfig
from ..models.plain_unet import PlainConvUNet


def load_plans_config(plans_path, configuration: str = "2d",
                      dataset_json: Optional[Path] = None,
                      base: Optional[PlainUNetConfig] = None
                      ) -> PlainUNetConfig:
    """A :class:`PlainUNetConfig` from an nnU-Net v2 ``plans.json``, so that a
    checkpoint of another plan (patch size, stages, features) builds its own
    architecture.  ``dataset_json`` (nnU-Net's ``dataset.json``) supplies
    ``num_classes`` (#labels) and ``in_channels`` (#channel_names); without it
    they stay at ``base``'s values.  Plans this model cannot express raise."""
    plans = json.loads(Path(plans_path).read_text())
    try:
        c = plans["configurations"][configuration]
    except KeyError as e:
        raise KeyError(
            f"configuration {configuration!r} not in plans "
            f"(have {sorted(plans.get('configurations', {}))})") from e

    arch = c.get("UNet_class_name", "PlainConvUNet")
    if arch != "PlainConvUNet":
        raise ValueError(f"unsupported architecture {arch!r} "
                         "(only PlainConvUNet plans are importable)")
    enc = list(c["n_conv_per_stage_encoder"])
    if len(set(enc)) != 1:
        raise ValueError(f"non-uniform convs per stage unsupported: {enc}")
    for k in c.get("conv_kernel_sizes", []):
        if tuple(k) != (3, 3):
            raise ValueError(f"non-3x3 conv kernels unsupported: "
                             f"{c['conv_kernel_sizes']}")
    pools = [tuple(p) for p in c.get("pool_op_kernel_sizes", [])]
    if pools and (pools[0] != (1, 1) or any(p != (2, 2) for p in pools[1:])):
        raise ValueError(f"unsupported pooling layout: {pools}")

    kw = dict(
        base_c=int(c["UNet_base_num_features"]),
        max_c=int(c.get("unet_max_num_features", 512)),
        n_stages=len(enc),
        conv_per_stage=int(enc[0]),
        patch_size=tuple(int(v) for v in c["patch_size"]),
    )
    if dataset_json is not None:
        ds = json.loads(Path(dataset_json).read_text())
        if "labels" in ds:
            kw["num_classes"] = len(ds["labels"])
        if "channel_names" in ds:
            kw["in_channels"] = len(ds["channel_names"])
    return dataclasses.replace(base or PlainUNetConfig(), **kw)


def normalize_nnunet_state_dict(sd: Dict) -> Dict:
    """Unwrap the checkpoint containers and strip the ``module.`` /
    ``_orig_mod.`` prefixes."""
    for container in ("network_weights", "state_dict"):
        if container in sd and isinstance(sd[container], dict):
            sd = sd[container]
    return {re.sub(r"^(module\.|_orig_mod\.)", "", k): v
            for k, v in sd.items()}


def nnunet_state_dict_to_torch(sd: Dict, cfg: PlainUNetConfig,
                               verbose: bool = True) -> PlainConvUNet:
    """The port's model on the CPU with the weights of an nnU-Net v2 state
    dict, loaded non-strictly: what the checkpoint lacks keeps the seeded
    initialisation.  Prints the counts of missing and unexpected keys as the JAX importer
    does (deep-supervision heads and ``num_batches_tracked`` are not
    unexpected)."""
    sd = normalize_nnunet_state_dict(sd)
    model = PlainConvUNet.from_config(cfg)
    want = model.state_dict()
    missing = [k for k in want if k not in sd]
    unexpected = [k for k in sd if k not in want
                  and not k.startswith("decoder.seg_layers.")
                  and not k.endswith("num_batches_tracked")]
    model.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()
                           if k in want}, strict=False)
    if verbose:
        print(f"[nnunet_import] loaded with {len(missing)} missing & "
              f"{len(unexpected)} unexpected keys")
    return model.eval()


def load_nnunet_checkpoint(path, cfg: PlainUNetConfig,
                           verbose: bool = True) -> PlainConvUNet:
    """An nnU-Net v2 checkpoint file -> the port's model on the CPU."""
    # the safe loader first; nnU-Net trainer checkpoints embed a few plain
    # objects (numpy scalars etc.) that weights_only=True may reject, so the
    # unsafe path is taken only if the safe one cannot parse the file
    try:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        sd = torch.load(path, map_location="cpu", weights_only=False)
    sd = {k: v for k, v in normalize_nnunet_state_dict(sd).items()
          if isinstance(v, torch.Tensor)}
    return nnunet_state_dict_to_torch(sd, cfg, verbose=verbose)
