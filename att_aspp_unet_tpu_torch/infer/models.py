"""What each ``MODEL_TAG`` loads and which engine serves it: :data:`SERVED`,
the container's one table of models, which every entry point reads through
:func:`load_model` and :func:`build_engine`."""

from __future__ import annotations

import dataclasses
import os
import re
from pathlib import Path
from typing import Callable, NamedTuple

from ..config import Config, ModelConfig


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
        from ..utils.npz_weights import load_npz_variables
        return load_npz_variables(weights)
    if weights.suffix in (".pt", ".pth"):
        from ..utils.convert import init_variables
        from ..utils.torch_import import load_torch_checkpoint
        return load_torch_checkpoint(weights, cfg, init_variables(cfg, 0))
    from ..train.train_loop import read_checkpoint
    from ..utils.convert import checkpoint_variables
    try:
        return checkpoint_variables(read_checkpoint(weights)["model"], cfg)
    except ValueError as err:
        raise SystemExit(f"{weights}: expected a flat .npz archive, a "
                         "checkpoint of this package's train or a PyTorch "
                         f".pt / .pth state dict ({err})") from None


def load_baseline(path, cfg: Config):
    """The baseline's PlainConvUNet on the CPU from an nnU-Net checkpoint
    (``.pth`` / ``.pt``), the JAX package's flat ``.npz`` or, for None, the
    initialisation of seed 0."""
    from ..models.plain_unet import PlainConvUNet

    if path is None:
        return PlainConvUNet.from_config(cfg.plain_unet, seed=0)
    if path.suffix in (".pth", ".pt"):
        from ..utils.nnunet_import import load_nnunet_checkpoint
        return load_nnunet_checkpoint(path, cfg.plain_unet)
    if path.suffix == ".npz":
        from ..utils.convert import jax_plain_unet_to_torch
        from ..utils.npz_weights import load_npz_variables
        return jax_plain_unet_to_torch(load_npz_variables(path),
                                       cfg.plain_unet)
    raise SystemExit(f"--weights {path}: expected an nnU-Net .pth / .pt "
                     "checkpoint or a flat .npz archive")


def load_swin_unetr(path, cfg: Config):
    """The labeled path's SwinUNETR on the CPU (``cfg.swin_unetr``) from a
    ``.pt`` / ``.pth`` state dict with MONAI's parameter names or, for None,
    the initialisation of seed 0.  Every key has to match, except that the
    conv blocks' InstanceNorm affines may be missing (MONAI's
    ``norm_name="instance"`` has none): they stay at 1 and 0, which computes
    the same.  Any other missing key, or any unexpected one, is a checkpoint
    of another network, and is refused."""
    import torch

    from ..models.swin_unetr import SwinUNETR

    if path is None:
        return SwinUNETR.from_config(cfg.swin_unetr, seed=0)
    if path.suffix not in (".pth", ".pt"):
        raise SystemExit(f"--weights {path}: the swin_unetr model reads a "
                         ".pt / .pth state dict")
    sd = torch.load(path, map_location="cpu", weights_only=True)
    sd = sd.get("state_dict", sd)
    model = SwinUNETR(cfg.swin_unetr)
    res = model.load_state_dict(sd, strict=False)
    foreign = [k for k in res.missing_keys
               if k.startswith("swinViT.")
               or not re.search(r"\.norm[123]\.(weight|bias)$", k)]
    if foreign or res.unexpected_keys:
        raise SystemExit(
            f"--weights {path} is not a SwinUNETR state dict of this "
            f"configuration: {len(foreign)} missing keys (e.g. "
            f"{foreign[:3]}) and {len(res.unexpected_keys)} unexpected "
            f"(e.g. {res.unexpected_keys[:3]})")
    print(f"[swin_unetr] loaded with {len(res.missing_keys)} missing "
          "InstanceNorm affine keys (left at 1 and 0)")
    return model.eval()


class Served(NamedTuple):
    """How a ``MODEL_TAG`` is served."""
    load: Callable          # (weights path or None, cfg) -> model on the CPU
    labeled: bool           # BaselineEngine, else AttAsppEngine's ROI path
    needs_weights: bool = False


SERVED = {
    "baseline": Served(load_baseline, labeled=True),
    "att_aspp": Served(lambda path, cfg: load_variables(path, cfg.model),
                       labeled=False, needs_weights=True),
    "swin_unetr": Served(load_swin_unetr, labeled=True),
}


def served(tag: str) -> Served:
    """The table's entry of ``tag``, else a ``ValueError`` naming it."""
    if tag not in SERVED:
        raise ValueError(f"MODEL_TAG={tag!r}: expected one of "
                         f"{', '.join(map(repr, SERVED))}")
    return SERVED[tag]


def load_model(tag: str, weights, cfg: Config, weights_name="--weights"):
    """The model of ``tag`` on the CPU from the path ``weights``, read from
    the flag or variable ``weights_name`` (None: seed 0's initialisation)."""
    entry = served(tag)
    path = None if weights is None else Path(weights)
    if path is None:
        if entry.needs_weights:
            raise SystemExit(f"MODEL_TAG={tag} needs {weights_name} (a flat "
                             ".npz or a .pt / .pth state dict)")
        print(f"[warn] no {weights_name} given: using random init "
              "(smoke mode)")
    elif not path.exists():
        raise SystemExit(f"weights not found: {path}")
    return entry.load(path, cfg)


class Serving(NamedTuple):
    """The two calls of an engine that its tag serves, on ``device``."""
    device: object
    labeled: bool
    predict: Callable       # raw (N, H, W) sweep -> probabilities
    postprocess: Callable   # probabilities -> mask stack


def build_engine(tag: str, cfg: Config, model, device="cuda") -> Serving:
    """The engine of ``tag`` on ``device`` over ``model``: what
    :func:`load_model` gives, or a JAX-layout variables tree (numpy)."""
    from .engine import AttAsppEngine, BaselineEngine

    if served(tag).labeled:
        e = BaselineEngine(cfg, model, device=device)
        return Serving(e.device, True, e.predict, e.postprocess)
    e = AttAsppEngine(cfg, model, device=device)
    return Serving(e.device, False, e.predict_roi, e.postprocess_roi)


def entry_config(cfg: Config, plans=None, dataset_json=None) -> Config:
    """``cfg`` as an entry point serves it: with the PlainConvUNet of
    nnU-Net's ``plans.json`` (and ``dataset.json``) where ``plans`` is
    given, and ``MODEL_TAG`` and ``CASE_ID`` of the environment over its
    container's ``model_tag`` and ``case_id``."""
    if plans:
        from ..utils.nnunet_import import load_plans_config
        cfg = dataclasses.replace(cfg, plain_unet=load_plans_config(
            plans, dataset_json=dataset_json or None, base=cfg.plain_unet))
    return dataclasses.replace(cfg, container=dataclasses.replace(
        cfg.container,
        model_tag=os.getenv("MODEL_TAG", cfg.container.model_tag),
        case_id=os.getenv("CASE_ID", cfg.container.case_id)))
