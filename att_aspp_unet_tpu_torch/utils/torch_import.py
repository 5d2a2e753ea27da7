"""Import reference PyTorch checkpoints (``.pt`` / ``.pth``) of the
Attention-ASPP-UNet into the JAX-layout variables tree, which then goes
through ``utils/convert.py`` as a flat ``.npz`` does.  A copy of
``att_aspp_unet_tpu/utils/torch_import.py``:

- unwrap ``{"state_dict": ...}`` containers,
- rename legacy ``.W_g.`` -> ``.Wg.`` and ``.W_x.`` -> ``.Wx.`` keys,
- non-strict loading: fill what matches, keep the template's values for the
  rest, and report the missing / unexpected key counts.

Layout conversions (PyTorch -> flax):

- Conv2d            weight (O, I, kH, kW)  -> kernel (kH, kW, I, O)
- ConvTranspose2d   weight (I, O, kH, kW)  -> kernel (kH, kW, I, O), flipped
- BatchNorm2d       weight/bias/running_mean/running_var
                    -> scale/bias (params) + mean/var (batch_stats)
"""

from __future__ import annotations

import copy
from typing import Dict, List, Tuple

import numpy as np

from ..config import ModelConfig
from ..models.att_aspp_unet import gated


def _conv_w(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (2, 3, 1, 0))


def _convT_w(w: np.ndarray) -> np.ndarray:
    # flax's ConvTranspose correlates the dilated input with the kernel as
    # stored; torch's ConvTranspose2d is the conv gradient, a correlation
    # with the spatially flipped kernel
    return np.ascontiguousarray(np.transpose(w, (2, 3, 0, 1))[::-1, ::-1])


def normalize_state_dict(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Unwrap containers and apply the legacy key renames."""
    if "state_dict" in sd and isinstance(sd["state_dict"], dict):
        sd = sd["state_dict"]
    return {k.replace(".W_g.", ".Wg.").replace(".W_x.", ".Wx."): v
            for k, v in sd.items()}


def _mapping_for_config(cfg: ModelConfig) -> List[Tuple[str, str, str]]:
    """(torch_prefix, flax_path, kind) triples for every module of the
    variant; kind in {conv, convT, bn, conv_bias}, flax_path '/'-joined below
    params/ or batch_stats/."""
    rules: List[Tuple[str, str, str]] = []

    def cbr(torch_prefix, flax_prefix):
        rules.append((f"{torch_prefix}.block.0", f"{flax_prefix}/conv", "conv"))
        rules.append((f"{torch_prefix}.block.1", f"{flax_prefix}/bn", "bn"))

    for i in range(1, 5):
        cbr(f"d{i}.0", f"d{i}_0")
        cbr(f"d{i}.1", f"d{i}_1")

    if cfg.use_aspp:
        for b in range(len(cfg.aspp_rates) + 1):
            rules.append((f"bridge.blocks.{b}.0", f"bridge/branch{b}_conv", "conv"))
            rules.append((f"bridge.blocks.{b}.1", f"bridge/branch{b}_bn", "bn"))
        rules.append(("bridge.pool.1", "bridge/pool_conv", "conv"))
        rules.append(("bridge.pool.2", "bridge/pool_bn", "bn"))
        rules.append(("bridge.project.0", "bridge/project_conv", "conv"))
        rules.append(("bridge.project.1", "bridge/project_bn", "bn"))
    else:
        cbr("bridge.0", "bridge_conv")

    for lvl in (4, 3, 2, 1):
        rules.append((f"u{lvl}.up", f"u{lvl}/up", "convT"))
        if not gated(cfg, lvl):
            pass
        elif cfg.gate_variant == "v1":
            for name in ("Wg", "Wx", "psi"):
                rules.append((f"u{lvl}.att.{name}.0",
                              f"u{lvl}/att/{name}_conv", "conv"))
                rules.append((f"u{lvl}.att.{name}.1",
                              f"u{lvl}/att/{name}_bn", "bn"))
        else:
            rules.append((f"u{lvl}.att.Wg", f"u{lvl}/att/Wg", "conv"))
            rules.append((f"u{lvl}.att.Wx", f"u{lvl}/att/Wx", "conv"))
            rules.append((f"u{lvl}.att.psi.1", f"u{lvl}/att/psi", "conv_bias"))
        cbr(f"u{lvl}.conv.0", f"u{lvl}/conv0")
        cbr(f"u{lvl}.conv.1", f"u{lvl}/conv1")

    rules.append(("out_conv", "out_conv", "conv_bias"))
    return rules


def _set(tree: dict, path: str, value: np.ndarray) -> bool:
    parts = path.split("/")
    node = tree
    for p in parts[:-1]:
        if p not in node:
            return False
        node = node[p]
    if parts[-1] not in node:
        return False
    expected = np.shape(node[parts[-1]])
    if tuple(expected) != tuple(value.shape):
        raise ValueError(f"shape mismatch at {path}: "
                         f"checkpoint {value.shape} vs model {expected}")
    node[parts[-1]] = value.astype(np.asarray(node[parts[-1]]).dtype)
    return True


def convert_reference_state_dict(sd: Dict[str, np.ndarray], cfg: ModelConfig,
                                 variables: dict,
                                 verbose: bool = True) -> dict:
    """Fill a copy of the JAX-layout tree ``variables`` (``{"params",
    "batch_stats"}``, e.g. ``init_variables(cfg)``) from a torch state dict.
    Non-strict: unmatched torch keys and unfilled leaves are reported, not
    fatal."""
    sd = {k: np.asarray(v) for k, v in normalize_state_dict(sd).items()}
    out = {"params": copy.deepcopy(variables["params"]),
           "batch_stats": copy.deepcopy(variables.get("batch_stats", {}))}

    used = set()
    missing: List[str] = []
    for torch_prefix, flax_path, kind in _mapping_for_config(cfg):
        if kind in ("conv", "conv_bias", "convT"):
            wk = f"{torch_prefix}.weight"
            if wk in sd:
                conv = _convT_w if kind == "convT" else _conv_w
                if _set(out["params"], f"{flax_path}/kernel", conv(sd[wk])):
                    used.add(wk)
            else:
                missing.append(wk)
            bk = f"{torch_prefix}.bias"
            if kind in ("conv_bias", "convT"):
                if bk in sd:
                    if _set(out["params"], f"{flax_path}/bias", sd[bk]):
                        used.add(bk)
                else:
                    missing.append(bk)
        elif kind == "bn":
            pairs = [("weight", "params", "scale"), ("bias", "params", "bias"),
                     ("running_mean", "batch_stats", "mean"),
                     ("running_var", "batch_stats", "var")]
            for tsuf, coll, fsuf in pairs:
                tk = f"{torch_prefix}.{tsuf}"
                if tk in sd:
                    if _set(out[coll], f"{flax_path}/{fsuf}", sd[tk]):
                        used.add(tk)
                else:
                    missing.append(tk)

    unexpected = [k for k in sd
                  if k not in used and not k.endswith("num_batches_tracked")]
    if verbose:
        print(f"[torch_import] loaded with {len(missing)} missing & "
              f"{len(unexpected)} unexpected keys")
    return out


def load_torch_checkpoint(path, cfg: ModelConfig, variables: dict,
                          verbose: bool = True) -> dict:
    """Read a reference ``.pt`` / ``.pth`` file (tensors only,
    ``weights_only=True``) and import it into a copy of ``variables``."""
    import torch

    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    sd_np = {k: v.detach().cpu().numpy() for k, v in sd.items()
             if hasattr(v, "detach")}
    return convert_reference_state_dict(sd_np, cfg, variables, verbose=verbose)
