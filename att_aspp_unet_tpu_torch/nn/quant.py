"""Post-training int8 quantization of the 3x3 ConvBNReLU convs, on tensors.

Counterpart of ``att_aspp_unet_tpu/nn/quant.py`` (``ModelConfig.conv_lowering
= "int8"``): per-output-channel symmetric int8 weights, per-tensor symmetric
int8 activations with a static scale from an absmax calibration, int32
accumulation, dequant, then the conv's BatchNorm and ReLU.  The conv itself
is kernel K3 (``ops/kernels/int8_conv.py``).

The scales follow the JAX package's serving engine, whose quantization runs
under ``jax.jit``: XLA folds the division of an absmax by the constant 127
into a product with f32(1/127), so ``w_scale = max(absmax, 1e-12) *
f32(1/127)`` and ``s_x = max(act_absmax, 1e-6) * f32(1/127)`` (op by op,
JAX divides, and 195 of 4096 channel scales of a random kernel then differ
by one ulp).  The quantization itself divides by the scale, a traced value
that XLA leaves a true division, and rounds half to even.

The quant tree is the JAX package's ``quant`` collection: per conv site
(``d1_0/conv``, ..., ``u1/conv1/conv``, and ``bridge_conv/conv`` without the
ASPP) the calibrated ``act_absmax`` and, once the kernels are quantized,
``w_scale``.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..ops.kernels.int8_conv import quantize_act  # noqa: F401

INV127 = np.float32(1.0 / 127.0)     # what XLA folds ``/ 127.0`` into


def _prod127(absmax, eps: float):
    """``max(absmax, eps) * f32(1/127)`` in f32 (a product of two f32 values
    rounds once, in numpy and in torch alike)."""
    if isinstance(absmax, torch.Tensor):
        return torch.clamp_min(absmax.to(torch.float32), eps) * float(INV127)
    return np.maximum(np.asarray(absmax, np.float32),
                      np.float32(eps)) * INV127


def act_scale(act_absmax):
    """The per-tensor activation scale of a calibrated absmax."""
    return _prod127(act_absmax, 1e-6)


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Cout, ...) f32 kernel, output channel first -> (int8 kernel,
    per-Cout f32 scale): ``s = max(absmax, 1e-12) * f32(1/127)`` over every
    other axis, ``q = clip(round(w / s), -127, 127)``."""
    w = w.to(torch.float32)
    absmax = w.abs().reshape(w.shape[0], -1).amax(dim=1)
    s = _prod127(absmax, 1e-12)
    q = torch.round(w / s.reshape(-1, *([1] * (w.dim() - 1))))
    return q.clamp_(-127, 127).to(torch.int8), s


def conv_sites(use_aspp: bool = True):
    """The conv sites of the quant tree in forward order: the two convs of
    each encoder pair, the bridge conv (``use_aspp=False``), the two convs
    of each decoder pair."""
    sites = [f"d{lvl}_{i}/conv" for lvl in (1, 2, 3, 4) for i in (0, 1)]
    if not use_aspp:
        sites.append("bridge_conv/conv")
    sites += [f"u{lvl}/conv{i}/conv" for lvl in (4, 3, 2, 1) for i in (0, 1)]
    return sites


def tree_get(tree: Dict, site: str) -> Dict:
    """The node of ``site`` (a ``/``-joined path) in a nested dict."""
    for key in site.split("/"):
        tree = tree[key]
    return tree


def tree_set(tree: Dict, site: str, leaf: str, value) -> None:
    node = tree
    for key in site.split("/"):
        node = node.setdefault(key, {})
    node[leaf] = value


def prequantize(params: Dict[str, Any], use_aspp: bool = True
                ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Quantize the 3x3 kernel of every conv site of a JAX-layout params
    tree (numpy HWIO, once, outside any forward), as the JAX package's
    ``prequantize_params``: ``(params_q, w_scales)``, the same tree with
    each site's kernel int8 and a quant-shaped tree of the matching
    ``w_scale`` leaves.  Idempotent: a kernel that is int8 already is kept
    and gets no ``w_scale`` here (its own comes with its ``quant``)."""
    out = _copy_tree(params)
    scales: Dict[str, Any] = {}
    for site in conv_sites(use_aspp):
        node = tree_get(out, site)
        k = np.asarray(node["kernel"])
        if k.dtype == np.int8:
            continue
        q, s = quantize_weight(torch.from_numpy(
            np.ascontiguousarray(k.astype(np.float32).transpose(3, 0, 1, 2))))
        node["kernel"] = q.numpy().transpose(1, 2, 3, 0).copy()
        tree_set(scales, site, "w_scale", s.numpy())
    return out, scales


def _copy_tree(tree):
    return {k: _copy_tree(v) if isinstance(v, dict) else v
            for k, v in tree.items()}


def merge_quant(act_tree: Dict[str, Any],
                w_tree: Dict[str, Any]) -> Dict[str, Any]:
    """Deep merge of the calibrated activation-absmax tree with the
    ``w_scale`` tree (both mirror the module nesting)."""
    out = dict(act_tree)
    for k, v in w_tree.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = merge_quant(out[k], v)
        else:
            out[k] = v
    return out
