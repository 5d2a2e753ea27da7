"""JAX-package variables -> the port's modules.

``jax_variables_to_torch`` takes the nested numpy ``{"params", "batch_stats"}``
tree (``load_npz_variables`` of a flat-npz archive, or a flax variables tree
converted to numpy) and builds the port's :class:`AttentionASPPUNet`:

- 3x3 conv kernels go from HWIO to the kernel's packed (Cout, 9*Cin) layout
  in (ky, kx, ci) order;
- every BatchNorm folds to a per-channel f32 (scale, bias), eps 1e-5;
- ConvTranspose kernels are pre-flipped spatially (flax applies the reversed
  kernel), so the port's up-conv indexes them forward;
- the ASPP's dilated kernels go to OIHW for ``F.conv2d``.

``jax_plain_unet_to_torch`` does the same for the baseline's
``PlainConvUNet``, into the port's nnU-Net-named module: HWIO -> OIHW, the
transposed convs' kernels flipped into PyTorch's (in, out, kh, kw) layout,
InstanceNorm scale/bias -> weight/bias (the inverse of the JAX package's
``utils/nnunet_import.py`` mapping).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..config import ModelConfig, PlainUNetConfig
from ..models.att_aspp_unet import AttentionASPPUNet
from ..models.plain_unet import PlainConvUNet
from ..ops.kernels.fused_conv import fold_batchnorm, pack_conv_weight


def _np(a) -> np.ndarray:
    return np.asarray(a, np.float32)


def _bn(p, s):
    return fold_batchnorm(p["scale"], p["bias"], s["mean"], s["var"])


def _pair(sd, prefix, p0, s0, p1, s1):
    sd[f"{prefix}.w1"] = pack_conv_weight(_np(p0["conv"]["kernel"]))
    sd[f"{prefix}.s1"], sd[f"{prefix}.b1"] = _bn(p0["bn"], s0["bn"])
    sd[f"{prefix}.w2"] = pack_conv_weight(_np(p1["conv"]["kernel"]))
    sd[f"{prefix}.s2"], sd[f"{prefix}.b2"] = _bn(p1["bn"], s1["bn"])


def _pw(sd, prefix, p, s, conv, bn):
    sd[f"{prefix}_w"] = _np(p[conv]["kernel"])[0, 0]
    sd[f"{prefix}_s"], sd[f"{prefix}_b"] = _bn(p[bn], s[bn])


def torch_state_dict(variables: Dict, cfg: ModelConfig) -> Dict[str, np.ndarray]:
    """The port's state dict (numpy f32 arrays) from JAX variables."""
    p, s = variables["params"], variables["batch_stats"]
    sd: Dict[str, np.ndarray] = {}
    for lvl in (1, 2, 3, 4):
        _pair(sd, f"d{lvl}", p[f"d{lvl}_0"], s[f"d{lvl}_0"],
              p[f"d{lvl}_1"], s[f"d{lvl}_1"])

    bp, bs = p["bridge"], s["bridge"]
    _pw(sd, "bridge.b0", bp, bs, "branch0_conv", "branch0_bn")
    for i in range(len(cfg.aspp_rates)):
        k = _np(bp[f"branch{i + 1}_conv"]["kernel"])          # HWIO
        sd[f"bridge.rate{i}_w"] = k.transpose(3, 2, 0, 1)      # OIHW
        sd[f"bridge.rate{i}_s"], sd[f"bridge.rate{i}_b"] = _bn(
            bp[f"branch{i + 1}_bn"], bs[f"branch{i + 1}_bn"])
    _pw(sd, "bridge.pool", bp, bs, "pool_conv", "pool_bn")
    _pw(sd, "bridge.proj", bp, bs, "project_conv", "project_bn")

    for lvl in (4, 3, 2, 1):
        up, us = p[f"u{lvl}"], s[f"u{lvl}"]
        sd[f"u{lvl}.up_k"] = _np(up["up"]["kernel"])[::-1, ::-1]
        sd[f"u{lvl}.up_b"] = _np(up["up"]["bias"])
        _pair(sd, f"u{lvl}.pair", up["conv0"], us["conv0"], up["conv1"],
              us["conv1"])
        if lvl >= 2:
            ap, as_ = up["att"], us["att"]
            _pw(sd, f"u{lvl}.att.wg", ap, as_, "Wg_conv", "Wg_bn")
            _pw(sd, f"u{lvl}.att.wx", ap, as_, "Wx_conv", "Wx_bn")
            _pw(sd, f"u{lvl}.att.psi", ap, as_, "psi_conv", "psi_bn")

    sd["out_w"] = _np(p["out_conv"]["kernel"])[0, 0]
    sd["out_b"] = _np(p["out_conv"]["bias"])
    return sd


def jax_variables_to_torch(variables_np: Dict, cfg: ModelConfig = ModelConfig(),
                           device="cpu") -> AttentionASPPUNet:
    """Build the port's model on ``device`` in ``cfg.compute_dtype`` and load
    the converted weights."""
    model = AttentionASPPUNet(cfg, device=device)
    sd = {k: torch.as_tensor(np.ascontiguousarray(v))
          for k, v in torch_state_dict(variables_np, cfg).items()}
    model.load_state_dict(sd, strict=True)
    return model.eval()


def plain_unet_state_dict(variables: Dict,
                          cfg: PlainUNetConfig) -> Dict[str, np.ndarray]:
    """The port's PlainConvUNet state dict (numpy f32, nnU-Net v2 names) from
    the JAX model's params."""
    p = variables["params"]
    sd: Dict[str, np.ndarray] = {}

    def block(prefix, q):
        sd[f"{prefix}.conv.weight"] = _np(q["conv"]["kernel"]).transpose(3, 2, 0, 1)
        sd[f"{prefix}.conv.bias"] = _np(q["conv"]["bias"])
        sd[f"{prefix}.norm.weight"] = _np(q["norm"]["scale"])
        sd[f"{prefix}.norm.bias"] = _np(q["norm"]["bias"])

    n = cfg.n_stages
    for s in range(n):
        for c in range(cfg.conv_per_stage):
            block(f"encoder.stages.{s}.0.convs.{c}", p[f"enc{s}_{c}"])
    for i in range(n - 1):
        s = n - 2 - i
        # flax applies the kernel as stored, PyTorch's transposed conv the
        # spatially flipped one
        k = _np(p[f"up{s}"]["kernel"])[::-1, ::-1]            # (kh, kw, I, O)
        sd[f"decoder.transpconvs.{i}.weight"] = k.transpose(2, 3, 0, 1)
        sd[f"decoder.transpconvs.{i}.bias"] = _np(p[f"up{s}"]["bias"])
        for c in range(cfg.conv_per_stage):
            block(f"decoder.stages.{i}.convs.{c}", p[f"dec{s}_{c}"])
    head = p["seg_head"]
    sd[f"decoder.seg_layers.{n - 2}.weight"] = \
        _np(head["kernel"]).transpose(3, 2, 0, 1)
    sd[f"decoder.seg_layers.{n - 2}.bias"] = _np(head["bias"])
    return sd


def jax_plain_unet_to_torch(variables_np: Dict,
                            cfg: PlainUNetConfig = PlainUNetConfig()
                            ) -> PlainConvUNet:
    """The port's PlainConvUNet on the CPU with the weights of a JAX
    ``PlainConvUNet`` params tree (nested numpy, or a flat-npz archive read
    by ``load_npz_variables``)."""
    model = PlainConvUNet(cfg)
    sd = {k: torch.from_numpy(np.array(v, np.float32))
          for k, v in plain_unet_state_dict(variables_np, cfg).items()}
    model.load_state_dict(sd, strict=True)
    return model.eval()
