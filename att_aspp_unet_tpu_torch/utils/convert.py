"""JAX-package variables -> the port's modules.

``jax_variables_to_torch`` takes the nested numpy ``{"params", "batch_stats"}``
tree (``load_npz_variables`` of a flat-npz archive, or a flax variables tree
converted to numpy) and builds the port's :class:`AttentionASPPUNet`:

- 3x3 conv kernels go from HWIO to the kernel's packed (Cout, 9*Cin) layout
  in (ky, kx, ci) order;
- every BatchNorm folds to a per-channel f32 (scale, bias), eps 1e-5;
- ConvTranspose kernels are pre-flipped spatially (flax applies the reversed
  kernel), so the port's up-conv indexes them forward;
- the ASPP's dilated kernels and the ``--no_aspp`` bridge conv go to OIHW
  for ``F.conv2d``;
- the tree is read as the config's variant reads it (v1 or v2 gates, the
  ungated levels, ASPP or ``bridge_conv``); subtrees the variant does not
  use are ignored, as flax's ``apply`` ignores them;
- with ``conv_lowering="int8"`` the tree carries the JAX ``quant``
  collection: each 3x3 ConvBNReLU site's calibrated ``act_absmax`` and
  either a float kernel (quantized here, ``nn/quant.py``) or the
  prequantized form the JAX engine keeps and ``save_npz_variables`` stores,
  an int8 kernel with its ``w_scale``.  :func:`quant_tree` is the inverse:
  the int8 model's scales as that collection.

``jax_variables_to_train_model`` and ``train_model_to_jax_variables`` carry
the same tree to and from the trainable ``AttentionASPPUNetTrain``, whose
state-dict keys are the flax paths joined by dots: a transpose per leaf
(HWIO -> OIHW; the transposed conv's kernel flipped into PyTorch's (in, out,
kh, kw)), exact both ways.

``init_variables`` draws a seeded variables tree in the JAX layout for any
variant (the template of non-strict ``.pt`` import, and the weights of runs
that have no checkpoint).

``jax_plain_unet_to_torch`` does the same for the baseline's
``PlainConvUNet``, into the port's nnU-Net-named module: HWIO -> OIHW, the
transposed convs' kernels flipped into PyTorch's (in, out, kh, kw) layout,
InstanceNorm scale/bias -> weight/bias (the inverse of the JAX package's
``utils/nnunet_import.py`` mapping).
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from ..config import ModelConfig, PlainUNetConfig
from ..models.att_aspp_unet import AttentionASPPUNet, gated
from ..models.att_aspp_unet_train import AttentionASPPUNetTrain
from ..models.plain_unet import PlainConvUNet
from ..nn.quant import (act_scale, conv_sites, merge_quant, prequantize,
                        tree_get, tree_set)
from ..ops.kernels.fused_conv import fold_batchnorm, pack_conv_weight


def _np(a) -> np.ndarray:
    return np.asarray(a, np.float32)


def _bn(p, s):
    return fold_batchnorm(p["scale"], p["bias"], s["mean"], s["var"])


def _int8_conv(sd, key, i, p, quant, site):
    """One int8 site's buffers ``{key}w{i}``, ``w_scale{i}``,
    ``act_absmax{i}``, ``s_x{i}``: the prequantized kernel packed, its
    ``w_scale``, the activation scale from ``act_absmax``."""
    node = tree_get(quant, site)
    amax = np.asarray(node["act_absmax"], np.float32)
    sd[f"{key}w{i}"] = pack_conv_weight(p["conv"]["kernel"])
    sd[f"{key}w_scale{i}"] = np.asarray(node["w_scale"], np.float32)
    sd[f"{key}act_absmax{i}"], sd[f"{key}s_x{i}"] = amax, act_scale(amax)


def _pair(sd, prefix, p0, s0, p1, s1, quant=None, sites=(None, None)):
    for i, p, st, site in ((1, p0, s0, sites[0]), (2, p1, s1, sites[1])):
        if quant is None:
            sd[f"{prefix}.w{i}"] = pack_conv_weight(_np(p["conv"]["kernel"]))
        else:
            _int8_conv(sd, f"{prefix}.", i, p, quant, site)
        sd[f"{prefix}.s{i}"], sd[f"{prefix}.b{i}"] = _bn(p["bn"], st["bn"])


def _quant_of(variables: Dict, cfg: ModelConfig):
    """The ``quant`` collection an int8 model needs (None for a direct
    one); ValueError when a site lacks its calibrated ``act_absmax``."""
    if cfg.conv_lowering != "int8":
        return None
    quant = variables.get("quant") or {}
    for site in conv_sites(cfg.use_aspp):
        try:
            tree_get(quant, site)["act_absmax"]
        except (KeyError, TypeError):
            raise ValueError(
                f"conv_lowering='int8' needs the calibrated quant collection "
                f"(act_absmax of every 3x3 conv site; {site} has none): "
                "calibrate it with AttAsppEngine or pass the JAX engine's "
                "variables") from None
    return quant


def _pw(sd, prefix, p, s, conv, bn):
    sd[f"{prefix}_w"] = _np(p[conv]["kernel"])[0, 0]
    sd[f"{prefix}_s"], sd[f"{prefix}_b"] = _bn(p[bn], s[bn])


def torch_state_dict(variables: Dict, cfg: ModelConfig) -> Dict[str, np.ndarray]:
    """The port's state dict (numpy f32 arrays) from JAX variables, for the
    variant ``cfg`` describes."""
    p, s = variables["params"], variables["batch_stats"]
    quant = _quant_of(variables, cfg)
    if quant is not None:
        # int8 kernels at every site, their scales beside the calibration
        # (kernels that are int8 already keep the w_scale they came with)
        p, w_scales = prequantize(p, cfg.use_aspp)
        quant = merge_quant(quant, w_scales)
    sd: Dict[str, np.ndarray] = {}
    for lvl in (1, 2, 3, 4):
        _pair(sd, f"d{lvl}", p[f"d{lvl}_0"], s[f"d{lvl}_0"],
              p[f"d{lvl}_1"], s[f"d{lvl}_1"], quant,
              (f"d{lvl}_0/conv", f"d{lvl}_1/conv"))

    if cfg.use_aspp:
        bp, bs = p["bridge"], s["bridge"]
        _pw(sd, "bridge.b0", bp, bs, "branch0_conv", "branch0_bn")
        for i in range(len(cfg.aspp_rates)):
            k = _np(bp[f"branch{i + 1}_conv"]["kernel"])          # HWIO
            sd[f"bridge.rate{i}_w"] = k.transpose(3, 2, 0, 1)      # OIHW
            sd[f"bridge.rate{i}_s"], sd[f"bridge.rate{i}_b"] = _bn(
                bp[f"branch{i + 1}_bn"], bs[f"branch{i + 1}_bn"])
        _pw(sd, "bridge.pool", bp, bs, "pool_conv", "pool_bn")
        _pw(sd, "bridge.proj", bp, bs, "project_conv", "project_bn")
    else:
        bp, bs = p["bridge_conv"], s["bridge_conv"]
        if quant is None:
            sd["bridge_conv.w"] = _np(bp["conv"]["kernel"]).transpose(
                3, 2, 0, 1)
        else:
            _int8_conv(sd, "bridge_conv.", "", bp, quant, "bridge_conv/conv")
        sd["bridge_conv.s"], sd["bridge_conv.b"] = _bn(bp["bn"], bs["bn"])

    for lvl in (4, 3, 2, 1):
        up, us = p[f"u{lvl}"], s[f"u{lvl}"]
        sd[f"u{lvl}.up_k"] = _np(up["up"]["kernel"])[::-1, ::-1]
        sd[f"u{lvl}.up_b"] = _np(up["up"]["bias"])
        _pair(sd, f"u{lvl}.pair", up["conv0"], us["conv0"], up["conv1"],
              us["conv1"], quant,
              (f"u{lvl}/conv0/conv", f"u{lvl}/conv1/conv"))
        if not gated(cfg, lvl):
            continue
        ap = up["att"]
        if cfg.gate_variant == "v1":
            as_ = us["att"]
            _pw(sd, f"u{lvl}.att.wg", ap, as_, "Wg_conv", "Wg_bn")
            _pw(sd, f"u{lvl}.att.wx", ap, as_, "Wx_conv", "Wx_bn")
            _pw(sd, f"u{lvl}.att.psi", ap, as_, "psi_conv", "psi_bn")
        else:
            for name, key in (("wg", "Wg"), ("wx", "Wx"), ("psi", "psi")):
                sd[f"u{lvl}.att.{name}_w"] = _np(ap[key]["kernel"])[0, 0]
            sd[f"u{lvl}.att.psi_b"] = _np(ap["psi"]["bias"])

    sd["out_w"] = _np(p["out_conv"]["kernel"])[0, 0]
    sd["out_b"] = _np(p["out_conv"]["bias"])
    return sd


def quant_tree(model: AttentionASPPUNet) -> Dict:
    """The JAX ``quant`` collection of an int8 model (nested numpy: per
    site ``act_absmax`` and ``w_scale``), the inverse of what
    :func:`jax_variables_to_torch` reads, so that the JAX package serves
    the port's calibration without calibrating again."""
    if model.cfg.conv_lowering != "int8":
        raise ValueError("quant_tree: the model is not an int8 one")
    tree: Dict = {}
    for m, sites in model.site_modules():
        suffixes = [""] if len(sites) == 1 else ["1", "2"]
        for site, i in zip(sites, suffixes):
            for leaf in ("act_absmax", "w_scale"):
                tree_set(tree, site, leaf, getattr(m, f"{leaf}{i}").detach()
                         .to("cpu", torch.float32).numpy().copy())
    return tree


def _variable_layout(cfg: ModelConfig
                     ) -> Iterator[Tuple[str, Tuple[str, ...], tuple]]:
    """(collection, path, shape) of every leaf of the flax model's variables
    for the variant ``cfg``, as ``model.init`` lays them out."""
    c = cfg.base_c

    def conv(path, shape, bias=False):
        yield "params", path + ("kernel",), shape
        if bias:
            yield "params", path + ("bias",), (shape[-1],)

    def bn(path, ch):
        for coll, leaf in (("params", "scale"), ("params", "bias"),
                           ("batch_stats", "mean"), ("batch_stats", "var")):
            yield coll, path + (leaf,), (ch,)

    def cbr(path, cin, cout):
        yield from conv(path + ("conv",), (3, 3, cin, cout))
        yield from bn(path + ("bn",), cout)

    widths = {1: c, 2: 2 * c, 3: 4 * c, 4: 8 * c}
    cin = cfg.in_channels
    for lvl in (1, 2, 3, 4):
        yield from cbr((f"d{lvl}_0",), cin, widths[lvl])
        yield from cbr((f"d{lvl}_1",), widths[lvl], widths[lvl])
        cin = widths[lvl]
    if cfg.use_aspp:
        f, br = 16 * c, ("bridge",)
        yield from conv(br + ("branch0_conv",), (1, 1, 8 * c, f))
        yield from bn(br + ("branch0_bn",), f)
        for i in range(1, len(cfg.aspp_rates) + 1):
            yield from conv(br + (f"branch{i}_conv",), (3, 3, 8 * c, f))
            yield from bn(br + (f"branch{i}_bn",), f)
        yield from conv(br + ("pool_conv",), (1, 1, 8 * c, f))
        yield from bn(br + ("pool_bn",), f)
        yield from conv(br + ("project_conv",),
                        (1, 1, (len(cfg.aspp_rates) + 2) * f, f))
        yield from bn(br + ("project_bn",), f)
    else:
        yield from cbr(("bridge_conv",), 8 * c, 16 * c)
    g = 16 * c
    for lvl in (4, 3, 2, 1):
        f, u = widths[lvl], (f"u{lvl}",)
        yield from conv(u + ("up",), (2, 2, g, f), bias=True)
        if gated(cfg, lvl) and cfg.gate_variant == "v1":
            for name, ci, co in (("Wg", f, f // 2), ("Wx", f, f // 2),
                                 ("psi", f // 2, 1)):
                yield from conv(u + ("att", f"{name}_conv"), (1, 1, ci, co))
                yield from bn(u + ("att", f"{name}_bn"), co)
        elif gated(cfg, lvl):
            fint = max(8, f // 4)
            yield from conv(u + ("att", "Wg"), (1, 1, f, fint))
            yield from conv(u + ("att", "Wx"), (1, 1, f, fint))
            yield from conv(u + ("att", "psi"), (1, 1, fint, 1), bias=True)
        yield from cbr(u + ("conv0",), 2 * f, f)
        yield from cbr(u + ("conv1",), f, f)
        g = f
    yield from conv(("out_conv",), (1, 1, c, cfg.num_classes), bias=True)


def init_variables(cfg: ModelConfig, seed: int = 0) -> Dict:
    """A seeded ``{"params", "batch_stats"}`` numpy tree in the JAX layout
    for the variant ``cfg``: the keys and shapes of flax's ``model.init``,
    with flax's default initialisers drawn from a CPU ``torch.Generator``
    (kernels LeCun-normal truncated at two standard deviations, variance
    1 / fan-in over the input channels and taps; biases, BN bias and mean
    0; BN scale and var 1).  The numbers are not those of
    ``model.init(PRNGKey(seed))`` of the JAX package."""
    gen = torch.Generator().manual_seed(int(seed))
    out: Dict = {"params": {}, "batch_stats": {}}
    for coll, path, shape in _variable_layout(cfg):
        leaf = path[-1]
        if leaf == "kernel":
            std = math.sqrt(1.0 / math.prod(shape[:-1])) / 0.87962566103423978
            t = torch.empty(shape, dtype=torch.float32)
            torch.nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                        generator=gen)
            value = t.numpy()
        else:
            value = np.full(shape, 1.0 if leaf in ("scale", "var") else 0.0,
                            np.float32)
        node = out[coll]
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[leaf] = value
    return out


def jax_variables_to_torch(variables_np: Dict, cfg: ModelConfig = ModelConfig(),
                           device="cpu") -> AttentionASPPUNet:
    """Build the port's model on ``device`` in ``cfg.compute_dtype`` and load
    the converted weights."""
    model = AttentionASPPUNet(cfg, device=device)
    sd = {k: torch.as_tensor(np.ascontiguousarray(v))
          for k, v in torch_state_dict(variables_np, cfg).items()}
    model.load_state_dict(sd, strict=True)
    return model.eval()


def _leaf_to_torch(path: Tuple[str, ...], a: np.ndarray) -> np.ndarray:
    """A flax leaf in the train model's layout."""
    if path[-1] == "kernel" and a.ndim == 4:
        if path[-2] == "up":                       # ConvTranspose
            return a[::-1, ::-1].transpose(2, 3, 0, 1)
        return a.transpose(3, 2, 0, 1)             # HWIO -> OIHW
    return a


def _leaf_to_jax(path: Tuple[str, ...], a: np.ndarray) -> np.ndarray:
    """The inverse of :func:`_leaf_to_torch`."""
    if path[-1] == "kernel" and a.ndim == 4:
        if path[-2] == "up":
            return a.transpose(2, 3, 0, 1)[::-1, ::-1]
        return a.transpose(2, 3, 1, 0)
    return a


def jax_variables_to_train_model(variables_np: Dict, cfg: ModelConfig,
                                 device="cpu") -> AttentionASPPUNetTrain:
    """The trainable model of the variant ``cfg`` on ``device`` holding the
    flax ``params`` + ``batch_stats`` tree (nested numpy); subtrees the
    variant does not use are ignored, as flax's ``apply`` ignores them."""
    model = AttentionASPPUNetTrain(cfg, device=device)
    sd = {}
    for coll, path, shape in _variable_layout(cfg):
        node = variables_np[coll]
        for key in path:
            node = node[key]
        a = np.array(node, np.float32)             # a writable copy
        if a.shape != shape:
            raise ValueError(f"{coll}/{'/'.join(path)}: shape {a.shape}, the "
                             f"variant has {shape}")
        sd[".".join(path)] = torch.from_numpy(
            np.ascontiguousarray(_leaf_to_torch(path, a)))
    model.load_state_dict(sd, strict=True)
    return model


def torch_tensors_to_jax(named: Dict[str, torch.Tensor],
                         cfg: ModelConfig) -> Dict:
    """Named tensors of the train model (its state dict, or gradients keyed
    by parameter name) -> the nested ``{"params", "batch_stats"}`` numpy tree
    in the JAX layout; collections without a tensor are left empty."""
    out: Dict = {"params": {}, "batch_stats": {}}
    for coll, path, _ in _variable_layout(cfg):
        t = named.get(".".join(path))
        if t is None:
            continue
        node = out[coll]
        for key in path[:-1]:
            node = node.setdefault(key, {})
        a = t.detach().to("cpu", torch.float32).numpy()
        node[path[-1]] = np.ascontiguousarray(_leaf_to_jax(path, a))
    return out


def checkpoint_variables(state_dict: Dict[str, torch.Tensor],
                         cfg: ModelConfig) -> Dict:
    """The JAX-layout variables of the variant ``cfg`` from a train model's
    state dict (a checkpoint's ``model``); ValueError when the checkpoint
    lacks a leaf of that variant."""
    for _, path, shape in _variable_layout(cfg):
        t = state_dict.get(".".join(path))
        got = None if t is None else _leaf_to_jax(path, t.cpu().numpy()).shape
        if got != shape:
            raise ValueError(f"{'.'.join(path)}: {got or 'missing'} in the "
                             f"checkpoint, the configured variant has "
                             f"{shape}; check --base_c, --gate, --no_att, "
                             "--no_aspp, --att_depth")
    return torch_tensors_to_jax(state_dict, cfg)


def train_model_to_jax_variables(model: AttentionASPPUNetTrain) -> Dict:
    """The flax ``params`` + ``batch_stats`` tree (nested numpy f32) of a
    train model: the inverse of :func:`jax_variables_to_train_model`."""
    return torch_tensors_to_jax(model.state_dict(), model.cfg)


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
