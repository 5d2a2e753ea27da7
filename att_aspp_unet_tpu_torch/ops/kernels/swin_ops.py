"""The Swin UNETR network's normalisations and stem: the LayerNorm over
each token's channels (optionally after a residual add), the InstanceNorm
with its residual and LeakyReLU, and the first conv block's 3x3 and 1x1
convs of the 1-channel input, as one CUDA source (``csrc/swin_ops.cu``) and
their plain PyTorch versions.

They replace no TPU kernel (the JAX package has no such network).  All are
bound by bytes: see the source for what PyTorch's own ops cost here and what
the kernels do about it.  CPU tensors go to the plain versions; a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build

VEC = 8                       # channels in one 16-byte load
LN_MAX_CHANNELS = 3072        # the widest row the LayerNorm kernel takes
IN_MAX_CHANNELS = 2048        # the InstanceNorm statistics' widest map
THREADS = 256
# pixels each statistics thread sums before the block's runs are added up
IN_PIXELS_PER_LANE = 16


def layer_norm_reference(x: torch.Tensor, weight: Optional[torch.Tensor],
                         bias: Optional[torch.Tensor], eps: float,
                         residual: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(s, y): s = x + residual in x's dtype (x itself without one), y its
    LayerNorm over the last axis in f32, the affine in f32, cast to x's
    dtype."""
    s = x if residual is None else x + residual
    f = s.float()
    mean = f.mean(-1, keepdim=True)
    var = (f - mean).square().mean(-1, keepdim=True)
    y = (f - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight.float() + bias.float()
    return s, y.to(x.dtype)


def instance_norm_act_reference(x: torch.Tensor, norm,
                                slope: Optional[float] = None,
                                residual: Optional[torch.Tensor] = None,
                                residual_norm=None) -> torch.Tensor:
    """``act(IN(x) + r)`` on (B, C, H, W): IN with ``norm``'s affine and eps
    from one-pass statistics in f32 (var = E[x^2] - mean^2), r =
    IN'(residual) with ``residual_norm``, the residual itself without one,
    or 0; act = LeakyReLU(slope) unless ``slope`` is None; f32 throughout,
    cast once to x's dtype."""
    def affine(t, m):
        f = t.float()
        n = f.shape[2] * f.shape[3]
        mean = f.mean((2, 3), keepdim=True)
        var = (f.square().sum((2, 3), keepdim=True) / n
               - mean.square()).clamp_(min=0.0)
        scale = torch.rsqrt(var + m.eps) * m.weight.float()[:, None, None]
        return f * scale + (m.bias.float()[:, None, None] - mean * scale)

    y = affine(x, norm)
    if residual is not None:
        y = y + (residual.float() if residual_norm is None
                 else affine(residual, residual_norm))
    if slope is not None:
        y = torch.where(y > 0, y, y * slope)
    return y.to(x.dtype)


def stem_convs_reference(x: torch.Tensor, w3: torch.Tensor,
                         w1: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(conv3x3(x, w3) with zero padding 1, conv1x1(x, w1) or None) of a
    1-channel x (B, 1, H, W), no bias, summed in f32 and cast once to x's
    dtype."""
    f = x.float()
    y = F.conv2d(f, w3.float(), padding=1).to(x.dtype)
    r = None if w1 is None else F.conv2d(f, w1.float()).to(x.dtype)
    return y, r


def _lib():
    lib = _build.load("swin_ops")
    if lib.swin_layer_norm_launch.argtypes is None:
        p, ll, i, f = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_float)
        lib.swin_layer_norm_launch.argtypes = [p] * 6 + [ll, i, f, p]
        lib.swin_instance_stats_launch.argtypes = (
            [p] * 7 + [ll, ll, i, ll, i, f, p])
        lib.swin_instance_apply_launch.argtypes = (
            [p] * 7 + [ll, ll, i, i, f, i, p])
        lib.swin_stem_launch.argtypes = [p] * 5 + [ll, i, i, i, i, p]
        for fn in (lib.swin_layer_norm_launch, lib.swin_instance_stats_launch,
                   lib.swin_instance_apply_launch, lib.swin_stem_launch):
            fn.restype = ctypes.c_int
    return lib


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check(name: str, t: torch.Tensor, like: torch.Tensor, dtype,
           channels_last: bool = False) -> None:
    if t.device != like.device:
        raise ValueError(f"{name} on {t.device}, expected {like.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} is {t.dtype}, the kernel takes {dtype}")
    ok = (t.is_contiguous(memory_format=torch.channels_last) if channels_last
          else t.is_contiguous())
    if not ok:
        layout = "channel-last" if channels_last else "contiguous"
        raise ValueError(f"{name} is not {layout}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} is not 16-byte aligned")


def layer_norm(x: torch.Tensor, weight: Optional[torch.Tensor],
               bias: Optional[torch.Tensor], eps: float,
               residual: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(s, y) as :func:`layer_norm_reference`: x (..., C) bf16 contiguous on a
    card, C a multiple of 8 up to 3072, ``weight`` / ``bias`` (C,) bf16 or
    both None."""
    if x.device.type == "cpu":
        return layer_norm_reference(x, weight, bias, eps, residual)
    C = x.shape[-1]
    if C % VEC or C > LN_MAX_CHANNELS:
        raise ValueError(f"swin layer_norm: {C} channels; the kernel takes "
                         f"multiples of {VEC} up to {LN_MAX_CHANNELS}")
    _check("x", x, x, torch.bfloat16)
    for name, t in (("residual", residual), ("weight", weight),
                    ("bias", bias)):
        if t is not None:
            _check(name, t, x, torch.bfloat16)
    if (weight is None) != (bias is None):
        raise ValueError("swin layer_norm: weight and bias come together")
    if residual is not None and residual.shape != x.shape:
        raise ValueError("swin layer_norm: residual of another shape")
    y = torch.empty_like(x)
    s = x if residual is None else torch.empty_like(x)
    rows = x.numel() // C
    if rows:
        with torch.cuda.device(x.device):
            err = _lib().swin_layer_norm_launch(
                x.data_ptr(), _ptr(residual),
                None if residual is None else s.data_ptr(), _ptr(weight),
                _ptr(bias), y.data_ptr(), rows, C, float(eps), _stream(x))
        _build.check(err, "swin layer_norm launch")
        layer_norm.launches += 1
    return s, y


layer_norm.launches = 0


def _stats(x: torch.Tensor, norm, lib) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scale, shift) (B, C) f32 of ``norm`` on channel-last x."""
    B, C, H, W = x.shape
    hw = H * W
    lanes = THREADS // (C // VEC)
    run = lanes * IN_PIXELS_PER_LANE
    runs = -(-hw // run)
    part = torch.empty((2, B, runs, C), dtype=torch.float32, device=x.device)
    out = torch.empty((2, B, C), dtype=torch.float32, device=x.device)
    _check("norm weight", norm.weight, x, torch.float32)
    _check("norm bias", norm.bias, x, torch.float32)
    err = lib.swin_instance_stats_launch(
        x.data_ptr(), part[0].data_ptr(), part[1].data_ptr(),
        norm.weight.data_ptr(), norm.bias.data_ptr(), out[0].data_ptr(),
        out[1].data_ptr(), B, hw, C, run, runs, float(norm.eps), _stream(x))
    _build.check(err, "swin instance_norm statistics launch")
    return out[0], out[1]


def instance_norm_act(x: torch.Tensor, norm, slope: Optional[float] = None,
                      residual: Optional[torch.Tensor] = None,
                      residual_norm=None) -> torch.Tensor:
    """As :func:`instance_norm_act_reference`: x (B, C, H, W) bf16 in
    channel-last memory on a card (C a multiple of 8 up to 2048), the
    residual likewise, the norms' affine f32.  Two statistics launches per
    norm and one pass that writes the result."""
    if x.device.type == "cpu":
        return instance_norm_act_reference(x, norm, slope, residual,
                                           residual_norm)
    B, C, H, W = x.shape
    if C % VEC or C > IN_MAX_CHANNELS:
        raise ValueError(f"swin instance_norm: {C} channels; the kernel "
                         f"takes multiples of {VEC} up to {IN_MAX_CHANNELS}")
    _check("x", x, x, torch.bfloat16, channels_last=True)
    if residual is not None:
        _check("residual", residual, x, torch.bfloat16, channels_last=True)
        if residual.shape != x.shape:
            raise ValueError("swin instance_norm: residual of another shape")
    y = torch.empty_like(x, memory_format=torch.channels_last)
    if x.numel() == 0:
        return y
    with torch.cuda.device(x.device):
        lib = _lib()
        scale, shift = _stats(x, norm, lib)
        rscale = rshift = None
        if residual is not None and residual_norm is not None:
            rscale, rshift = _stats(residual, residual_norm, lib)
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        err = lib.swin_instance_apply_launch(
            x.data_ptr(), scale.data_ptr(), shift.data_ptr(), _ptr(residual),
            _ptr(rscale), _ptr(rshift), y.data_ptr(), B, H * W, C,
            int(slope is not None), float(slope or 0.0), sms, _stream(x))
    _build.check(err, "swin instance_norm apply launch")
    instance_norm_act.launches += 1
    return y


instance_norm_act.launches = 0


def stem_convs(x: torch.Tensor, w3: torch.Tensor,
               w1: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """As :func:`stem_convs_reference`: x (B, 1, H, W) bf16 contiguous on a
    card, w3 (Cout, 1, 3, 3), w1 (Cout, 1, 1, 1), Cout a multiple of 8; the
    outputs in channel-last memory, in one pass."""
    if x.device.type == "cpu":
        return stem_convs_reference(x, w3, w1)
    B, cin, H, W = x.shape
    cout = w3.shape[0]
    if cin != 1 or tuple(w3.shape[1:]) != (1, 3, 3) or cout % VEC or (
            w1 is not None and tuple(w1.shape) != (cout, 1, 1, 1)):
        raise ValueError(f"swin stem: input {tuple(x.shape)}, weights "
                         f"{tuple(w3.shape)} and "
                         f"{None if w1 is None else tuple(w1.shape)}; the "
                         "kernel takes one input channel and a multiple of "
                         f"{VEC} outputs")
    _check("x", x, x, torch.bfloat16)
    taps = w3.float().reshape(cout, 9).t().contiguous()
    one = None if w1 is None else w1.float().reshape(cout).contiguous()
    y = torch.empty((B, cout, H, W), dtype=x.dtype, device=x.device,
                    memory_format=torch.channels_last)
    r = None if w1 is None else torch.empty_like(y)
    if y.numel():
        with torch.cuda.device(x.device):
            sms = torch.cuda.get_device_properties(
                x.device).multi_processor_count
            err = _lib().swin_stem_launch(
                x.data_ptr(), taps.data_ptr(), _ptr(one), y.data_ptr(),
                _ptr(r), B, H, W, cout, sms, _stream(x))
        _build.check(err, "swin stem launch")
        stem_convs.launches += 1
    return y, r


stem_convs.launches = 0
