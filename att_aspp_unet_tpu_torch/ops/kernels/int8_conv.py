"""int8 3x3 conv + dequant + folded BN + ReLU: kernel K3, its wrapper and
its plain PyTorch version.

Counterpart of the JAX package's int8 serving conv, which XLA computes
outside any Pallas kernel (``att_aspp_unet_tpu/nn/quant.py::
int8_conv3x3_pre`` followed by ``ConvBNReLU``'s BatchNorm and ReLU).  The
kernel is ``csrc/int8_conv3x3.cu`` (design notes there);
:func:`int8_conv3x3` launches it for CUDA tensors and runs
:func:`int8_conv3x3_reference` for CPU tensors.

The function, in the JAX package's order of roundings: the input quantized
per tensor (``quantize_act``: ``x / s_x`` divided, rounded half to even,
clipped to +-127), the conv of the int8 values with int32 accumulation, the
dequant ``f32(acc) * (s_x * s_w[c])`` rounded to the compute dtype, then the
folded BatchNorm affine in f32 and ReLU, in the compute dtype again.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from . import _build
from .fused_conv import unpack_conv_weight

_MC, _KC = 64, 32          # the kernel's row block and K-step (bytes)


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def quantize_act(x: torch.Tensor, s_x: torch.Tensor) -> torch.Tensor:
    """Per-tensor symmetric int8: ``clip(round(x / s_x), -127, 127)``, the
    division a true one (``s_x`` a tensor on x's device, so that PyTorch
    does not multiply by its reciprocal), rounding half to even."""
    q = torch.round(x.to(torch.float32) / s_x.to(torch.float32))
    return q.clamp_(-127, 127).to(torch.int8)


def int_conv3x3(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """Exact integer 3x3 SAME conv: int8 (N, Cin, H, W) x int8 (Cout, 9*Cin)
    packed -> int32 (N, Cout, H, W).  Computed as an f64 convolution and
    rounded: every product and partial sum is an integer below 9 * Cin *
    127^2 < 2^31, so whatever order or algorithm the library picks, its f64
    error stays far below 0.5 and the rounding recovers the exact sum."""
    f64 = torch.float64
    w = unpack_conv_weight(wq.to(f64), xq.shape[1])
    y = F.conv2d(xq.to(f64).contiguous(), w.contiguous(), padding=1)
    return torch.round(y).to(torch.int32)


def _fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """f32 ``a * b + c`` with the product exact (f64), as the kernel's fmaf."""
    f64 = torch.float64
    return (a.to(f64) * b.to(f64) + c.to(f64)).to(torch.float32)


def int8_conv3x3_reference(x: torch.Tensor, wq: torch.Tensor,
                           w_scale: torch.Tensor, s_x: torch.Tensor,
                           scale: torch.Tensor, bias: torch.Tensor,
                           raw: bool = False) -> torch.Tensor:
    """Plain version: the exact integer conv of the quantized input, then
    the epilogue in the kernel's order, rounding where ``x.dtype`` rounds
    (bf16: the dequantized conv and the result; f32: nowhere).  ``raw``
    returns the int32 accumulators."""
    f32, dt = torch.float32, x.dtype
    acc = int_conv3x3(quantize_act(x, s_x), wq)
    if raw:
        return acc
    fac = s_x.to(f32) * w_scale.to(f32)
    y = (acc.to(f32) * fac[None, :, None, None]).to(dt).to(f32)
    y = _fma_f32(y, scale.to(f32)[None, :, None, None],
                 bias.to(f32)[None, :, None, None])
    return torch.relu(y).to(dt)


def prepack_int8_weight(wq: torch.Tensor) -> torch.Tensor:
    """(Cout, 9*Cin) int8 in (ky, kx, ci) order -> the kernel's order, 1-D:
    rows zero-padded to a multiple of 64 and cut into blocks of 64; K (the
    Cin channels of a tap, or the nine taps where Cin = 1) zero-padded to a
    multiple of 32 and cut into chunks; block-major, then chunk, each chunk
    ``[tap][64 rows][32]`` contiguous."""
    m, cin = wq.shape[0], wq.shape[1] // 9
    taps, k = (1, 9) if cin == 1 else (9, cin)
    mpad, kpad = _round_up(m, _MC), _round_up(k, _KC)
    w3 = wq.new_zeros(mpad, taps, kpad)
    w3[:m, :, :k] = wq.reshape(m, taps, k)
    w5 = w3.reshape(mpad // _MC, _MC, taps, kpad // _KC, _KC)
    return w5.permute(0, 3, 2, 1, 4).reshape(-1).contiguous()


def unpack_int8_prepacked(packed: torch.Tensor, m: int,
                          cin: int) -> torch.Tensor:
    """Inverse of :func:`prepack_int8_weight`."""
    taps, k = (1, 9) if cin == 1 else (9, cin)
    mpad, kpad = _round_up(m, _MC), _round_up(k, _KC)
    w5 = packed.reshape(mpad // _MC, kpad // _KC, taps, _MC, _KC)
    w3 = w5.permute(0, 3, 2, 1, 4).reshape(mpad, taps, kpad)
    return w3[:m, :, :k].reshape(m, 9 * cin).contiguous()


def _lib():
    lib = _build.load("int8_conv3x3")
    fn = lib.int8_conv3x3_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check_cuda(x, wq, w_scale, s_x, scale, bias):
    N, cin, H, W = x.shape
    cout = wq.shape[0]
    want = {"x": (x, torch.bfloat16, (N, cin, H, W)),
            "wq": (wq, torch.int8, (cout, 9 * cin)),
            "w_scale": (w_scale, torch.float32, (cout,)),
            "s_x": (s_x, torch.float32, None),
            "scale": (scale, torch.float32, (cout,)),
            "bias": (bias, torch.float32, (cout,))}
    for name, (t, dtype, shape) in want.items():
        if t.device != x.device:
            raise ValueError(f"int8_conv3x3: {name} on {t.device}, x on "
                             f"{x.device}")
        if t.dtype != dtype:
            raise TypeError(f"int8_conv3x3: {name} is {t.dtype}, the kernel "
                            f"takes {dtype}")
        if shape is None and t.numel() != 1:
            raise ValueError("int8_conv3x3: s_x must hold one value")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"int8_conv3x3: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
        if name != "x" and not t.is_contiguous():
            raise ValueError(f"int8_conv3x3: {name} is not contiguous")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(
            "int8_conv3x3: x must be in torch.channels_last memory format "
            f"(NHWC strides); got strides {tuple(x.stride())} for shape "
            f"{tuple(x.shape)}")
    if x.data_ptr() % 16:
        raise ValueError("int8_conv3x3: x is not aligned to 16 bytes")
    if N * -(-cout // _MC) > 65535:
        raise ValueError(f"int8_conv3x3: {N} frames x {cout} channels is "
                         "more than one launch takes")


def int8_conv3x3(x: torch.Tensor, wq: torch.Tensor, w_scale: torch.Tensor,
                 s_x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                 packed: Optional[torch.Tensor] = None,
                 raw: bool = False) -> torch.Tensor:
    """``relu(scale * dq(conv3x3(quantize_act(x, s_x), wq)) + bias)`` with
    ``dq(acc) = acc * (s_x * w_scale)``; zero pad 1, no bias.

    x (N, Cin, H, W); wq (Cout, 9*Cin) int8 in (ky, kx, ci) order; w_scale,
    scale, bias f32 per output channel; s_x one f32 on x's device.  On CUDA
    the kernel takes a bf16 x in ``torch.channels_last`` memory format and
    returns bf16 in the same format (``raw``: the int32 accumulators, in
    the same format); it converts nothing.  ``packed`` is
    :func:`prepack_int8_weight` of ``wq`` (prepacked on the fly without
    it).  CPU tensors go to the plain version.
    """
    if x.device.type == "cpu":
        return int8_conv3x3_reference(x, wq, w_scale, s_x, scale, bias, raw)
    if x.device.type != "cuda":
        raise ValueError(f"int8_conv3x3: unsupported device {x.device}")
    _check_cuda(x, wq, w_scale, s_x, scale, bias)
    if packed is None:
        packed = prepack_int8_weight(wq)
    elif (packed.device != wq.device or packed.dtype != torch.int8
          or packed.numel() != prepack_int8_weight_numel(wq)):
        raise ValueError("int8_conv3x3: the prepacked weights do not match "
                         "wq")
    N, cin, H, W = x.shape
    cout = wq.shape[0]
    out = torch.empty((N, cout, H, W), device=x.device,
                      dtype=torch.int32 if raw else torch.bfloat16,
                      memory_format=torch.channels_last)
    if out.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.int8_conv3x3_launch(
            x.data_ptr(), packed.data_ptr(), s_x.data_ptr(),
            w_scale.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            None if raw else out.data_ptr(), out.data_ptr() if raw else None,
            N, cin, cout, H, W,
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "int8_conv3x3 launch")
    int8_conv3x3.launches += 1
    return out


int8_conv3x3.launches = 0


def prepack_int8_weight_numel(wq: torch.Tensor) -> int:
    """Elements of :func:`prepack_int8_weight` of ``wq``."""
    m, cin = wq.shape[0], wq.shape[1] // 9
    k = 9 if cin == 1 else cin
    return _round_up(m, _MC) * (1 if cin == 1 else 9) * _round_up(k, _KC)
