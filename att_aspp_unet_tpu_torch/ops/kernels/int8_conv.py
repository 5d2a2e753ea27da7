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
folded BatchNorm affine in f32 and ReLU, in the compute dtype again.  Two
modes keep a pair's intermediate in int8 without changing a number: the
output quantized with the next conv's scale (``s_out``), and an input that
is already quantized (an int8 ``x``).

The kernel has two paths: a wgmma one for input channels that are whole
16-byte groups (or one channel) and output channels that are a multiple of
48 wherever its tile fits, and an mma.sync one for every shape.  Each reads
the weights in an order of its own.  The CUDA source alone plans the wgmma
path (its tiles, shared memory and weight stages); :func:`prepack_int8_weight`
asks it which shapes it takes and the one number its weight order depends
on, the output channels per pass, and puts the canonical (Cout, 9*Cin)
weights into that order, once per weight set.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from . import _build
from .fused_conv import unpack_conv_weight

_MC, _KC = 64, 32          # the mma.sync path's row block and K-step (bytes)


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


def int8_epilogue(acc: torch.Tensor, w_scale: torch.Tensor,
                  s_x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    """The dequant, folded BN and ReLU of int32 accumulators (N, Cout, H, W)
    in the kernel's order, rounding where ``dtype`` rounds (bf16: the
    dequantized conv and the result; f32: nowhere)."""
    f32 = torch.float32
    fac = s_x.to(f32) * w_scale.to(f32)
    y = (acc.to(f32) * fac[None, :, None, None]).to(dtype).to(f32)
    y = _fma_f32(y, scale.to(f32)[None, :, None, None],
                 bias.to(f32)[None, :, None, None])
    return torch.relu(y).to(dtype)


def int8_conv3x3_reference(x: torch.Tensor, wq: torch.Tensor,
                           w_scale: torch.Tensor, s_x: torch.Tensor,
                           scale: torch.Tensor, bias: torch.Tensor,
                           raw: bool = False,
                           s_out: Optional[torch.Tensor] = None,
                           dtype: Optional[torch.dtype] = None
                           ) -> torch.Tensor:
    """Plain version: the exact integer conv of the quantized input (an int8
    ``x`` is taken as quantized already), then :func:`int8_epilogue` in
    ``dtype`` (default: a float ``x``'s dtype, bf16 for an int8 ``x``).
    ``raw`` returns the int32 accumulators; ``s_out`` returns the result
    quantized with it (``quantize_act``), int8."""
    xq = x if x.dtype == torch.int8 else quantize_act(x, s_x)
    acc = int_conv3x3(xq, wq)
    if raw:
        return acc
    dt = dtype or (torch.bfloat16 if x.dtype == torch.int8 else x.dtype)
    y = int8_epilogue(acc, w_scale, s_x, scale, bias, dt)
    return y if s_out is None else quantize_act(y, s_out)


# --------------------------------------------------------------- the paths

class PackedInt8(NamedTuple):
    """A conv's int8 weights in the kernel's order (1-D) and the output
    channels per pass of the wgmma path's order they are in (0: the mma.sync
    path's order)."""
    w: torch.Tensor
    rows: int = 0


def wgmma_rows(cin: int, cout: int) -> int:
    """The output channels per pass of the wgmma path's weight order for
    Cin -> Cout on the current card, 0 where the path does not take the
    shape (the kernel's plan decides both)."""
    rows = ctypes.c_int(0)
    _build.check(_lib().int8_conv3x3_wgmma_rows(cin, cout, ctypes.byref(rows)),
                 "int8_conv3x3 wgmma plan")
    return rows.value


def _prepack_mma(wq: torch.Tensor) -> torch.Tensor:
    """The mma.sync path's order: rows zero-padded to a multiple of 64 and
    cut into blocks of 64; K (the Cin channels of a tap, or the nine taps
    where Cin = 1) zero-padded to a multiple of 32 and cut into chunks;
    block-major, then chunk, each chunk ``[tap][64 rows][32]``."""
    m, cin = wq.shape[0], wq.shape[1] // 9
    taps, k = (1, 9) if cin == 1 else (9, cin)
    mpad, kpad = _round_up(m, _MC), _round_up(k, _KC)
    w3 = wq.new_zeros(mpad, taps, kpad)
    w3[:m, :, :k] = wq.reshape(m, taps, k)
    w5 = w3.reshape(mpad // _MC, _MC, taps, kpad // _KC, _KC)
    return w5.permute(0, 3, 2, 1, 4).reshape(-1).contiguous()


def _prepack_wgmma(wq: torch.Tensor, rows: int) -> torch.Tensor:
    """The wgmma path's order: one weight stage per kernel step, in step
    order (pass of ``rows`` output channels, k32 step of input channels,
    tap), each ``[tap][2][rows][16]`` (K-major core matrices: 8 output
    channels x 16 input channels), so that a stage of one tap or of three
    lies whole; where Cin = 1 one stage per pass, ``[2][rows][16]`` with K =
    the nine taps."""
    cout, cin = wq.shape[0], wq.shape[1] // 9
    passes = cout // rows
    if cin == 1:
        w = wq.new_zeros(cout, 32)
        w[:, :9] = wq
        return w.reshape(passes, rows, 2, 16).permute(0, 2, 1, 3) \
            .reshape(-1).contiguous()
    ng = _round_up(cin // 16, 2)
    w3 = wq.new_zeros(cout, 9, ng * 16)
    w3[:, :, :cin] = wq.reshape(cout, 9, cin)
    w6 = w3.reshape(passes, rows, 9, ng // 2, 2, 16)
    return w6.permute(0, 3, 2, 4, 1, 5).reshape(-1).contiguous()


def prepack_int8_weight(wq: torch.Tensor,
                        mma_sync: bool = False) -> PackedInt8:
    """(Cout, 9*Cin) int8 in (ky, kx, ci) order on a card ->
    :class:`PackedInt8`: for the wgmma path wherever it takes the shape,
    else (or with ``mma_sync``) for the mma.sync path.  Do it once per
    weight set."""
    cout, cin = wq.shape[0], wq.shape[1] // 9
    if mma_sync:
        return PackedInt8(_prepack_mma(wq))
    if wq.device.type != "cuda":
        raise ValueError("int8_conv3x3: the wgmma path's plan comes from the "
                         f"card; prepack weights on it, not on {wq.device}")
    with torch.cuda.device(wq.device):
        rows = wgmma_rows(cin, cout)
    if rows == 0:
        return PackedInt8(_prepack_mma(wq))
    return PackedInt8(_prepack_wgmma(wq, rows), rows)


def unpack_int8_prepacked(packed: PackedInt8, m: int,
                          cin: int) -> torch.Tensor:
    """Inverse of :func:`prepack_int8_weight`: the canonical weights."""
    w, rows = packed
    if rows:
        passes = m // rows
        if cin == 1:
            w4 = w.reshape(passes, 2, rows, 16).permute(0, 2, 1, 3)
            return w4.reshape(m, 32)[:, :9].contiguous()
        ng = _round_up(cin // 16, 2)
        w6 = w.reshape(passes, ng // 2, 9, 2, rows, 16)
        w3 = w6.permute(0, 4, 2, 1, 3, 5).reshape(m, 9, ng * 16)
        return w3[:, :, :cin].reshape(m, 9 * cin).contiguous()
    taps, k = (1, 9) if cin == 1 else (9, cin)
    mpad, kpad = _round_up(m, _MC), _round_up(k, _KC)
    w5 = w.reshape(mpad // _MC, kpad // _KC, taps, _MC, _KC)
    w3 = w5.permute(0, 3, 2, 1, 4).reshape(mpad, taps, kpad)
    return w3[:m, :, :k].reshape(m, 9 * cin).contiguous()


def prepack_int8_weight_numel(wq: torch.Tensor, rows: int = 0) -> int:
    """Elements of the prepacked ``wq`` for the wgmma path's ``rows`` per
    pass (0: the mma.sync path)."""
    m, cin = wq.shape[0], wq.shape[1] // 9
    if rows:
        return m * (32 if cin == 1 else 9 * _round_up(cin // 16, 2) * 16)
    k = 9 if cin == 1 else cin
    return _round_up(m, _MC) * (1 if cin == 1 else 9) * _round_up(k, _KC)


# ------------------------------------------------------------- the wrapper

def _lib():
    lib = _build.load("int8_conv3x3")
    fn = lib.int8_conv3x3_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        rows = lib.int8_conv3x3_wgmma_rows
        rows.argtypes = [ctypes.c_int, ctypes.c_int,
                         ctypes.POINTER(ctypes.c_int)]
        rows.restype = ctypes.c_int
    return lib


def _check_cuda(x, wq, w_scale, s_x, scale, bias, s_out):
    N, cin, H, W = x.shape
    cout = wq.shape[0]
    want = {"x": (x, (torch.bfloat16, torch.int8), (N, cin, H, W)),
            "wq": (wq, (torch.int8,), (cout, 9 * cin)),
            "w_scale": (w_scale, (torch.float32,), (cout,)),
            "s_x": (s_x, (torch.float32,), None),
            "scale": (scale, (torch.float32,), (cout,)),
            "bias": (bias, (torch.float32,), (cout,))}
    if s_out is not None:
        want["s_out"] = (s_out, (torch.float32,), None)
    for name, (t, dtypes, shape) in want.items():
        if t.device != x.device:
            raise ValueError(f"int8_conv3x3: {name} on {t.device}, x on "
                             f"{x.device}")
        if t.dtype not in dtypes:
            raise TypeError(f"int8_conv3x3: {name} is {t.dtype}, the kernel "
                            f"takes {' or '.join(map(str, dtypes))}")
        if shape is None and t.numel() != 1:
            raise ValueError(f"int8_conv3x3: {name} must hold one value")
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


def _check_packed(packed, wq):
    cout = wq.shape[0]
    if not isinstance(packed, PackedInt8):
        raise ValueError("int8_conv3x3: packed must come from "
                         "prepack_int8_weight")
    w, rows = packed
    if (w.device != wq.device or w.dtype != torch.int8 or w.dim() != 1
            or not w.is_contiguous() or (rows and cout % rows)
            or w.numel() != prepack_int8_weight_numel(wq, rows)):
        raise ValueError("int8_conv3x3: the prepacked weights do not match "
                         "wq")


def int8_conv3x3(x: torch.Tensor, wq: torch.Tensor, w_scale: torch.Tensor,
                 s_x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                 packed: Optional[PackedInt8] = None, raw: bool = False,
                 s_out: Optional[torch.Tensor] = None,
                 dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``relu(scale * dq(conv3x3(quantize_act(x, s_x), wq)) + bias)`` with
    ``dq(acc) = acc * (s_x * w_scale)``; zero pad 1, no bias.

    x (N, Cin, H, W), float, or int8 already quantized with ``s_x``; wq
    (Cout, 9*Cin) int8 in (ky, kx, ci) order; w_scale, scale, bias f32 per
    output channel; s_x one f32 on x's device.  ``raw`` returns the int32
    accumulators; ``s_out`` (one f32) the result quantized with it, int8;
    ``dtype`` is the compute dtype of the result (default: x's, bf16 for an
    int8 x).  On CUDA the kernel takes a bf16 or int8 x in
    ``torch.channels_last`` memory format, computes in bf16 and returns in
    the same format; it converts nothing.  ``packed`` is
    :func:`prepack_int8_weight` of ``wq`` (prepacked on the fly without it;
    its order decides the path).  CPU tensors go to the plain version.
    """
    if raw and s_out is not None:
        raise ValueError("int8_conv3x3: raw and s_out exclude each other")
    if x.device.type == "cpu":
        return int8_conv3x3_reference(x, wq, w_scale, s_x, scale, bias, raw,
                                      s_out, dtype)
    if x.device.type != "cuda":
        raise ValueError(f"int8_conv3x3: unsupported device {x.device}")
    if dtype not in (None, torch.bfloat16):
        raise TypeError(f"int8_conv3x3: the kernel computes in bf16, not "
                        f"{dtype}")
    _check_cuda(x, wq, w_scale, s_x, scale, bias, s_out)
    if packed is None:
        packed = prepack_int8_weight(wq)
    else:
        _check_packed(packed, wq)
    N, cin, H, W = x.shape
    cout = wq.shape[0]
    if not packed.rows and N * -(-cout // _MC) > 65535:
        raise ValueError(f"int8_conv3x3: {N} frames x {cout} channels is "
                         "more than one launch of the mma.sync path takes")
    out_dtype = (torch.int32 if raw else torch.int8 if s_out is not None
                 else torch.bfloat16)
    out = torch.empty((N, cout, H, W), device=x.device, dtype=out_dtype,
                      memory_format=torch.channels_last)
    if out.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.int8_conv3x3_launch(
            x.data_ptr(), packed.w.data_ptr(), s_x.data_ptr(),
            w_scale.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            None if s_out is None else s_out.data_ptr(),
            None if raw else out.data_ptr(), out.data_ptr() if raw else None,
            N, cin, cout, H, W, int(x.dtype == torch.int8), packed.rows,
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "int8_conv3x3 launch")
    int8_conv3x3.launches += 1
    return out


int8_conv3x3.launches = 0
