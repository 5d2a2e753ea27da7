"""Fused double Conv3x3 + folded-BN + ReLU: kernel K1, its wrapper and its
plain PyTorch version.

Counterpart of ``att_aspp_unet_tpu/ops/pallas/fused_conv.py``.  The kernel is
``csrc/fused_double_cbr.cu`` (design notes there); :func:`fused_double_cbr`
launches it for CUDA tensors and runs :func:`fused_double_cbr_reference` for
CPU tensors.
"""

from __future__ import annotations

import contextlib
import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from . import _build


def pack_conv_weight(hwio) -> torch.Tensor:
    """(3, 3, Cin, Cout) HWIO kernel -> (Cout, 9*Cin) in (ky, kx, ci) order."""
    hwio = torch.as_tensor(np.asarray(hwio))
    kh, kw, cin, cout = hwio.shape
    if (kh, kw) != (3, 3):
        raise ValueError(f"expected a 3x3 kernel, got {(kh, kw)}")
    return hwio.permute(3, 0, 1, 2).reshape(cout, 9 * cin).contiguous()


def fold_batchnorm(gamma, beta, mean, var, eps: float = 1e-5):
    """Inference BatchNorm -> (scale, bias) on the conv accumulator, in f32."""
    gamma, beta, mean, var = (np.asarray(a, np.float32)
                              for a in (gamma, beta, mean, var))
    scale = gamma / np.sqrt(var + np.float32(eps))
    return scale, beta - mean * scale


def unpack_conv_weight(w: torch.Tensor, cin: int) -> torch.Tensor:
    """(Cout, 9*Cin) packed -> (Cout, Cin, 3, 3) OIHW for ``F.conv2d``."""
    return w.reshape(w.shape[0], 3, 3, cin).permute(0, 3, 1, 2)


@contextlib.contextmanager
def exact_f32():
    """cuDNN runs f32 convolutions in TF32 unless told otherwise; the plain
    versions must be exact f32."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _cbr(x, w, scale, bias):
    with exact_f32():
        y = F.conv2d(x, unpack_conv_weight(w, x.shape[1]), padding=1)
    return torch.relu(y * scale[None, :, None, None] + bias[None, :, None, None])


def fused_double_cbr_reference(x: torch.Tensor, w1: torch.Tensor,
                               scale1: torch.Tensor, bias1: torch.Tensor,
                               w2: torch.Tensor, scale2: torch.Tensor,
                               bias2: torch.Tensor) -> torch.Tensor:
    """Plain version: two f32 convolutions on inputs and weights rounded to
    ``x.dtype``, the intermediate rounded to ``x.dtype`` as well.  For bf16
    ``x`` this is the kernel's precision contract; for f32 ``x`` it is the
    exact f32 pair."""
    dt = x.dtype
    f32 = torch.float32
    h = _cbr(x.to(f32), w1.to(dt).to(f32), scale1.to(f32), bias1.to(f32))
    y = _cbr(h.to(dt).to(f32), w2.to(dt).to(f32), scale2.to(f32),
             bias2.to(f32))
    return y.to(dt)


def _lib():
    lib = _build.load("fused_double_cbr")
    fn = lib.fused_double_cbr_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        rows = lib.fused_double_cbr_tile_rows
        rows.argtypes = [ctypes.c_int]
        rows.restype = ctypes.c_int
    return lib


def _check_cuda(x, w1, scale1, bias1, w2, scale2, bias2):
    N, cin, H, W = x.shape
    cmid, cout = w1.shape[0], w2.shape[0]
    want = {"x": (x, torch.bfloat16, (N, cin, H, W)),
            "w1": (w1, torch.bfloat16, (cmid, 9 * cin)),
            "scale1": (scale1, torch.float32, (cmid,)),
            "bias1": (bias1, torch.float32, (cmid,)),
            "w2": (w2, torch.bfloat16, (cout, 9 * cmid)),
            "scale2": (scale2, torch.float32, (cout,)),
            "bias2": (bias2, torch.float32, (cout,))}
    for name, (t, dtype, shape) in want.items():
        if t.device != x.device:
            raise ValueError(f"fused_double_cbr: {name} on {t.device}, "
                             f"x on {x.device}")
        if t.dtype != dtype:
            raise TypeError(f"fused_double_cbr: {name} is {t.dtype}, the "
                            f"kernel takes {dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"fused_double_cbr: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"fused_double_cbr: {name} is not contiguous")


def fused_double_cbr(x: torch.Tensor, w1: torch.Tensor, scale1: torch.Tensor,
                     bias1: torch.Tensor, w2: torch.Tensor,
                     scale2: torch.Tensor, bias2: torch.Tensor) -> torch.Tensor:
    """``relu(s2*conv3x3(h)+b2)`` with ``h = relu(s1*conv3x3(x)+b1)``; both
    convs zero-pad 1, no bias.

    x (N, Cin, H, W); w1 (Cmid, 9*Cin), w2 (Cout, 9*Cmid) packed in
    (ky, kx, ci) order; scale/bias f32 per channel.  On CUDA the kernel takes
    bf16 x and weights and returns bf16; CPU tensors go to the plain version.
    """
    if x.device.type == "cpu":
        return fused_double_cbr_reference(x, w1, scale1, bias1, w2, scale2,
                                          bias2)
    if x.device.type != "cuda":
        raise ValueError(f"fused_double_cbr: unsupported device {x.device}")
    _check_cuda(x, w1, scale1, bias1, w2, scale2, bias2)
    N, cin, H, W = x.shape
    cmid, cout = w1.shape[0], w2.shape[0]
    out = torch.empty((N, cout, H, W), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(x.device):
        if lib.fused_double_cbr_tile_rows(cmid) == 0:
            raise ValueError(f"fused_double_cbr: Cmid={cmid} does not fit "
                             "the kernel's shared-memory tile")
        err = lib.fused_double_cbr_launch(
            x.data_ptr(), w1.data_ptr(), scale1.data_ptr(), bias1.data_ptr(),
            w2.data_ptr(), scale2.data_ptr(), bias2.data_ptr(),
            out.data_ptr(), N, cin, cmid, cout, H, W,
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "fused_double_cbr launch")
    fused_double_cbr.launches += 1
    return out


fused_double_cbr.launches = 0
