"""CLAHE dual-grid LUT interpolation: kernel K2, its wrapper and its plain
PyTorch version.

Counterpart of ``att_aspp_unet_tpu/ops/pallas/clahe_interp.py``: both of its
entry points (``clahe_interp_pallas_batched`` and the one-frame-per-program
``clahe_interp_pallas``) compute the same function with the same signature,
so one CUDA kernel (``csrc/clahe_interp.cu``) serves both names here.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build


def _fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """f32 ``a * b + c`` rounded once, as a fused multiply-add does.  The
    f64 product of two f32 values is exact; the f64 sum is exact too while
    the operands span at most 53 bits, which holds for integer LUT values
    <= 255 and CLAHE's corner weights."""
    f64 = torch.float64
    return (a.to(f64) * b.to(f64) + c.to(f64)).to(torch.float32)


def clahe_interp_reference(blocks: torch.Tensor, corner_luts: torch.Tensor,
                           wts: torch.Tensor) -> torch.Tensor:
    """Plain version: index gather of each pixel's four corner-LUT values,
    blended as ``fma(g3, w3, fma(g2, w2, fma(g1, w1, g0 * w0)))`` — the
    kernel's chain and the order the JAX package's XLA path evaluates
    ``sum(g * w, -1)`` in; values outside [0, 255] (padding) give 0."""
    valid = (blocks >= 0) & (blocks < 256)
    idx = blocks.clamp(0, 255).long()
    g = torch.gather(corner_luts, 2,
                     idx[..., None].expand(*idx.shape, 4))      # (N, B, P, 4)
    w = wts.to(torch.float32)
    out = g[..., 0] * w[:, 0]
    for c in (1, 2, 3):
        out = _fma_f32(g[..., c], w[:, c], out)
    return torch.where(valid, out, torch.zeros((), dtype=out.dtype,
                                               device=out.device))


def _lib():
    lib = _build.load("clahe_interp")
    fn = lib.clahe_interp_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong,
                                               ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check_cuda(blocks, corner_luts, wts):
    if blocks.dim() != 3:
        raise ValueError(f"clahe_interp: blocks must be (N, B, P), got "
                         f"{tuple(blocks.shape)}")
    N, B, P = blocks.shape
    want = {"blocks": (blocks, torch.int32, (N, B, P)),
            "corner_luts": (corner_luts, torch.float32, (N, B, 256, 4)),
            "wts": (wts, torch.float32, (P, 4))}
    for name, (t, dtype, shape) in want.items():
        if t.device != blocks.device:
            raise ValueError(f"clahe_interp: {name} on {t.device}, blocks on "
                             f"{blocks.device}")
        if t.dtype != dtype:
            raise TypeError(f"clahe_interp: {name} is {t.dtype}, the kernel "
                            f"takes {dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"clahe_interp: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"clahe_interp: {name} is not contiguous")
    for name, t in (("corner_luts", corner_luts), ("wts", wts)):
        if t.data_ptr() % 16:
            raise ValueError(f"clahe_interp: {name} is not 16-byte aligned")


def clahe_interp(blocks: torch.Tensor, corner_luts: torch.Tensor,
                 wts: torch.Tensor) -> torch.Tensor:
    """blocks (N, B, P) int32, corner_luts (N, B, 256, 4) f32, wts (P, 4) f32
    -> blended (N, B, P) f32.  CPU tensors go to the plain version."""
    if blocks.device.type == "cpu":
        return clahe_interp_reference(blocks, corner_luts, wts)
    if blocks.device.type != "cuda":
        raise ValueError(f"clahe_interp: unsupported device {blocks.device}")
    _check_cuda(blocks, corner_luts, wts)
    N, B, P = blocks.shape
    out = torch.empty((N, B, P), dtype=torch.float32, device=blocks.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(blocks.device):
        err = lib.clahe_interp_launch(
            blocks.data_ptr(), corner_luts.data_ptr(), wts.data_ptr(),
            out.data_ptr(), N * B, P,
            torch.cuda.current_stream(blocks.device).cuda_stream)
    _build.check(err, "clahe_interp launch")
    clahe_interp.launches += 1
    return out


clahe_interp.launches = 0

# The TPU package's per-frame variant computes the same function with the
# same signature; here both names are the one kernel.
clahe_interp_batched = clahe_interp
