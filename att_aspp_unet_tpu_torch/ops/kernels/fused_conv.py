"""Fused double Conv3x3 + folded-BN + ReLU: kernel K1, its wrapper and its
plain PyTorch version.

Counterpart of ``att_aspp_unet_tpu/ops/pallas/fused_conv.py``.  The kernel is
``csrc/fused_double_cbr.cu`` (design notes there); :func:`fused_double_cbr`
launches it for CUDA tensors and runs :func:`fused_double_cbr_reference` for
CPU tensors.

The kernel has two paths, a wgmma one for channel counts that are whole
16-channel K-steps and an mma.sync one for every shape.  Each reads the
weights in an order of its own; :func:`prepack_pair` puts the canonical
(Cout, 9*Cin) pair into it, once per weight set, and decides the path and the
tile (both follow from the channel counts and the shared-memory budget, so
this module and the CUDA source compute them alike).
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import _build


def model_pairs(base_c: int, size: int):
    """The eight conv pairs that the Attention-ASPP-UNet of width ``base_c``
    gives the kernel on a ``size`` x ``size`` input, in forward order:
    (name, Cin, Cmid, Cout, H = W)."""
    c = base_c
    return [("d1", 1, c, c, size), ("d2", c, 2 * c, 2 * c, size // 2),
            ("d3", 2 * c, 4 * c, 4 * c, size // 4),
            ("d4", 4 * c, 8 * c, 8 * c, size // 8),
            ("u4", 16 * c, 8 * c, 8 * c, size // 8),
            ("u3", 8 * c, 4 * c, 4 * c, size // 4),
            ("u2", 4 * c, 2 * c, 2 * c, size // 2),
            ("u1", 2 * c, c, c, size)]


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


# Tiles the kernel is built with, best first: (rows of the output tile,
# channels per K-chunk).  The first whose shared memory fits is used.
TILES = ((16, 32), (16, 16), (8, 16))
SMEM_LIMIT = 232448          # bytes a block may use on sm_90 (227 KB)
_MC, _TW, _SKEW = 64, 16, 8  # row block, tile width, smem row padding


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def tile_smem_bytes(th: int, kc: int, cmid: int) -> int:
    """Shared memory of tile (th, kc): the intermediate tile plus two stages
    of input and weight chunks, as ``csrc/fused_double_cbr.cu`` lays it out."""
    p1 = (th + 2) * (_TW + 2)
    in_p = (th + 4) * (_TW + 4)
    kp = kc + _SKEW
    return 2 * (p1 * (_round_up(cmid, 16) + _SKEW) + 2 * in_p * kp
                + 2 * 9 * _MC * kp) + 16


def plan_tile(cmid: int):
    """(th, kc) the kernel runs with for this Cmid."""
    for th, kc in TILES:
        if tile_smem_bytes(th, kc, cmid) <= SMEM_LIMIT:
            return th, kc
    raise ValueError(f"fused_double_cbr: Cmid={cmid} does not fit the "
                     "kernel's shared-memory tile")


def _taps_as_k(cin: int) -> bool:
    """For one input channel the kernel takes the nine taps as the K
    dimension (one mma k-step of 16 instead of nine zero-padded ones)."""
    return cin == 1


def prepack_weight(w: torch.Tensor, cin: int, kc: int) -> torch.Tensor:
    """(M, 9*Cin) in (ky, kx, ci) order -> the kernel's order, 1-D.

    Rows are zero-padded to a multiple of 16 and cut into blocks of up to 64;
    K (the Cin channels of a tap, or all 9*Cin values where the taps are the
    K dimension) is zero-padded to a multiple of ``kc`` and cut into chunks.
    Block-major, then chunk; each chunk is ``[tap][row][kc]`` contiguous, so
    one K-step of the kernel reads one contiguous run."""
    m = w.shape[0]
    taps, k = (1, 9 * cin) if _taps_as_k(cin) else (9, cin)
    mpad, kpad = _round_up(m, 16), _round_up(max(k, 16), kc)
    w3 = w.new_zeros(mpad, taps, kpad)
    w3[:m, :, :k] = w.reshape(m, taps, k)
    w4 = w3.reshape(mpad, taps, kpad // kc, kc)
    blocks = [w4[m0:m0 + _MC].permute(2, 1, 0, 3).reshape(-1)
              for m0 in range(0, mpad, _MC)]
    return torch.cat(blocks).contiguous()


def unpack_prepacked(packed: torch.Tensor, m: int, cin: int,
                     kc: int) -> torch.Tensor:
    """Inverse of :func:`prepack_weight`: the canonical (M, 9*Cin) matrix."""
    taps, k = (1, 9 * cin) if _taps_as_k(cin) else (9, cin)
    mpad, kpad = _round_up(m, 16), _round_up(max(k, 16), kc)
    out, at = [], 0
    for m0 in range(0, mpad, _MC):
        rows = min(_MC, mpad - m0)
        size = rows * taps * kpad
        blk = packed[at:at + size].reshape(kpad // kc, taps, rows, kc)
        out.append(blk.permute(2, 1, 0, 3).reshape(rows, taps, kpad))
        at += size
    return torch.cat(out)[:m, :, :k].reshape(m, 9 * cin).contiguous()


# The warpgroup (wgmma) path: 16-channel K-steps over three stages, tiles of
# 16 or 8 rows; it takes channel counts that are whole K-steps and 16-byte
# output pieces.
WG_KC, WG_STAGES = 16, 3


def wgmma_smem_bytes(th: int, cmid: int) -> int:
    """Shared memory of the wgmma path's tile, as the kernel lays it out."""
    nh1 = _round_up(-(-(th + 2) * (_TW + 4) // 2), 8)
    in_pix = _round_up(2 * nh1 + 2 * (_TW + 4) + 2, 8)
    mid_pix = _round_up(th * (_TW + 2) + 2 * (_TW + 2) + 2, 8)
    return (2 * (_round_up(cmid, 64) * mid_pix
                 + WG_STAGES * (2 * in_pix * 8 + 9 * 2 * _MC * 8))
            + 8 * WG_STAGES + 40)


def wgmma_takes(cin: int, cmid: int, cout: int) -> bool:
    """Whether the wgmma path runs this pair."""
    return (cin % 16 == 0 and cmid % 16 == 0 and cout % 8 == 0
            and wgmma_smem_bytes(8, cmid) <= SMEM_LIMIT)


def plan_wgmma_tile(cmid: int):
    """(th, kc) the wgmma path runs with for this Cmid."""
    th = 16 if wgmma_smem_bytes(16, cmid) <= SMEM_LIMIT else 8
    return th, WG_KC


def prepack_weight_wgmma(w: torch.Tensor, cin: int) -> torch.Tensor:
    """(M, 9*Cin) in (ky, kx, ci) order -> the wgmma path's order, 1-D: rows
    zero-padded to a multiple of 64, channels to a multiple of 16; one chunk
    per (64-row block, 16-channel K-step), block-major, each chunk
    ``[tap][K/8][64 rows][8]`` (the no-swizzle K-major core-matrix order)."""
    m = w.shape[0]
    mpad, kpad = _round_up(m, 64), _round_up(cin, 16)
    w3 = w.new_zeros(mpad, 9, kpad)
    w3[:m, :, :cin] = w.reshape(m, 9, cin)
    w6 = w3.reshape(mpad // 64, 64, 9, kpad // 16, 2, 8)
    return w6.permute(0, 3, 2, 4, 1, 5).reshape(-1).contiguous()


def unpack_prepacked_wgmma(packed: torch.Tensor, m: int,
                           cin: int) -> torch.Tensor:
    """Inverse of :func:`prepack_weight_wgmma`."""
    mpad, kpad = _round_up(m, 64), _round_up(cin, 16)
    w6 = packed.reshape(mpad // 64, kpad // 16, 9, 2, 64, 8)
    w3 = w6.permute(0, 4, 2, 1, 3, 5).reshape(mpad, 9, kpad)
    return w3[:m, :, :cin].reshape(m, 9 * cin).contiguous()


class PackedPair(NamedTuple):
    """A pair's weights in the kernel's order, with the tile and the path
    (``wgmma``: the warpgroup path, else ``mma.sync``) they are for."""
    w1p: torch.Tensor
    w2p: torch.Tensor
    th: int
    kc: int
    wgmma: bool = False


def prepack_pair(w1: torch.Tensor, w2: torch.Tensor,
                 wgmma: Optional[bool] = None) -> PackedPair:
    """Prepack canonical ``w1`` (Cmid, 9*Cin) and ``w2`` (Cout, 9*Cmid): for
    the wgmma path wherever it takes the shape (on the card it was the faster
    one at every main-path shape it takes, PERF.md), else for the mma.sync
    path; ``wgmma`` forces one.  Do it once per weight set."""
    cmid, cin, cout = w1.shape[0], w1.shape[1] // 9, w2.shape[0]
    if wgmma is None:
        wgmma = wgmma_takes(cin, cmid, cout)
    if wgmma:
        if not wgmma_takes(cin, cmid, cout):
            raise ValueError(f"fused_double_cbr: the wgmma path does not "
                             f"take {cin}->{cmid}->{cout}")
        th, kc = plan_wgmma_tile(cmid)
        return PackedPair(prepack_weight_wgmma(w1, cin),
                          prepack_weight_wgmma(w2, cmid), th, kc, True)
    th, kc = plan_tile(cmid)
    return PackedPair(prepack_weight(w1, cin, kc),
                      prepack_weight(w2, cmid, kc), th, kc)


def _packed_numel(m: int, c: int, packed: PackedPair) -> int:
    if packed.wgmma:
        return _round_up(m, 64) * 9 * _round_up(c, 16)
    taps, k = (1, 9 * c) if _taps_as_k(c) else (9, c)
    return _round_up(m, 16) * taps * _round_up(max(k, 16), packed.kc)


def _lib():
    lib = _build.load("fused_double_cbr")
    fn = lib.fused_double_cbr_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
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
        if name != "x" and not t.is_contiguous():
            raise ValueError(f"fused_double_cbr: {name} is not contiguous")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(
            "fused_double_cbr: x must be in torch.channels_last memory "
            f"format (NHWC strides); got strides {tuple(x.stride())} for "
            f"shape {tuple(x.shape)}")
    if x.data_ptr() % 16:
        raise ValueError("fused_double_cbr: x is not aligned to 16 bytes")


def _check_packed(packed, w1, w2):
    cin, cmid, cout = w1.shape[1] // 9, w1.shape[0], w2.shape[0]
    if packed.wgmma:
        ok = (wgmma_takes(cin, cmid, cout)
              and (packed.th, packed.kc) == plan_wgmma_tile(cmid))
    else:
        ok = (packed.th, packed.kc) == plan_tile(cmid)
    if not ok:
        raise ValueError(f"fused_double_cbr: weights prepacked for tile "
                         f"{(packed.th, packed.kc)} (wgmma={packed.wgmma}) "
                         f"do not fit {cin}->{cmid}->{cout}")
    for name, t, w, c in (("w1p", packed.w1p, w1, cin),
                          ("w2p", packed.w2p, w2, cmid)):
        numel = _packed_numel(w.shape[0], c, packed)
        if (t.device != w.device or t.dtype != w.dtype or t.dim() != 1
                or t.numel() != numel or not t.is_contiguous()):
            raise ValueError(f"fused_double_cbr: prepacked {name} does not "
                             f"match its weight ({numel} {w.dtype} values "
                             f"on {w.device} expected)")


def fused_double_cbr(x: torch.Tensor, w1: torch.Tensor, scale1: torch.Tensor,
                     bias1: torch.Tensor, w2: torch.Tensor,
                     scale2: torch.Tensor, bias2: torch.Tensor,
                     packed: Optional[PackedPair] = None) -> torch.Tensor:
    """``relu(s2*conv3x3(h)+b2)`` with ``h = relu(s1*conv3x3(x)+b1)``; both
    convs zero-pad 1, no bias.

    x (N, Cin, H, W); w1 (Cmid, 9*Cin), w2 (Cout, 9*Cmid) packed in
    (ky, kx, ci) order; scale/bias f32 per channel.  On CUDA the kernel takes
    bf16 weights and a bf16 x in ``torch.channels_last`` memory format and
    returns bf16 in the same format; it converts nothing.  ``packed`` is
    :func:`prepack_pair` of (w1, w2); without it the weights are prepacked on
    the fly.  CPU tensors go to the plain version.
    """
    if x.device.type == "cpu":
        return fused_double_cbr_reference(x, w1, scale1, bias1, w2, scale2,
                                          bias2)
    if x.device.type != "cuda":
        raise ValueError(f"fused_double_cbr: unsupported device {x.device}")
    _check_cuda(x, w1, scale1, bias1, w2, scale2, bias2)
    if packed is None:
        packed = prepack_pair(w1, w2)
    else:
        _check_packed(packed, w1, w2)
    N, cin, H, W = x.shape
    cmid, cout = w1.shape[0], w2.shape[0]
    out = torch.empty((N, cout, H, W), dtype=x.dtype, device=x.device,
                      memory_format=torch.channels_last)
    if out.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.fused_double_cbr_launch(
            x.data_ptr(), packed.w1p.data_ptr(), scale1.data_ptr(),
            bias1.data_ptr(), packed.w2p.data_ptr(), scale2.data_ptr(),
            bias2.data_ptr(), out.data_ptr(), N, cin, cmid, cout, H, W,
            packed.th, packed.kc, int(packed.wgmma),
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "fused_double_cbr launch")
    fused_double_cbr.launches += 1
    return out


fused_double_cbr.launches = 0
