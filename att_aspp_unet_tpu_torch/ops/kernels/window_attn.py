"""Shifted-window attention of one Swin block, read straight from the qkv
projection's output and written straight to the map: a Triton kernel
(``window_attn_fwd``) and its plain PyTorch version.

MONAI's block pads the normed map right and bottom to whole windows, rolls
it by the shift, copies it into windows, projects q, k and v, runs the
attention with the relative-position bias and the shifted blocks' region
mask, and copies the result back through the reverse roll and the crop.
Here the projection runs on the map as it is (a padded token is zero after
the norm, so its q, k and v are the projection's bias) and one program per
(window, group of heads) finds each of its tokens' place in the map from
the window's position and the shift, and per head loads q, k and v there
(the bias for a padded token), adds the relative-position bias of the head
and the -100 region mask, computed from the tokens' places, and stores the
output rows of the map's own tokens where the reverse roll puts them.  No
padded, rolled or windowed copy of the map is made, and no mask is
stored.

It replaces no TPU kernel (the JAX package has no such network).  Bound by
bytes: q, k, v and the output, 8 * C bytes a token in bf16, against 4 * 49
* C multiply-adds a token; the two products of a (window, head), 49 tokens
padded to 64 by 16, run on the tensor cores, the softmax in f32.
CPU tensors go to the plain version; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

SLOTS = 64                  # a window's tokens, padded to a power of two
WARPS = 2                   # warps a program
# a program takes the heads of one window in groups of the largest divisor
# of the head count up to this: the places and the region mask are worked
# out once a group, and a token's q, k and v of the group's heads lie side
# by side in memory
HEAD_GROUP = 4
MASK_VALUE = -100.0         # MONAI's logit offset between shifted regions


def window_and_shift(hw: Tuple[int, int], window: int, shift: int
                     ) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """MONAI's ``get_window_size``: a side not longer than the window takes
    the side as its window and no shift."""
    ws = tuple(n if n <= window else window for n in hw)
    ss = tuple(0 if n <= window else shift for n in hw)
    return ws, ss


def region_ids(padded: int, ws: int, ss: int) -> torch.Tensor:
    """MONAI's ``compute_mask`` regions along one side of the rolled,
    padded map: 0 before the last window, 1 in it before the shift, 2 in
    the shift; one region where the side has no shift (MONAI's slices then
    give every place the last label)."""
    r = torch.arange(padded)
    if not ss:
        return torch.zeros_like(r)
    return (r >= padded - ws).long() + (r >= padded - ss).long()


def table_bias(table: torch.Tensor, index: torch.Tensor, n: int
               ) -> torch.Tensor:
    """(heads, n, n) f32: the relative-position bias of a window of ``n``
    tokens, ``table[index[:n, :n]]`` as MONAI takes it (a shrunk window
    reads the first ``n`` rows and columns of the full window's index)."""
    idx = index[:n, :n].reshape(-1)
    return table.float()[idx].view(n, n, -1).permute(2, 0, 1)


def window_attn_reference(qkv: torch.Tensor, qkv_bias: Optional[torch.Tensor],
                          table: torch.Tensor, index: torch.Tensor,
                          heads: int, window: int, shift: int
                          ) -> torch.Tensor:
    """qkv (B, H, W, 3C), the projection of the normed map -> the attention
    output (B, H, W, C) in qkv's dtype, as MONAI's padded, rolled, windowed
    computation gives it, in f32."""
    B, H, W, C3 = qkv.shape
    C = C3 // 3
    d = C // heads
    ws, ss = window_and_shift((H, W), window, shift)
    Hp, Wp = H + (-H % ws[0]), W + (-W % ws[1])
    fill = (torch.zeros(C3, dtype=qkv.dtype, device=qkv.device)
            if qkv_bias is None else qkv_bias.to(qkv.dtype))
    full = fill.expand(B, Hp, Wp, C3).clone()
    full[:, :H, :W] = qkv
    ys = (torch.arange(Hp, device=qkv.device) + ss[0]) % Hp
    xs = (torch.arange(Wp, device=qkv.device) + ss[1]) % Wp
    rolled = full[:, ys][:, :, xs].float()
    nh, nw, n = Hp // ws[0], Wp // ws[1], ws[0] * ws[1]
    q, k, v = rolled.view(B, nh, ws[0], nw, ws[1], 3, heads, d).permute(
        5, 0, 1, 3, 6, 2, 4, 7).reshape(3, B, nh * nw, heads, n, d)
    s = q @ k.transpose(-1, -2) * d ** -0.5 \
        + table_bias(table, index, n).to(qkv.device)
    if any(ss):
        rid = (region_ids(Hp, ws[0], ss[0])[:, None] * 3
               + region_ids(Wp, ws[1], ss[1])[None, :]).to(qkv.device)
        rid = rid.view(nh, ws[0], nw, ws[1]).permute(0, 2, 1, 3).reshape(
            nh * nw, n)
        s = s + torch.where(rid[:, None, :, None] != rid[:, None, None, :],
                            MASK_VALUE, 0.0)
    o = torch.softmax(s, -1) @ v                     # (B, nW, heads, n, d)
    o = o.view(B, nh, nw, heads, ws[0], ws[1], d).permute(
        0, 1, 4, 2, 5, 3, 6).reshape(B, Hp, Wp, C)
    out = torch.empty_like(o)
    out[:, ys[:, None], xs[None, :]] = o
    return out[:, :H, :W].to(qkv.dtype)


_KERNEL = None


def _kernel():
    """The jitted Triton kernel, built at first use (Triton is imported
    here, not when the module is)."""
    global _KERNEL
    if _KERNEL is not None:
        return _KERNEL
    import triton
    import triton.language as tl

    @triton.jit
    def window_attn_fwd(qkv_ptr, bqkv_ptr, bias_ptr, out_ptr, H, W, Hp, Wp,
                        nww, nwin, wsh, wsw, ssh, ssw, scale,
                        C: tl.constexpr, D: tl.constexpr, N: tl.constexpr,
                        GROUP: tl.constexpr, SHIFTED: tl.constexpr):
        pid = tl.program_id(0)
        b = pid // nwin
        widx = pid % nwin
        t = tl.arange(0, N)
        n = wsh * wsw
        live = t < n
        r = (widx // nww) * wsh + t // wsw     # place in the rolled map
        c = (widx % nww) * wsw + t % wsw
        y = (r + ssh) % Hp                     # place in the map
        x = (c + ssw) % Wp
        real = live & (y < H) & (x < W)
        tok = ((b * H + y) * W + x).to(tl.int64)
        keep = real[:, None]
        rid = t
        if SHIFTED:
            rh = ((r >= Hp - wsh).to(tl.int32)
                  + (r >= Hp - ssh).to(tl.int32)) * (ssh > 0).to(tl.int32)
            rw = ((c >= Wp - wsw).to(tl.int32)
                  + (c >= Wp - ssw).to(tl.int32)) * (ssw > 0).to(tl.int32)
            rid = rh * 3 + rw
        dd = tl.arange(0, D)
        for g in tl.static_range(GROUP):
            head = tl.program_id(1) * GROUP + g
            col = head * D + dd
            src = qkv_ptr + tok[:, None] * (3 * C) + col[None, :]
            q = tl.load(src, mask=keep, other=0.0)
            k = tl.load(src + C, mask=keep, other=0.0)
            v = tl.load(src + 2 * C, mask=keep, other=0.0)
            q = tl.where(keep, q, tl.load(bqkv_ptr + col)[None, :])
            k = tl.where(keep, k, tl.load(bqkv_ptr + C + col)[None, :])
            v = tl.where(keep, v, tl.load(bqkv_ptr + 2 * C + col)[None, :])
            s = tl.dot(q, tl.trans(k)) * scale
            s += tl.load(bias_ptr + head * N * N + t[:, None] * N
                         + t[None, :])
            if SHIFTED:
                s += tl.where(rid[:, None] != rid[None, :], -100.0, 0.0)
            m = tl.max(s, 1)
            p = tl.exp(s - m[:, None])
            l = tl.sum(p, 1)
            o = tl.dot(p.to(v.dtype), v) / l[:, None]
            dst = out_ptr + tok[:, None] * C + col[None, :]
            tl.store(dst, o.to(out_ptr.dtype.element_ty), mask=keep)

    _KERNEL = window_attn_fwd
    return _KERNEL


def window_attn(qkv: torch.Tensor, qkv_bias: Optional[torch.Tensor],
                table: torch.Tensor, index: torch.Tensor, heads: int,
                window: int, shift: int) -> torch.Tensor:
    """As :func:`window_attn_reference`: qkv (B, H, W, 3C) bf16 contiguous
    on a card, head size 16 to 128 a power of two, windows of at most 64
    tokens."""
    if qkv.device.type == "cpu":
        return window_attn_reference(qkv, qkv_bias, table, index, heads,
                                     window, shift)
    B, H, W, C3 = qkv.shape
    C = C3 // 3
    d = C // heads
    ws, ss = window_and_shift((H, W), window, shift)
    n = ws[0] * ws[1]
    if qkv.dtype != torch.bfloat16 or not qkv.is_contiguous():
        raise ValueError("window_attn: qkv must be contiguous bf16")
    if C3 % 3 or C % heads or d < 16 or d & (d - 1) or n > SLOTS:
        raise ValueError(f"window_attn: {C3} qkv channels, {heads} heads, "
                         f"{n} tokens a window: the kernel takes a head "
                         f"size of a power of two >= 16 and <= {SLOTS} "
                         "tokens")
    Hp, Wp = H + (-H % ws[0]), W + (-W % ws[1])
    nh, nw = Hp // ws[0], Wp // ws[1]
    bqkv = (torch.zeros(C3, dtype=qkv.dtype, device=qkv.device)
            if qkv_bias is None else qkv_bias.to(qkv.dtype).contiguous())
    bias = torch.zeros((heads, SLOTS, SLOTS), dtype=torch.float32,
                       device=qkv.device)
    bias[:, :, n:] = float("-inf")
    bias[:, :n, :n] = table_bias(table, index, n)
    out = torch.empty((B, H, W, C), dtype=qkv.dtype, device=qkv.device)
    if out.numel() == 0:
        return out
    group = max(g for g in range(1, min(HEAD_GROUP, heads) + 1)
                if heads % g == 0)
    with torch.cuda.device(qkv.device):
        _kernel()[(B * nh * nw, heads // group)](
            qkv, bqkv, bias, out, H, W, Hp, Wp, nw, nh * nw, ws[0], ws[1],
            ss[0], ss[1], d ** -0.5, C=C, D=d, N=SLOTS, GROUP=group,
            SHIFTED=any(ss), num_warps=WARPS)
    window_attn.launches += 1
    return out


window_attn.launches = 0
