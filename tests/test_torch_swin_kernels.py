"""The plain versions of the Swin UNETR kernels (``ops/kernels/
window_attn.py``, ``ops/kernels/swin_ops.py``) on the CPU: the window
attention read from the projection of the unpadded map against MONAI's
padded, rolled, windowed order (``tests/torch_ref.py``), over padded,
shifted, shrunk and mixed maps; the LayerNorm and the InstanceNorm with its
residual and LeakyReLU against PyTorch's ops.  The kernels themselves are
held against these on a card (``tests/test_torch_cuda.py``)."""

import pytest
import torch
import torch.nn.functional as F

from att_aspp_unet_tpu_torch.ops.kernels import swin_ops as sn
from att_aspp_unet_tpu_torch.ops.kernels import window_attn as wa
from att_aspp_unet_tpu_torch.ops.kernels.instance_norm import InstanceNorm

from . import torch_ref
from .test_torch_threads import one_torch_thread  # noqa: F401


def _monai_attention(ref, a, x, window, shift):
    """The attention branch of MONAI's Swin block on normed tokens x, as
    ``torch_ref.SwinUNETR._block`` computes it."""
    b, h, w, c = x.shape
    ws, ss = torch_ref.window_and_shift((h, w), window, shift)
    pad_b, pad_r = -h % ws[0], -w % ws[1]
    x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
    hp, wp = h + pad_b, w + pad_r
    mask = None
    if any(ss):
        x = torch.roll(x, (-ss[0], -ss[1]), (1, 2))
        mask = torch_ref.compute_mask(hp, wp, ws, ss, x.device)
    win = ref._attention(a, torch_ref.window_partition(x, ws), mask)
    x = torch_ref.window_reverse(win.view(-1, ws[0] * ws[1], c), ws, b, hp,
                                 wp)
    if any(ss):
        x = torch.roll(x, (ss[0], ss[1]), (1, 2))
    return x[:, :h, :w]


@pytest.mark.parametrize("hw,shift", [((13, 20), 3), ((14, 21), 3),
                                      ((14, 14), 0), ((6, 20), 3),
                                      ((20, 5), 3), ((4, 6), 3)])
def test_window_attn_matches_monai_order(hw, shift):
    """Padded right and bottom, shifted, unshifted, one side shrunk to its
    length with no shift there (MONAI's one-region rule on that side), and
    both sides shrunk (the bias of a shrunk window read from the full
    window's index)."""
    gen = torch.Generator().manual_seed(sum(hw) + shift)
    heads, C = 2, 8
    ref = torch_ref.SwinUNETR(1, 3, 12).eval()
    a = torch_ref.WindowAttention(C, heads, 7)
    with torch.no_grad():
        for p in a.parameters():
            p.copy_(torch.randn(p.shape, generator=gen))
    x = torch.randn(2, *hw, C, generator=gen)
    with torch.no_grad():
        want = _monai_attention(ref, a, x, 7, shift)
        qkv = F.linear(x, a.qkv.weight, a.qkv.bias)
        got = F.linear(wa.window_attn(
            qkv, a.qkv.bias, a.relative_position_bias_table,
            a.relative_position_index, heads, 7, shift),
            a.proj.weight, a.proj.bias)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("hw", [(13, 20), (6, 20)])
def test_window_attn_region_mask_and_bias_move_the_output(hw):
    """Dropping the region mask or the bias changes a shifted block's
    output: both reach every window they should."""
    gen = torch.Generator().manual_seed(5)
    heads, C = 2, 8
    qkv = torch.randn(1, *hw, 3 * C, generator=gen)
    table = torch.randn(169, heads, generator=gen)
    index = torch_ref.relative_position_index(7)
    base = wa.window_attn(qkv, None, table, index, heads, 7, 3)
    flat = wa.window_attn(qkv, None, torch.zeros_like(table), index, heads,
                          7, 3)
    unshifted_mask = wa.window_attn(qkv, None, table, index, heads, 7, 0)
    assert not torch.allclose(base, flat)
    assert not torch.allclose(base, unshifted_mask)


@pytest.mark.parametrize("C,residual,affine", [(48, False, True),
                                               (48, True, True),
                                               (96, True, False),
                                               (20, False, True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_norm_plain_matches_pytorch(C, residual, affine, dtype):
    gen = torch.Generator().manual_seed(C)
    x = (torch.randn(3, 5, C, generator=gen) * 2 + 1).to(dtype)
    r = torch.randn(3, 5, C, generator=gen).to(dtype) if residual else None
    w = (torch.randn(C, generator=gen) + 1).to(dtype) if affine else None
    b = torch.randn(C, generator=gen).to(dtype) if affine else None
    s, y = sn.layer_norm(x, w, b, 1e-5, r)
    want_s = x if r is None else x + r
    assert torch.equal(s, want_s)
    want = F.layer_norm(want_s.float(), (C,), None if w is None else
                        w.float(), None if b is None else b.float(),
                        1e-5).to(dtype)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(y, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("mode", ["act", "residual", "normed_residual",
                                  "none"])
def test_instance_norm_act_plain_matches_the_modules(mode):
    """f32: ``act(IN(x) + r)`` as the conv blocks compute it with
    ``instance_norm.InstanceNorm`` and LeakyReLU(0.01)."""
    gen = torch.Generator().manual_seed(11)
    C = 6
    x = torch.randn(2, C, 9, 7, generator=gen) * 3 + 1
    r = torch.randn(2, C, 9, 7, generator=gen)
    n1, n2 = InstanceNorm(C), InstanceNorm(C)
    with torch.no_grad():
        for n in (n1, n2):
            n.weight.copy_(torch.rand(C, generator=gen) + 0.5)
            n.bias.copy_(torch.randn(C, generator=gen))
    slope = None if mode == "none" else 0.01
    kw = {"residual": r} if mode == "residual" else \
        {"residual": r, "residual_norm": n2} if mode == "normed_residual" \
        else {}
    got = sn.instance_norm_act(x, n1, slope, **kw)
    want = n1(x)
    if mode == "residual":
        want = want + r
    elif mode == "normed_residual":
        want = want + n2(r)
    if slope is not None:
        want = F.leaky_relu(want, slope)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("with_1x1", [True, False])
def test_stem_convs_plain_matches_the_convs(with_1x1):
    """The stem's two convs of the 1-channel input against ``F.conv2d``
    (f32; bf16 sums in f32, rounded once)."""
    gen = torch.Generator().manual_seed(3)
    x = torch.rand(2, 1, 9, 12, generator=gen)
    w3 = torch.randn(16, 1, 3, 3, generator=gen)
    w1 = torch.randn(16, 1, 1, 1, generator=gen) if with_1x1 else None
    y, r = sn.stem_convs(x, w3, w1)
    torch.testing.assert_close(y, F.conv2d(x, w3, padding=1))
    if with_1x1:
        torch.testing.assert_close(r, F.conv2d(x, w1))
    else:
        assert r is None
    yb, _ = sn.stem_convs(x.bfloat16(), w3.bfloat16(), None)
    want = F.conv2d(x.bfloat16().float(), w3.bfloat16().float(),
                    padding=1).bfloat16()
    assert torch.equal(yb, want)
