"""Port parity of kernel K1 (fused_double_cbr): its plain PyTorch version
(what the wrapper runs for CPU tensors) against the JAX Pallas kernel in
interpret mode (the CUDA kernels against their plain versions on a card:
``test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from att_aspp_unet_tpu.ops.pallas import fused_conv as jfc
from att_aspp_unet_tpu_torch.ops.kernels import fused_conv as tfc
from .test_torch_threads import one_torch_thread  # noqa: F401


def _pair_case(rng, N, cin, cmid, cout, H, W):
    x = rng.standard_normal((N, cin, H, W)).astype(np.float32)
    w1 = (rng.standard_normal((3, 3, cin, cmid)) * 0.3).astype(np.float32)
    w2 = (rng.standard_normal((3, 3, cmid, cout)) * 0.3).astype(np.float32)
    bn = []
    for c in (cmid, cout):
        g, b = rng.random(c).astype(np.float32) + 0.5, \
            rng.standard_normal(c).astype(np.float32)
        m, v = rng.standard_normal(c).astype(np.float32) * 0.1, \
            rng.random(c).astype(np.float32) + 0.5
        bn.append((g, b, m, v))
    return x, w1, w2, bn


@pytest.mark.parametrize("shape", [
    (2, 5, 7, 6, 16, 128),       # test_pallas_kernels: both K-stack paths
    (1, 3, 4, 2, 128, 128),      # several Pallas row blocks (seams, masking)
])
def test_fused_double_cbr_plain_matches_pallas(rng, shape):
    """bf16 inputs and intermediate on both sides; rtol/atol 2e-2 as in
    ``tests/test_pallas_kernels.py`` (f32 sums in different orders can flip
    a bf16 rounding of the intermediate)."""
    x, w1, w2, ((g1, b1, m1, v1), (g2, b2, m2, v2)) = _pair_case(rng, *shape)
    js1, jo1 = jfc.fold_batchnorm(*map(jnp.asarray, (g1, b1, m1, v1)))
    js2, jo2 = jfc.fold_batchnorm(*map(jnp.asarray, (g2, b2, m2, v2)))
    want = jfc.fused_double_cbr(
        jnp.asarray(x).astype(jnp.bfloat16), jfc.pack_conv_weight(jnp.asarray(w1)),
        js1, jo1, jfc.pack_conv_weight(jnp.asarray(w2)), js2, jo2,
        interpret=True)

    s1, o1 = tfc.fold_batchnorm(g1, b1, m1, v1)
    s2, o2 = tfc.fold_batchnorm(g2, b2, m2, v2)
    np.testing.assert_allclose(s1, np.asarray(js1), rtol=1e-6)
    np.testing.assert_array_equal(tfc.pack_conv_weight(w1).numpy(),
                                  np.asarray(jfc.pack_conv_weight(jnp.asarray(w1))))
    bf = torch.bfloat16
    got = tfc.fused_double_cbr(
        torch.from_numpy(x).to(bf), tfc.pack_conv_weight(w1).to(bf),
        torch.from_numpy(s1), torch.from_numpy(o1),
        tfc.pack_conv_weight(w2).to(bf), torch.from_numpy(s2),
        torch.from_numpy(o2))
    assert got.dtype == bf and tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=2e-2, atol=2e-2)


def test_fused_double_cbr_f32_plain_is_exact_pair(rng):
    """For f32 tensors the plain version is the unrounded pair the f32
    reference-precision model runs."""
    x, w1, w2, ((g1, b1, m1, v1), (g2, b2, m2, v2)) = _pair_case(
        rng, 1, 3, 4, 2, 9, 11)
    s1, o1 = tfc.fold_batchnorm(g1, b1, m1, v1)
    s2, o2 = tfc.fold_batchnorm(g2, b2, m2, v2)
    got = tfc.fused_double_cbr(torch.from_numpy(x), tfc.pack_conv_weight(w1),
                               torch.from_numpy(s1), torch.from_numpy(o1),
                               tfc.pack_conv_weight(w2), torch.from_numpy(s2),
                               torch.from_numpy(o2))
    conv = torch.nn.functional.conv2d
    oihw = lambda w: torch.from_numpy(w).permute(3, 2, 0, 1)
    h = torch.relu(conv(torch.from_numpy(x), oihw(w1), padding=1)
                   * torch.from_numpy(s1)[:, None, None]
                   + torch.from_numpy(o1)[:, None, None])
    want = torch.relu(conv(h, oihw(w2), padding=1)
                      * torch.from_numpy(s2)[:, None, None]
                      + torch.from_numpy(o2)[:, None, None])
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cin,cmid", [(1, 48), (96, 48), (768, 384), (5, 7)])
def test_prepack_weight_round_trips_and_pads_with_zeros(rng, cin, cmid):
    """The kernel's weight order (row blocks of up to 64, K-chunks of ``kc``,
    each chunk ``[tap][row][kc]``) holds exactly the canonical (Cout, 9*Cin)
    matrix: unpacking gives it back bit for bit, and everything else in the
    padded buffer is zero."""
    w = torch.from_numpy(rng.standard_normal((cmid, 9 * cin))
                         .astype(np.float32)).to(torch.bfloat16)
    w[w == 0] = 1.0
    th, kc = tfc.plan_tile(cmid)
    assert tfc.tile_smem_bytes(th, kc, cmid) <= tfc.SMEM_LIMIT
    packed = tfc.prepack_weight(w, cin, kc)
    taps, k = (1, 9) if cin == 1 else (9, cin)
    assert packed.dim() == 1 and packed.is_contiguous()
    assert packed.numel() == (-(-cmid // 16) * 16) * taps * (-(-max(k, 16) // kc) * kc)
    assert torch.equal(tfc.unpack_prepacked(packed, cmid, cin, kc), w)
    assert int((packed != 0).sum()) == w.numel()
    # the first chunk of the first row block is [tap][row][kc]
    rows = min(64, -(-cmid // 16) * 16)
    chunk = packed[:taps * rows * kc].reshape(taps, rows, kc)
    kk = min(k, kc)
    want = w.reshape(cmid, taps, k)[:rows, :, :kk].permute(1, 0, 2)
    assert torch.equal(chunk[:, :want.shape[1], :kk], want)


def test_prepack_pair_picks_the_tile_by_shared_memory():
    assert [tfc.plan_tile(c) for c in (48, 96, 192, 384)] == [
        (16, 32), (16, 32), (16, 16), (8, 16)]
    with pytest.raises(ValueError):
        tfc.plan_tile(1024)
    w1 = torch.zeros(96, 9 * 48, dtype=torch.bfloat16)
    w2 = torch.zeros(96, 9 * 96, dtype=torch.bfloat16)
    packed = tfc.prepack_pair(w1, w2, wgmma=False)
    assert (packed.th, packed.kc, packed.wgmma) == (16, 32, False)
    assert packed.w1p.numel() == 96 * 9 * 64 and packed.w2p.numel() == 96 * 9 * 96


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fused_double_cbr_cpu_same_for_channel_last_and_contiguous(rng, dtype):
    """On the CPU the wrapper runs the plain version whatever the memory
    format of ``x``; both formats give the same values."""
    x, w1, w2, ((g1, b1, m1, v1), (g2, b2, m2, v2)) = _pair_case(
        rng, 2, 8, 16, 8, 20, 24)
    s1, o1 = tfc.fold_batchnorm(g1, b1, m1, v1)
    s2, o2 = tfc.fold_batchnorm(g2, b2, m2, v2)
    rest = (tfc.pack_conv_weight(w1).to(dtype), torch.from_numpy(s1),
            torch.from_numpy(o1), tfc.pack_conv_weight(w2).to(dtype),
            torch.from_numpy(s2), torch.from_numpy(o2))
    xc = torch.from_numpy(x).to(dtype)
    xl = xc.contiguous(memory_format=torch.channels_last)
    assert not xl.is_contiguous()
    a, b = tfc.fused_double_cbr(xc, *rest), tfc.fused_double_cbr(xl, *rest)
    assert a.shape == b.shape == (2, 8, 20, 24)
    # f32 sums may run in another order for the other layout
    np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                               rtol=1e-5 if dtype == torch.float32 else 2e-2,
                               atol=1e-5 if dtype == torch.float32 else 2e-2)


@pytest.mark.parametrize("cin,cmid", [(96, 48), (768, 384), (48, 96), (16, 16)])
def test_prepack_weight_wgmma_round_trips_and_pads_with_zeros(rng, cin, cmid):
    """The wgmma path's weight order (64-row blocks, 16-channel K-steps, each
    chunk ``[tap][K/8][64 rows][8]``) holds exactly the canonical matrix."""
    w = torch.from_numpy(rng.standard_normal((cmid, 9 * cin))
                         .astype(np.float32)).to(torch.bfloat16)
    w[w == 0] = 1.0
    packed = tfc.prepack_weight_wgmma(w, cin)
    mpad = -(-cmid // 64) * 64
    assert packed.dim() == 1 and packed.numel() == mpad * 9 * cin
    assert torch.equal(tfc.unpack_prepacked_wgmma(packed, cmid, cin), w)
    assert int((packed != 0).sum()) == w.numel()
    # chunk (block 0, K-step 0): element [tap][k // 8][row][k % 8]
    chunk = packed[:9 * 2 * 64 * 8].reshape(9, 2, 64, 8)
    rows = min(cmid, 64)
    want = w.reshape(cmid, 9, cin)[:rows, :, :16].reshape(rows, 9, 2, 8)
    assert torch.equal(chunk[:, :, :rows], want.permute(1, 2, 0, 3))


def test_path_and_tile_plan():
    """The wgmma path takes whole 16-channel K-steps and 16-byte output
    pieces; the model's first pair (one input channel) and ragged channel
    counts stay on the mma.sync path."""
    assert [tfc.wgmma_takes(*s) for s in ((1, 48, 48), (48, 96, 96), (768, 384, 384),
                                        (5, 7, 6), (24, 40, 8), (32, 64, 16))] == [
        False, True, True, False, False, True]
    assert [tfc.plan_wgmma_tile(c) for c in (48, 96, 192, 384)] == [
        (16, 16), (16, 16), (16, 16), (8, 16)]
    for c in (48, 96, 192, 384):
        assert tfc.wgmma_smem_bytes(tfc.plan_wgmma_tile(c)[0], c) <= tfc.SMEM_LIMIT
    assert not tfc.wgmma_takes(512, 512, 512)       # tile would not fit
    w1, w2 = torch.zeros(96, 9 * 48), torch.zeros(96, 9 * 96)
    packed = tfc.prepack_pair(w1, w2)
    assert packed.wgmma and (packed.th, packed.kc) == (16, 16)
    assert not tfc.prepack_pair(w1, w2, wgmma=False).wgmma
    with pytest.raises(ValueError):
        tfc.prepack_pair(torch.zeros(7, 45), torch.zeros(6, 63), wgmma=True)
