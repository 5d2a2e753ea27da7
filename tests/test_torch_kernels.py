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
