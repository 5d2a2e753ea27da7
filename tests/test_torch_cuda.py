"""The hand-written CUDA kernels against their plain PyTorch versions, on a
card.  Every test here carries the ``cuda`` marker and skips without a CUDA
device.  The file imports neither JAX nor the JAX package, so it also runs
where only PyTorch is installed:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from att_aspp_unet_tpu_torch.ops.kernels import clahe_interp as tci
from att_aspp_unet_tpu_torch.ops.kernels import fused_conv as tfc


@pytest.fixture
def rng():
    return np.random.default_rng(2025)


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


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


# The eight pair shapes of the base_c 48 model at a 512 input, at N=2.
MAIN_PATH_PAIRS = [(1, 48, 48, 512), (48, 96, 96, 256), (96, 192, 192, 128),
                   (192, 384, 384, 64), (768, 384, 384, 64),
                   (384, 192, 192, 128), (192, 96, 96, 256), (96, 48, 48, 512)]


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cmid,cout,hw", MAIN_PATH_PAIRS + [(5, 7, 6, 20)])
def test_fused_double_cbr_kernel_matches_plain(rng, cuda_device, cin, cmid,
                                               cout, hw):
    x, w1, w2, ((g1, b1, m1, v1), (g2, b2, m2, v2)) = _pair_case(
        rng, 2, cin, cmid, cout, hw, hw + 4 if hw < 64 else hw)
    s1, o1 = tfc.fold_batchnorm(g1, b1, m1, v1)
    s2, o2 = tfc.fold_batchnorm(g2, b2, m2, v2)
    dev, bf = cuda_device, torch.bfloat16
    args = (torch.from_numpy(x).to(dev, bf),
            (tfc.pack_conv_weight(w1) / np.sqrt(cin)).to(dev, bf),
            torch.from_numpy(s1).to(dev), torch.from_numpy(o1).to(dev),
            (tfc.pack_conv_weight(w2) / np.sqrt(cmid)).to(dev, bf),
            torch.from_numpy(s2).to(dev), torch.from_numpy(o2).to(dev))
    before = tfc.fused_double_cbr.launches
    got = tfc.fused_double_cbr(*args)
    torch.cuda.synchronize()
    assert tfc.fused_double_cbr.launches == before + 1
    want = tfc.fused_double_cbr_reference(*args)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
def test_clahe_interp_kernel_bit_exact(rng, cuda_device):
    N, B, P = 3, 81, 6603
    blocks = rng.integers(-1, 256, (N, B, P)).astype(np.int32)
    luts = np.sort(rng.random((N, B, 256, 4)) * 255, axis=2).round() \
        .astype(np.float32)
    w = rng.random((P, 4)).astype(np.float32)
    w /= w.sum(axis=1, keepdims=True)
    args = [torch.from_numpy(a).to(cuda_device) for a in (blocks, luts, w)]
    got = tci.clahe_interp(*args)
    torch.cuda.synchronize()
    want = tci.clahe_interp_reference(*args)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    x = torch.zeros(1, 4, 8, 8, device=cuda_device)          # f32, not bf16
    w = torch.zeros(4, 36, device=cuda_device, dtype=torch.bfloat16)
    s = torch.ones(4, device=cuda_device)
    with pytest.raises(TypeError):
        tfc.fused_double_cbr(x, w, s, s, w, s, s)
    blocks = torch.zeros(1, 2, 5, dtype=torch.int64, device=cuda_device)
    with pytest.raises(TypeError):
        tci.clahe_interp(blocks, torch.zeros(1, 2, 256, 4, device=cuda_device),
                         torch.zeros(5, 4, device=cuda_device))
