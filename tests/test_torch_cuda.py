"""The hand-written CUDA kernels against their plain PyTorch versions, on a
card.  Every test here carries the ``cuda`` marker and skips without a CUDA
device.  The file imports neither JAX nor the JAX package, so it also runs
where only PyTorch is installed:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import dataclasses

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
MAIN_PATH_PAIRS = [p[1:] for p in tfc.model_pairs(48, 512)]


def _pair_args(rng, dev, N, cin, cmid, cout, H, W):
    """Kernel arguments on ``dev``: bf16 x in channel-last memory, canonical
    packed weights, folded BN."""
    x, w1, w2, ((g1, b1, m1, v1), (g2, b2, m2, v2)) = _pair_case(
        rng, N, cin, cmid, cout, H, W)
    s1, o1 = tfc.fold_batchnorm(g1, b1, m1, v1)
    s2, o2 = tfc.fold_batchnorm(g2, b2, m2, v2)
    bf = torch.bfloat16
    return (torch.from_numpy(x).to(dev, bf)
            .contiguous(memory_format=torch.channels_last),
            (tfc.pack_conv_weight(w1) / np.sqrt(cin)).to(dev, bf),
            torch.from_numpy(s1).to(dev), torch.from_numpy(o1).to(dev),
            (tfc.pack_conv_weight(w2) / np.sqrt(cmid)).to(dev, bf),
            torch.from_numpy(s2).to(dev), torch.from_numpy(o2).to(dev))


def _assert_kernel_matches_plain(args, wgmma=None):
    """One launch against the plain version at rtol/atol 2e-2; ``wgmma``
    forces a path (None: the one the wrapper picks)."""
    packed = tfc.prepack_pair(args[1], args[4], wgmma=wgmma)
    before = tfc.fused_double_cbr.launches
    got = tfc.fused_double_cbr(*args, packed=packed)
    torch.cuda.synchronize()
    assert tfc.fused_double_cbr.launches == before + 1
    assert got.is_contiguous(memory_format=torch.channels_last)
    want = tfc.fused_double_cbr_reference(*args)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=2e-2, atol=2e-2)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cmid,cout,hw", MAIN_PATH_PAIRS + [(5, 7, 6, 20)])
def test_fused_double_cbr_kernel_matches_plain(rng, cuda_device, cin, cmid,
                                               cout, hw):
    """The mma.sync path, which takes every shape."""
    _assert_kernel_matches_plain(_pair_args(
        rng, cuda_device, 2, cin, cmid, cout, hw, hw + 4 if hw < 64 else hw),
        wgmma=False)


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cmid,cout,hw", MAIN_PATH_PAIRS[1:])
def test_fused_double_cbr_wgmma_path_matches_plain(rng, cuda_device, cin, cmid,
                                                   cout, hw):
    """The wgmma path at the seven main-path shapes it takes (it is the path
    the wrapper picks for them)."""
    assert tfc.wgmma_takes(cin, cmid, cout)
    _assert_kernel_matches_plain(_pair_args(rng, cuda_device, 2, cin, cmid,
                                            cout, hw, hw), wgmma=True)


# N = 1; a frame that is no multiple of the tile; Cmid != Cout; channel
# counts that are multiples of 8 but not of 16; Cin = 1 with several row
# blocks (the tap-as-K path with more than one block of rows).
EDGE_PAIRS = [(1, 96, 48, 48, 512, 512), (1, 768, 384, 384, 64, 64),
              (2, 96, 48, 48, 72, 40), (2, 32, 64, 16, 64, 64),
              (2, 24, 40, 8, 33, 47), (1, 1, 80, 48, 37, 50),
              (3, 16, 16, 8, 9, 7), (2, 48, 80, 72, 50, 23)]


@pytest.mark.cuda
@pytest.mark.parametrize("wgmma", [False, True])
@pytest.mark.parametrize("N,cin,cmid,cout,H,W", EDGE_PAIRS)
def test_fused_double_cbr_kernel_edge_shapes(rng, cuda_device, N, cin, cmid,
                                             cout, H, W, wgmma):
    if wgmma and not tfc.wgmma_takes(cin, cmid, cout):
        with pytest.raises(ValueError):
            tfc.prepack_pair(torch.zeros(cmid, 9 * cin),
                             torch.zeros(cout, 9 * cmid), wgmma=True)
        return
    _assert_kernel_matches_plain(_pair_args(rng, cuda_device, N, cin, cmid,
                                            cout, H, W), wgmma=wgmma)


# The serving modes' shapes beyond the direct path: the base_c 16 scout at
# 128x128 (frames down to 16x16, one tile; narrow pairs whose rows the wgmma
# path pads to 64) and the base_c 48 model on the 224x224 ROI (28x28 and
# 56x56 frames, ragged against the 8- and 16-row tiles).
SCOUT_PAIRS = [(3,) + p[1:] for p in tfc.model_pairs(16, 128)]
ROI_PAIRS = [(2,) + p[1:] for p in tfc.model_pairs(48, 224)]


@pytest.mark.cuda
@pytest.mark.parametrize("wgmma", [None, False])
@pytest.mark.parametrize("N,cin,cmid,cout,hw", SCOUT_PAIRS + ROI_PAIRS)
def test_fused_double_cbr_serving_shapes(rng, cuda_device, N, cin, cmid, cout,
                                         hw, wgmma):
    """The sixteen scout and ROI shapes, on the path the wrapper picks
    (``wgmma=None``) and on the mma.sync path."""
    _assert_kernel_matches_plain(_pair_args(rng, cuda_device, N, cin, cmid,
                                            cout, hw, hw), wgmma=wgmma)


@pytest.mark.cuda
def test_fused_double_cbr_scout_batch_of_128(rng, cuda_device):
    """The scout's micro-batch of an 840-frame case: N = 128 rides in the
    grid's z dimension."""
    _assert_kernel_matches_plain(_pair_args(rng, cuda_device, 128, 32, 16, 16,
                                            128, 128))


@pytest.mark.cuda
@pytest.mark.parametrize("cin", [96, 24])
def test_fused_double_cbr_prepacked_equals_on_the_fly(rng, cuda_device, cin):
    """Either path (Cin 96: wgmma, Cin 24: mma.sync): weights prepacked once
    and weights prepacked inside the call give equal bits; a prepacked
    buffer of the wrong size is refused."""
    args = _pair_args(rng, cuda_device, 2, cin, 48, 48, 72, 40)
    packed = tfc.prepack_pair(args[1], args[4])
    assert packed.wgmma == (cin == 96)
    assert torch.equal(tfc.fused_double_cbr(*args, packed=packed),
                       tfc.fused_double_cbr(*args))
    wrong = packed._replace(w1p=packed.w1p[:-8])
    with pytest.raises(ValueError):
        tfc.fused_double_cbr(*args, packed=wrong)


@pytest.mark.cuda
def test_fused_double_cbr_rejects_contiguous_nchw(rng, cuda_device):
    args = _pair_args(rng, cuda_device, 1, 8, 16, 16, 32, 32)
    with pytest.raises(ValueError, match="channels_last"):
        tfc.fused_double_cbr(args[0].contiguous(), *args[1:])


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
@pytest.mark.parametrize("shape", [(8, 562, 744), (64, 128, 128),
                                   (140, 256, 256), (840, 562, 744),
                                   (8, 512, 512)])
def test_clahe_kernel_bit_exact_on_serving_stacks(rng, cuda_device, shape):
    """K2 through CLAHE's own tables: the 8 promoted frames of a cascade at
    native size, stacks at the scouts' sizes, where a CLAHE tile is 16x16
    (128 px) or 32x32 pixels (256 px), the baseline's whole 840-frame case at
    native size, and a train step's batch at the CLI's defaults (8 frames at
    512 x 512)."""
    from att_aspp_unet_tpu_torch.ops.clahe import clahe_finish, clahe_tables

    u8 = torch.from_numpy(rng.integers(0, 256, shape).astype(np.uint8)) \
        .to(cuda_device)
    blocks, luts, wts = clahe_tables(u8)
    before = tci.clahe_interp.launches
    got = tci.clahe_interp(blocks, luts, wts)
    torch.cuda.synchronize()
    assert tci.clahe_interp.launches == before + 1
    want = tci.clahe_interp_reference(blocks, luts, wts)
    assert torch.equal(got, want)
    assert torch.equal(clahe_finish(got, shape[1:]),
                       clahe_finish(want, shape[1:]))


@pytest.mark.cuda
def test_bin_counts_on_the_card_equals_bincount_and_reads_nothing(
        rng, cuda_device):
    """``bin_counts`` runs ``torch.histc`` on int64 values there: exact for
    bin indices beyond 2^24 (an 840-frame CLAHE has 17 million bins), and
    without a read-back (``torch.bincount`` has two)."""
    from att_aspp_unet_tpu_torch.ops.image import bin_counts

    n_bins = 840 * 81 * 256
    idx = torch.from_numpy(rng.integers(0, n_bins, 3_000_000)).to(cuda_device)
    idx[:1000] = n_bins - 1
    idx[1000:2000] = 0
    want = torch.bincount(idx, minlength=n_bins)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = bin_counts(idx, n_bins)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert got.dtype == torch.int64 and torch.equal(got, want)


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


@pytest.mark.cuda
def test_baseline_engine_on_the_card_equals_the_cpu(rng, cuda_device):
    """The baseline path at a small size (base 4 capped at 16, 3 stages, 32 x
    32 patches, f32, TF32 off) on the card and on the CPU from the same
    seeded model: softmax within atol 1e-4, K2 launched once, and the
    postprocess of the card's softmax stack label-identical on both
    devices, with the same frame."""
    from att_aspp_unet_tpu_torch.config import Config, PlainUNetConfig
    from att_aspp_unet_tpu_torch.infer.container import \
        select_labeled_mask_and_frame
    from att_aspp_unet_tpu_torch.infer.engine import BaselineEngine
    from att_aspp_unet_tpu_torch.models import PlainConvUNet

    cfg = Config(plain_unet=PlainUNetConfig(
        base_c=4, max_c=16, n_stages=3, patch_size=(32, 32),
        compute_dtype="float32"))
    sweep = rng.integers(0, 256, (5, 40, 56)).astype(np.uint8)
    sweep[:, 10:30, 12:44] = 240
    model = PlainConvUNet.from_config(cfg.plain_unet, seed=2)
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        before = tci.clahe_interp.launches
        card = BaselineEngine(cfg, model, device=cuda_device)
        got = card.predict(sweep)
        assert tci.clahe_interp.launches == before + 1
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    cpu = BaselineEngine(cfg, model, device="cpu")
    want = cpu.predict(sweep)
    assert got.shape == want.shape == (3, 5, 40, 56)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0,
                               atol=1e-4)
    seg_card = card.postprocess(got).cpu()
    seg_cpu = cpu.postprocess(got.cpu())
    assert torch.equal(seg_card, seg_cpu)
    assert select_labeled_mask_and_frame(seg_card)[1] == \
        select_labeled_mask_and_frame(seg_cpu)[1]


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(gate_variant="v2"),
                                dict(gate_variant="v2", att_depth=3),
                                dict(use_aspp=False),
                                dict(gate_variant="v2", use_att=False,
                                     use_aspp=False, att_depth=0)],
                         ids=["v2", "v2-depth3", "no_aspp", "v2-bare"])
def test_variant_forward_on_the_card_matches_plain(rng, cuda_device, kw):
    """A variant of the bf16 model (base_c 16, seeded init with random BN
    statistics) on 2 frames at 128 x 128: the card (K1 on every pair, cuDNN
    for the ``--no_aspp`` bridge) against the CPU's plain versions.  Logits
    within 2e-2 of their range, every psi map within 2e-2, and K1 launched
    once per pair."""
    from att_aspp_unet_tpu_torch.config import ModelConfig
    from att_aspp_unet_tpu_torch.utils.convert import (init_variables,
                                                       jax_variables_to_torch)

    cfg = ModelConfig(base_c=16, **kw)
    variables = init_variables(cfg, seed=0)
    for bs in variables["batch_stats"].values():
        for leaf in _bn_leaves(bs):
            leaf["mean"][:] = rng.standard_normal(leaf["mean"].shape) * 0.1
            leaf["var"][:] = rng.random(leaf["var"].shape) * 0.5 + 0.75
    x = torch.from_numpy(rng.random((2, 1, 128, 128)).astype(np.float32))
    before = tfc.fused_double_cbr.launches
    card = jax_variables_to_torch(variables, cfg, device=cuda_device)
    got, got_psi = card(x.to(cuda_device), return_psi=True)
    torch.cuda.synchronize()
    assert tfc.fused_double_cbr.launches == before + 8
    want, want_psi = jax_variables_to_torch(variables, cfg)(x,
                                                           return_psi=True)
    span = float(want.max() - want.min())
    assert float((got.cpu() - want).abs().max()) <= 2e-2 * span
    for g, w in zip(got_psi, want_psi):
        assert (g is None) == (w is None)
        if w is not None:
            assert float((g.float().cpu() - w.float()).abs().max()) <= 2e-2


def _bn_leaves(tree):
    """The BatchNorm statistics dicts ({"mean", "var"}) of a subtree."""
    if "mean" in tree:
        yield tree
        return
    for sub in tree.values():
        yield from _bn_leaves(sub)


@pytest.mark.cuda
def test_train_step_on_the_card_matches_the_cpu(rng, cuda_device):
    """One exact-f32 train step of the base_c 4 model on 4 frames at 64 x 64
    from the same seeded init and the same CPU-drawn augmentation: the
    augmented batch equal (K2 launched once), the loss within 1e-4 relative,
    every gradient within 1e-3 of its leaf's max-abs of the CPU's beyond
    twice the CPU's own f32 error against its f64 step (some leaves are sums
    that nearly cancel; f32 gets them to ~1e-2 on either device)."""
    from att_aspp_unet_tpu_torch.config import Config, ModelConfig
    from att_aspp_unet_tpu_torch.train.augment import (augment_batch,
                                                       sample_params)
    from att_aspp_unet_tpu_torch.train.train_loop import (create_train_state,
                                                          loss_and_grads)

    cfg = Config(model=ModelConfig(base_c=4, compute_dtype="float32",
                                   aspp_dropout=0.0))
    imgs = torch.from_numpy(rng.integers(0, 256, (4, 64, 64)).astype(np.uint8))
    msks = torch.zeros((4, 64, 64), dtype=torch.uint8)
    msks[:, 20:40, 16:44] = 255
    params = sample_params(torch.Generator().manual_seed(0), 4, 64, 64,
                           cfg.train.augment)
    out = {}
    for dev, dtype in (("cpu", "float64"), ("cpu", "float32"),
                       (cuda_device, "float32")):
        c = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, compute_dtype=dtype))
        before = tci.clahe_interp.launches
        x, y = augment_batch(imgs.to(dev), msks.to(dev), c.train.augment,
                             params)
        if dev != "cpu":
            torch.cuda.synchronize()
            assert tci.clahe_interp.launches == before + 1
        state = create_train_state(c.model, c.train, 1, dev)
        loss, _, grads = loss_and_grads(state, c, x, y)
        out[str(dev), dtype] = (x.cpu(), y.cpu(), float(loss.detach()),
                                [g.double().cpu() for g in grads])
    g64 = out["cpu", "float64"][3]
    (xc, yc, lc, gc), (xd, yd, ld, gd) = out["cpu", "float32"], \
        out[str(cuda_device), "float32"]
    assert torch.equal(xc, xd) and torch.equal(yc, yd)
    assert abs(ld - lc) <= 1e-4 * abs(lc)
    for a, b, r in zip(gd, gc, g64):
        scale = float(r.abs().max())
        own = float((b - r).abs().max())
        assert float((a - b).abs().max()) <= 1e-3 * scale + 2 * own
