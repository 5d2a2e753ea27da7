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

from att_aspp_unet_tpu_torch import bench
from att_aspp_unet_tpu_torch.ops.kernels import clahe_interp as tci
from att_aspp_unet_tpu_torch.ops.kernels import fused_conv as tfc
from att_aspp_unet_tpu_torch.ops.kernels import int8_conv as tic
from chip_smoke import bf16_ulps


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


@pytest.mark.cuda
def test_kernels_on_the_last_card_while_the_current_is_card_0(rng,
                                                              cuda_device):
    """K1 and K2 on tensors of the last visible card with ``cuda:0`` current
    (where one process serving over several cards first breaks): each
    launches on its input's card and equals its plain version.  With one
    card, the last is card 0."""
    from att_aspp_unet_tpu_torch.ops.clahe import clahe_tables

    last = torch.device("cuda", torch.cuda.device_count() - 1)
    with torch.cuda.device(0):
        args = _pair_args(rng, last, 4, 96, 96, 96, 64, 64)
        got = _assert_kernel_matches_plain(args)
        assert got.device == last
        u8 = torch.from_numpy(rng.integers(0, 256, (8, 562, 744))
                              .astype(np.uint8)).to(last)
        blocks, luts, wts = clahe_tables(u8)
        before = tci.clahe_interp.launches
        out = tci.clahe_interp(blocks, luts, wts)
        torch.cuda.synchronize(last)
        assert tci.clahe_interp.launches == before + 1
        assert out.device == last
        assert torch.equal(out, tci.clahe_interp_reference(blocks, luts, wts))
        assert torch.cuda.current_device() == 0


# K1's calibration mode (the int8 path): absmax of the intermediate against
# the plain version's, on both paths; the served output unchanged.
@pytest.mark.cuda
@pytest.mark.parametrize("wgmma", [False, True])
@pytest.mark.parametrize("N,cin,cmid,cout,H,W",
                         [(2, 1, 48, 48, 64, 72), (2, 96, 48, 48, 72, 40),
                          (1, 768, 384, 384, 64, 64), (2, 48, 80, 72, 50, 23)])
def test_fused_double_cbr_calibration_absmax(rng, cuda_device, N, cin, cmid,
                                             cout, H, W, wgmma):
    if wgmma and not tfc.wgmma_takes(cin, cmid, cout):
        pytest.skip("the wgmma path does not take this shape")
    args = _pair_args(rng, cuda_device, N, cin, cmid, cout, H, W)
    packed = tfc.prepack_pair(args[1], args[4], wgmma=wgmma)
    served = tfc.fused_double_cbr(*args, packed=packed)
    amax = torch.zeros((), dtype=torch.float32, device=cuda_device)
    got = tfc.fused_double_cbr(*args, packed=packed, absmax=amax)
    torch.cuda.synchronize()
    assert torch.equal(got, served)
    want = torch.zeros((), dtype=torch.float32, device=cuda_device)
    tfc.fused_double_cbr_reference(*args, absmax=want)
    assert float(amax) > 0
    assert abs(float(amax) - float(want)) <= 2e-2 * float(want)
    # a running max: a second launch on a larger value keeps it
    big = torch.full((), 1e30, dtype=torch.float32, device=cuda_device)
    before = float(big)
    tfc.fused_double_cbr(*args, packed=packed, absmax=big)
    assert float(big) == before


def _int8_args(rng, dev, N, cin, cout, H, W):
    """K3's arguments on ``dev``: a bf16 channel-last x spanning the int8
    range (some values clip), int8 weights with their scales, s_x, folded
    BN."""
    x = torch.from_numpy((rng.standard_normal((N, cin, H, W)) * 2)
                         .astype(np.float32))
    wq = torch.from_numpy(rng.integers(-127, 128, (cout, 9 * cin))
                          .astype(np.int8))
    ws = torch.from_numpy((rng.random(cout) * 1e-3 + 1e-4).astype(np.float32))
    s_x = torch.tensor(5.0 / 127, dtype=torch.float32)
    sc = torch.from_numpy((rng.random(cout) + 0.5).astype(np.float32))
    bi = torch.from_numpy((rng.standard_normal(cout) * 0.1).astype(np.float32))
    bf = torch.bfloat16
    return (x.to(dev, bf).contiguous(memory_format=torch.channels_last),
            wq.to(dev), ws.to(dev), s_x.to(dev), sc.to(dev), bi.to(dev))


# The conv shapes K3 takes on the int8 path (N, Cin, Cout, H = W): the
# sixteen convs of the base_c 48 model at 512 (the direct path's 32-frame
# micro-batch cut to 2 frames), at 224 (the ROI path), the --no_aspp bridge
# conv, and ragged ones (frames no multiple of the tile, channel counts no
# multiple of 8 or 64, Cin = 1 with several row blocks).
INT8_CONVS = sorted({(2, cin, cmid, hw) for _, cin, cmid, _, hw in
                     tfc.model_pairs(48, 512)}
                    | {(2, cmid, cout, hw) for _, _, cmid, cout, hw in
                       tfc.model_pairs(48, 512)}
                    | {(2, cin, cmid, hw) for _, cin, cmid, _, hw in
                       tfc.model_pairs(48, 224)}
                    | {(2, 384, 768, 32)})
INT8_EDGE = [(1, 1, 80, 37, 50), (3, 5, 7, 9, 7), (2, 24, 40, 33, 47),
             (2, 48, 8, 20, 20)]


@pytest.mark.cuda
@pytest.mark.parametrize("N,cin,cout,hw", INT8_CONVS)
def test_int8_conv3x3_kernel_matches_plain(rng, cuda_device, N, cin, cout, hw):
    """Accumulators exact; the bf16 outputs within one ulp of the plain
    version (its f32 affine is the kernel's fma, up to double rounding)."""
    args = _int8_args(rng, cuda_device, N, cin, cout, hw, hw)
    before = tic.int8_conv3x3.launches
    acc = tic.int8_conv3x3(*args, raw=True)
    got = tic.int8_conv3x3(*args)
    torch.cuda.synchronize()
    assert tic.int8_conv3x3.launches == before + 2
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(acc, tic.int8_conv3x3_reference(*args, raw=True))
    assert bf16_ulps(got, tic.int8_conv3x3_reference(*args)) <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("N,cin,cout,H,W", INT8_EDGE)
def test_int8_conv3x3_kernel_edge_shapes(rng, cuda_device, N, cin, cout, H, W):
    args = _int8_args(rng, cuda_device, N, cin, cout, H, W)
    assert torch.equal(tic.int8_conv3x3(*args, raw=True),
                       tic.int8_conv3x3_reference(*args, raw=True))
    assert bf16_ulps(tic.int8_conv3x3(*args),
                      tic.int8_conv3x3_reference(*args)) <= 1


@pytest.mark.cuda
def test_int8_conv3x3_prepacked_and_rejects(rng, cuda_device):
    args = _int8_args(rng, cuda_device, 2, 48, 96, 32, 32)
    packed = tic.prepack_int8_weight(args[1])
    assert packed.rows == 96
    assert torch.equal(tic.int8_conv3x3(*args, packed=packed),
                       tic.int8_conv3x3(*args))
    with pytest.raises(ValueError):
        tic.int8_conv3x3(*args, packed=packed._replace(w=packed.w[:-16]))
    with pytest.raises(ValueError):
        tic.int8_conv3x3(*args, packed=packed.w)
    with pytest.raises(ValueError, match="channels_last"):
        tic.int8_conv3x3(args[0].contiguous(), *args[1:])
    with pytest.raises(TypeError):
        tic.int8_conv3x3(args[0].float(), *args[1:])
    with pytest.raises(ValueError):
        tic.int8_conv3x3(*args, raw=True, s_out=args[3])
    with pytest.raises(RuntimeError):     # packed for another plan
        tic.int8_conv3x3(*args, packed=tic.PackedInt8(
            tic._prepack_wgmma(args[1], 48), 48))


# Shapes both of K3's paths take: every main-path and ROI conv shape whose
# channels the wgmma path takes (at 2 frames: output channels a multiple of
# 48, input channels whole 16-byte groups or one), and frames that are no
# multiple of its tile (rows and columns ragged; narrower than 64: the flat
# M chunks).
INT8_BOTH = sorted({(N, cin, cout, hw, hw) for N, cin, cout, hw in INT8_CONVS
                    if cout % 48 == 0 and (cin == 1 or cin % 16 == 0)}
                   | {(1, 48, 96, 37, 50), (2, 1, 48, 19, 70),
                      (1, 384, 768, 9, 13), (3, 96, 48, 5, 130),
                      (1, 768, 384, 11, 66), (2, 192, 192, 2, 3)})


@pytest.mark.cuda
@pytest.mark.parametrize("wgmma", [True, False], ids=["wgmma", "mma_sync"])
@pytest.mark.parametrize("N,cin,cout,H,W", INT8_BOTH)
def test_int8_conv3x3_each_path_matches_plain(rng, cuda_device, N, cin, cout,
                                              H, W, wgmma):
    """Each path on the shapes both take (the wgmma path the one the wrapper
    picks there): accumulators exact, bf16 outputs within one ulp of the
    plain version."""
    args = _int8_args(rng, cuda_device, N, cin, cout, H, W)
    packed = tic.prepack_int8_weight(args[1], mma_sync=not wgmma)
    assert (packed.rows != 0) == wgmma
    acc = tic.int8_conv3x3(*args, packed=packed, raw=True)
    got = tic.int8_conv3x3(*args, packed=packed)
    torch.cuda.synchronize()
    assert torch.equal(acc, tic.int8_conv3x3_reference(*args, raw=True))
    assert bf16_ulps(got, tic.int8_conv3x3_reference(*args)) <= 1


# The int8 intermediate's modes, on the path the wrapper picks and on the
# mma.sync path: the two convs of a main-path pair at 2 frames and ragged
# shapes of both paths.
INT8_MODES = [(2, 1, 48, 64, 64), (2, 48, 48, 64, 64), (2, 96, 192, 32, 32),
              (2, 768, 384, 16, 16), (1, 48, 96, 37, 50), (3, 5, 7, 9, 7),
              (2, 24, 40, 33, 47)]


@pytest.mark.cuda
@pytest.mark.parametrize("mma_sync", [False, True], ids=["chosen", "mma_sync"])
@pytest.mark.parametrize("N,cin,cout,H,W", INT8_MODES)
def test_int8_conv3x3_int8_output_and_input_modes(rng, cuda_device, N, cin,
                                                  cout, H, W, mma_sync):
    """The output quantized with ``s_out`` is bit-equal to ``quantize_act``
    of the plain bf16 result; an int8 input (the quantized x) gives the
    accumulators exactly and the bf16 outputs within one ulp."""
    args = _int8_args(rng, cuda_device, N, cin, cout, H, W)
    packed = tic.prepack_int8_weight(args[1], mma_sync=mma_sync)
    plain = tic.int8_conv3x3_reference(*args)
    s_out = (plain.float().amax() / 127).reshape(())
    q = tic.int8_conv3x3(*args, packed=packed, s_out=s_out)
    xq = tic.quantize_act(args[0], args[3]).contiguous(
        memory_format=torch.channels_last)
    acc = tic.int8_conv3x3(xq, *args[1:], packed=packed, raw=True)
    got = tic.int8_conv3x3(xq, *args[1:], packed=packed)
    torch.cuda.synchronize()
    assert q.dtype == torch.int8
    assert q.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(q, tic.quantize_act(plain, s_out))
    assert torch.equal(acc, tic.int8_conv3x3_reference(*args, raw=True))
    assert bf16_ulps(got, plain) <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cmid,cout,hw", [(1, 48, 48, 64), (96, 48, 48, 40),
                                              (384, 192, 192, 16)])
def test_int8_pair_on_the_card_matches_plain(rng, cuda_device, cin, cmid,
                                             cout, hw):
    """Int8CBRPair: two launches with the int8 intermediate, against the
    same module's plain forward on the CPU (bf16 within one ulp)."""
    from att_aspp_unet_tpu_torch.nn.blocks import Int8CBRPair

    pair = Int8CBRPair(cin, cmid, cout)
    a1 = _int8_args(rng, "cpu", 2, cin, cmid, hw, hw)
    a2 = _int8_args(rng, "cpu", 2, cmid, cout, hw, hw)
    with torch.no_grad():
        for i, a in ((1, a1), (2, a2)):
            for name, t in (("w", a[1]), ("w_scale", a[2]), ("s", a[4]),
                            ("b", a[5])):
                getattr(pair, f"{name}{i}").copy_(t)
        pair.s_x1.fill_(5.0 / 127)
        h = tic.int8_conv3x3(*a1)            # the intermediate, plain
        pair.s_x2.fill_(float(h.float().amax()) / 100)   # some values clip
    want = pair(a1[0])
    before = tic.int8_conv3x3.launches
    got = pair.to(cuda_device)(a1[0].to(cuda_device))
    torch.cuda.synchronize()
    assert tic.int8_conv3x3.launches == before + 2
    assert bf16_ulps(got.cpu(), want) <= 1


@pytest.mark.cuda
def test_bench_quantile_of_a_sweep_on_the_card(cuda_device):
    """The benchmark's random-weights threshold: the 0.97 quantile of a
    140 x 562 x 744 probability field on the card (``torch.quantile`` takes
    at most 2**24 elements)."""
    a = np.random.default_rng(3).random(140 * 562 * 744, dtype=np.float32)
    got = bench.quantile(torch.from_numpy(a).to(cuda_device), 0.97)
    assert got == np.quantile(a.astype(np.float64), 0.97, method="linear")


# The Swin UNETR kernels (``ops/kernels/swin_ops.py``, ``window_attn.py``)
# at the widths of the published model, against their plain versions.


@pytest.mark.cuda
@pytest.mark.parametrize("C", [48, 96, 192, 384, 768, 1536])
@pytest.mark.parametrize("residual", [False, True])
def test_swin_layer_norm_on_the_card_matches_plain(cuda_device, C, residual):
    from att_aspp_unet_tpu_torch.ops.kernels import swin_ops as sn

    g = torch.Generator(device=cuda_device).manual_seed(C)
    x = (torch.randn(1001, C, device=cuda_device, generator=g) * 2 + 1) \
        .bfloat16()
    r = torch.randn_like(x) if residual else None
    w = (torch.randn(C, device=cuda_device, generator=g) + 1).bfloat16()
    b = torch.randn(C, device=cuda_device, generator=g).bfloat16()
    for args in ((w, b), (None, None)):
        s, y = sn.layer_norm(x, *args, 1e-5, r)
        s0, y0 = sn.layer_norm_reference(x, *args, 1e-5, r)
        assert torch.equal(s, s0)
        # one bf16 rounding of the output apart, at most
        torch.testing.assert_close(y, y0, rtol=8e-3, atol=8e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("C,hw", [(48, (448, 576)), (96, (112, 144)),
                                  (768, (14, 18)), (32, (448, 576)),
                                  (64, (224, 288)), (512, (7, 9))])
@pytest.mark.parametrize("mode", ["act", "residual", "normed_residual"])
def test_swin_instance_norm_on_the_card_matches_plain(cuda_device, C, hw,
                                                      mode):
    from att_aspp_unet_tpu_torch.ops.kernels.instance_norm import \
        InstanceNorm
    from att_aspp_unet_tpu_torch.ops.kernels import swin_ops as sn

    g = torch.Generator(device=cuda_device).manual_seed(C)

    def draw():
        return (torch.randn(2, C, *hw, device=cuda_device, generator=g) * 3
                + 1).bfloat16().contiguous(memory_format=torch.channels_last)

    x, r = draw(), draw()
    n1, n2 = InstanceNorm(C, device=cuda_device), \
        InstanceNorm(C, device=cuda_device)
    kw = {"residual": r} if mode == "residual" else \
        {"residual": r, "residual_norm": n2} if mode == "normed_residual" \
        else {}
    y = sn.instance_norm_act(x, n1, 0.01, **kw)
    y0 = sn.instance_norm_act_reference(x, n1, 0.01, **kw)
    assert y.is_contiguous(memory_format=torch.channels_last)
    torch.testing.assert_close(y, y0, rtol=8e-3, atol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("channels_last_weights", [True, False])
def test_plain_unet_forward_through_the_norm_kernels_matches_the_plain_path(
        cuda_device, monkeypatch, channels_last_weights):
    """The plan's PlainConvUNet (seed 0, bf16) on 4 synthetic 448 x 576
    frames with their mirror views: each of the 26 norms goes through the
    kernels; the logits lie no farther from the same weights' f32 forward
    (TF32 off) than the plain bf16 path's do, within a tenth, within 0.013
    relative RMS of the plain path's (read: 0.0108 on an H100), and agree
    with the plain path's argmax on 99.5 % of the pixels.  With the weights
    channel-last, as the engine holds them, every conv output already is;
    without, the first conv's output (of the 1-channel input) is made so."""
    from att_aspp_unet_tpu_torch.config import PlainUNetConfig
    from att_aspp_unet_tpu_torch.models import PlainConvUNet
    from att_aspp_unet_tpu_torch.ops.kernels import instance_norm
    from att_aspp_unet_tpu_torch.ops.kernels import swin_ops as sn
    from att_aspp_unet_tpu_torch.tools.synthetic import make_sweep

    cfg = PlainUNetConfig()
    model = PlainConvUNet.from_config(cfg, device=cuda_device, seed=0)
    if channels_last_weights:
        model = model.to(memory_format=torch.channels_last)
    frames, _, _ = make_sweep(4, 448, 576, seed=0, best_frame=2)
    x = torch.from_numpy(frames).to(cuda_device)[:, None].float() / 255
    x = torch.cat([x] + [torch.flip(x, v) for v in ((-1,), (-2,), (-2, -1))])
    applies, layouts = instance_norm.fused_norm_applies, []

    def watch(y):
        layouts.append(y.is_contiguous(memory_format=torch.channels_last))
        return applies(y)

    monkeypatch.setattr(instance_norm, "fused_norm_applies", watch)
    before = sn.instance_norm_act.launches
    got = model(x)
    assert sn.instance_norm_act.launches - before == 26
    assert len(layouts) == 26 and all(layouts[1:])
    assert layouts[0] or not channels_last_weights
    monkeypatch.setattr(instance_norm, "fused_norm_applies", lambda y: False)
    plain = model(x)
    f32 = PlainConvUNet(dataclasses.replace(cfg, compute_dtype="float32"),
                        device=cuda_device)
    f32.load_state_dict(model.state_dict())
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    want = f32.eval()(x)

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    agree = float((got.argmax(1) == plain.argmax(1)).float().mean())
    print(f"logits' relative RMS from f32: kernel path {rel(got, want):.5f}, "
          f"plain path {rel(plain, want):.5f}; kernel from plain "
          f"{rel(got, plain):.5f}; argmax equal to the plain path's on "
          f"{100 * agree:.3f} %, to f32's on "
          f"{100 * float((got.argmax(1) == want.argmax(1)).float().mean()):.3f}"
          f" % (plain {100 * float((plain.argmax(1) == want.argmax(1)).float().mean()):.3f} %)")
    assert rel(got, want) <= 1.1 * rel(plain, want) and agree >= 0.995
    assert rel(got, plain) <= 0.013


@pytest.mark.cuda
@pytest.mark.parametrize("B,hw,heads,shift", [
    (2, (224, 288), 3, 3), (2, (112, 144), 6, 0), (2, (28, 36), 24, 3),
    (3, (13, 20), 2, 3), (2, (6, 20), 1, 3), (2, (4, 6), 2, 3)])
def test_window_attn_on_the_card_matches_plain(cuda_device, B, hw, heads,
                                               shift):
    from att_aspp_unet_tpu_torch.models.swin_unetr import \
        relative_position_index
    from att_aspp_unet_tpu_torch.ops.kernels import window_attn as wa

    g = torch.Generator(device=cuda_device).manual_seed(heads + shift)
    C = 16 * heads
    qkv = torch.randn(B, *hw, 3 * C, device=cuda_device, generator=g) \
        .bfloat16()
    bias = torch.randn(3 * C, device=cuda_device, generator=g).bfloat16()
    table = torch.randn(169, heads, device=cuda_device, generator=g)
    index = relative_position_index(7).to(cuda_device)
    o = wa.window_attn(qkv, bias, table, index, heads, 7, shift)
    o0 = wa.window_attn_reference(qkv, bias, table, index, heads, 7, shift)
    # the kernel's probabilities are rounded to bf16 for the second product
    rel = float((o.float() - o0.float()).norm() / o0.float().norm())
    assert rel < 1e-2, rel


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [(448, 576), (13, 20)])
def test_swin_stem_on_the_card_matches_plain(cuda_device, hw):
    from att_aspp_unet_tpu_torch.ops.kernels import swin_ops as sn

    g = torch.Generator(device=cuda_device).manual_seed(7)
    x = torch.rand(3, 1, *hw, device=cuda_device, generator=g).bfloat16()
    w3 = (torch.randn(48, 1, 3, 3, device=cuda_device, generator=g) / 3) \
        .bfloat16()
    w1 = torch.randn(48, 1, 1, 1, device=cuda_device, generator=g).bfloat16()
    y, r = sn.stem_convs(x, w3, w1)
    y0, r0 = sn.stem_convs_reference(x, w3, w1)
    assert y.is_contiguous(memory_format=torch.channels_last)
    torch.testing.assert_close(y, y0, rtol=8e-3, atol=8e-3)
    assert torch.equal(r, r0)
