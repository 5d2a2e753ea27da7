"""The port's int8 serving path (``nn/quant.py``, kernel K3's plain version,
the calibration forward, the int8 model, the engine's lazy calibration and
the CLIs' ``--int8``) against the JAX package's on the CPU.

Tiny sizes (base_c 4, network input 32, f32 unless a test says bf16).  The
quantizer is held bit-exact against the JAX package's as its serving engine
runs it (under ``jax.jit``, where XLA turns ``/ 127.0`` into ``* f32(1/127)``);
the integer conv exactly; model and engine outputs at the tolerances each
test states."""

import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from att_aspp_unet_tpu import cli as jcli
from att_aspp_unet_tpu.config import Config as JConfig
from att_aspp_unet_tpu.config import ModelConfig as JModelConfig
from att_aspp_unet_tpu.config import PredictConfig as JPredictConfig
from att_aspp_unet_tpu.config import PreprocessConfig as JPreprocessConfig
from att_aspp_unet_tpu.infer.engine import AttAsppEngine as JEngine
from att_aspp_unet_tpu.models import AttentionASPPUNet as JModel
from att_aspp_unet_tpu.nn import quant as jquant
from att_aspp_unet_tpu.utils import npz_weights as jnpz
from att_aspp_unet_tpu_torch import cli
from att_aspp_unet_tpu_torch.config import (Config, ModelConfig,
                                            PredictConfig, PreprocessConfig)
from att_aspp_unet_tpu_torch.infer.engine import AttAsppEngine
from att_aspp_unet_tpu_torch.io import MetaImage, read_json, read_mha, \
    write_mha
from att_aspp_unet_tpu_torch.nn import quant as tquant
from att_aspp_unet_tpu_torch.ops.kernels import fused_conv as tfc
from att_aspp_unet_tpu_torch.ops.kernels import int8_conv as tic
from att_aspp_unet_tpu_torch.utils import npz_weights as tnpz
from att_aspp_unet_tpu_torch.utils.convert import (jax_variables_to_torch,
                                                   quant_tree)

from .test_torch_model import random_variables
from .test_torch_threads import one_torch_thread  # noqa: F401

IMG = 32
SPACING = (0.28, 0.28)
PREDICT = dict(frame_batch=4, quant_calib_frames=4, roi_size=32,
               subsample_frames=6)
CASCADE = dict(cascade=True, cascade_img_size=16, cascade_scouts=6,
               cascade_scout_batch=4, bulk_frame_batch=4)


def jax_variables(use_aspp=True, seed=0, gain=1.0):
    return random_variables(4, seed, IMG, use_aspp, gain)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _sweep(seed, n=8, h=40, w=48):
    """Speckle with a bright ellipse whose size peaks at 0.55 n."""
    out = (np.random.default_rng(seed).random((n, h, w)) * 120
           ).astype(np.uint8)
    yy, xx = np.mgrid[:h, :w]
    for i in range(n):
        s = 0.25 + 0.75 * (1.0 - abs(i - 0.55 * n) / (0.6 * n))
        e = ((yy - 0.5 * h) / (0.33 * h * s)) ** 2 \
            + ((xx - 0.45 * w) / (0.3 * w * s)) ** 2 <= 1
        out[i][e] = np.minimum(out[i][e] + 130, 255)
    return out


def _cfgs(dtype="float32", **predict):
    jcfg = JConfig(preprocess=JPreprocessConfig(img_size=IMG),
                   model=JModelConfig(base_c=4, compute_dtype=dtype,
                                      conv_lowering="int8"),
                   predict=JPredictConfig(**PREDICT, **predict))
    cfg = Config(preprocess=PreprocessConfig(img_size=IMG),
                 model=ModelConfig(base_c=4, compute_dtype=dtype,
                                   conv_lowering="int8"),
                 predict=PredictConfig(**PREDICT, **predict))
    return jcfg, cfg


# ------------------------------------------------------------ the quantizer

def test_quantize_weight_bit_exact_against_jax_serving():
    """int8 values and scales equal to ``quantize_weight`` under jit (the
    JAX engine's ``jax.jit(prequantize_params)``); op by op JAX divides by
    127 instead, which moves some scales by one ulp."""
    rng = np.random.default_rng(0)
    k = rng.standard_normal((3, 3, 64, 512)).astype(np.float32)
    k[..., 0] = 0.0                                      # the 1e-12 floor
    jq, js = jax.jit(jquant.quantize_weight)(jnp.asarray(k))
    q, s = tquant.quantize_weight(tfc.pack_conv_weight(k))
    np.testing.assert_array_equal(q.numpy(),
                                  tfc.pack_conv_weight(np.asarray(jq)).numpy())
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert q.dtype == torch.int8 and int(q.abs().max()) == 127
    _, eager = jquant.quantize_weight(jnp.asarray(k))
    ulps = np.abs(np.asarray(eager).view(np.int32) - s.numpy().view(np.int32))
    assert ulps.max() == 1 and ulps.sum() > 0


def _within_ulps(a: np.ndarray, k: int):
    """``a`` and the f32 values up to ``k`` ulp below and above it."""
    out, lo, hi = [a], a, a
    for _ in range(k):
        lo = np.nextafter(lo, np.float32(-np.inf))
        hi = np.nextafter(hi, np.float32(np.inf))
        out += [lo, hi]
    return out


def test_quantize_act_ties_saturation_and_true_division():
    """Half to even, clipped at +-127, a true division by the scale (values
    where ``x * (1/s)`` rounds to another integer are in the draw)."""
    s1 = torch.tensor(1.0)
    got = tquant.quantize_act(torch.tensor([-10.0, -1.0, 0.0, 0.26, 127.5]),
                              s1)
    assert got.tolist() == [-10, -1, 0, 0, 127]
    ties = torch.tensor([0.5, 1.5, 2.5, -0.5, -2.5, 200.0, -300.0])
    assert tquant.quantize_act(ties, s1).tolist() == [0, 2, 2, 0, -2, 127,
                                                      -127]
    rng = np.random.default_rng(1)
    amax = np.float32(37.1)
    s_x = tquant.act_scale(amax)
    # the draw, and the f32 values within 4 ulp of every rounding boundary
    half = ((np.arange(-128, 128) + 0.5) * s_x).astype(np.float32)
    x = np.concatenate([(rng.standard_normal(200000) * 40).astype(np.float32)]
                       + _within_ulps(half, 4))
    want = jax.jit(lambda x, a: jquant.quantize_act(
        x, jnp.maximum(a, 1e-6) / 127.0))(x, amax)
    got = tquant.quantize_act(torch.from_numpy(x), torch.tensor(s_x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    recip = np.clip(np.round(x * (np.float32(1) / s_x)), -127, 127)
    assert (recip != got.numpy()).any()


@pytest.mark.parametrize("use_aspp", [True, False])
def test_prequantize_equals_jax_prequantize_params(use_aspp):
    """16 sites (17 with ``--no_aspp``): the same int8 kernels and w_scale
    leaves as the JAX engine's jitted ``prequantize_params``; idempotent on
    kernels that are int8 already."""
    params = _np_tree(jax_variables(use_aspp, seed=2)["params"])
    jq, jws = jax.jit(jquant.prequantize_params)(params)
    q, ws = tquant.prequantize(params, use_aspp)
    assert len(jax.tree_util.tree_leaves(ws)) == (16 if use_aspp else 17)
    flat_j = jax.tree_util.tree_leaves_with_path(_np_tree(jq))
    flat_t = dict(jax.tree_util.tree_leaves_with_path(q))
    for path, leaf in flat_j:
        np.testing.assert_array_equal(flat_t[path], leaf)
        assert flat_t[path].dtype == leaf.dtype
    jax.tree_util.tree_map(np.testing.assert_array_equal, ws, _np_tree(jws))
    again, ws2 = tquant.prequantize(q, use_aspp)
    assert ws2 == {}
    jax.tree_util.tree_map(np.testing.assert_array_equal, again, q)
    merged = tquant.merge_quant({"d1_0": {"conv": {"act_absmax": 1.0}}}, ws)
    assert merged == jquant.merge_quant(
        {"d1_0": {"conv": {"act_absmax": 1.0}}}, ws)


def test_plain_int8_conv_equals_jax_int8_conv3x3_pre():
    """The exact integer conv and the dequant of ``int8_conv3x3_pre`` on
    the JAX CPU backend: f32 outputs equal (tolerance 0); and a case whose
    sums an f32 accumulation could not hold exactly (767 channels of 127^2
    products: an odd sum above 2^24)."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((2, 9, 10, 24)) * 3).astype(np.float32)
    wq = rng.integers(-127, 128, (3, 3, 24, 16)).astype(np.int8)
    s_w = (rng.random(16) * 1e-2 + 1e-3).astype(np.float32)
    s_x = np.float32(0.05)
    want = np.asarray(jax.jit(jquant.int8_conv3x3_pre)(x, wq, s_w, s_x))
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    acc = tic.int_conv3x3(tquant.quantize_act(xt, torch.tensor(s_x)),
                          tfc.pack_conv_weight(wq))
    got = acc.float() * (torch.tensor(s_x) * torch.from_numpy(s_w))[
        None, :, None, None]
    np.testing.assert_array_equal(got.numpy().transpose(0, 2, 3, 1), want)
    big = torch.full((1, 767, 5, 5), 127.0)
    w = torch.full((4, 9 * 767), 127, dtype=torch.int8)
    acc = tic.int8_conv3x3_reference(big, w, torch.ones(4), torch.tensor(1.0),
                                     torch.ones(4), torch.zeros(4), raw=True)
    assert int(acc[0, 0, 2, 2]) == 9 * 767 * 127 * 127
    assert int(np.float32(9 * 767 * 127 * 127)) != 9 * 767 * 127 * 127


def test_int8_kernel_weights_prepack_round_trip():
    """Both paths' weight orders round-trip: the mma.sync path's for every
    shape, the wgmma path's for each count of output channels a pass that
    its plan may pick (one or two warpgroups' N of 48, 96 or 192) wherever
    it takes the channels.  The wgmma path's plan comes from the card, so
    on the CPU only the mma.sync order is prepacked by default."""
    rng = np.random.default_rng(4)
    for cin, cout in ((1, 48), (48, 96), (5, 7), (96, 48), (384, 768),
                      (768, 384), (32, 192), (24, 40), (1, 80)):
        wq = torch.from_numpy(rng.integers(-127, 128, (cout, 9 * cin))
                              .astype(np.int8))
        packs = [tic.prepack_int8_weight(wq, mma_sync=True)]
        if cout % 48 == 0 and (cin == 1 or cin % 16 == 0):
            packs += [tic.PackedInt8(tic._prepack_wgmma(wq, rows), rows)
                      for rows in (48, 96, 192, 384) if cout % rows == 0]
        for packed in packs:
            assert packed.w.numel() == tic.prepack_int8_weight_numel(
                wq, packed.rows)
            assert torch.equal(
                tic.unpack_int8_prepacked(packed, cout, cin), wq)
    with pytest.raises(ValueError, match="card"):
        tic.prepack_int8_weight(wq)


@pytest.mark.parametrize("rows", [48, 96, 192, 384])
def test_int8_wgmma_weight_stages_hold_core_matrices(rows):
    """The wgmma path's weight order, one stage per kernel step (pass of
    ``rows`` output channels, k32 step of input channels, tap): each tap's
    K-major core matrices, 8 output channels x 16 input channels; where
    Cin = 1 one stage per pass, K the nine taps padded to 32."""
    rng = np.random.default_rng(rows)
    cin, cout = 64, 2 * rows
    wq = torch.from_numpy(rng.integers(-127, 128, (cout, 9 * cin))
                          .astype(np.int8))
    stages = tic._prepack_wgmma(wq, rows).reshape(2, 2, 9, 2, rows, 16)
    w3 = wq.reshape(cout, 9, cin)
    for pas in range(2):
        for k in range(2):
            for tap in (0, 4, 8):
                for grp in range(2):
                    c = 32 * k + 16 * grp
                    assert torch.equal(stages[pas, k, tap, grp],
                                       w3[rows * pas:rows * (pas + 1), tap,
                                          c:c + 16])
    w1 = torch.from_numpy(rng.integers(-127, 128, (cout, 9)).astype(np.int8))
    st1 = tic._prepack_wgmma(w1, rows).reshape(2, 2, rows, 16)
    for pas in range(2):
        rows_w = w1[rows * pas:rows * (pas + 1)]
        assert torch.equal(st1[pas, 0, :, :9], rows_w)
        assert not st1[pas, 0, :, 9:].any() and not st1[pas, 1].any()


def test_plain_int8_modes_equal_jax_composition():
    """The plain version's two modes against the JAX package's composition
    of a pair, exact in f32: the first conv's result quantized with the
    second conv's scale is ``quantize_act`` of ``relu(int8_conv3x3_pre(x)
    * scale + bias)`` (the affine as the kernel's fma), and the second conv
    of that int8 tensor is ``int8_conv3x3_pre`` of the f32 intermediate,
    which quantizes it the same way."""
    rng = np.random.default_rng(9)
    x = (rng.standard_normal((2, 7, 9, 32)) * 3).astype(np.float32)
    w1 = rng.integers(-127, 128, (3, 3, 32, 48)).astype(np.int8)
    w2 = rng.integers(-127, 128, (3, 3, 48, 16)).astype(np.int8)
    sw1 = (rng.random(48) * 1e-2 + 1e-3).astype(np.float32)
    sw2 = (rng.random(16) * 1e-2 + 1e-3).astype(np.float32)
    sc = (rng.random(48) + 0.5).astype(np.float32)
    bi = (rng.standard_normal(48) * 0.1).astype(np.float32)
    sx1, sx2 = np.float32(0.05), np.float32(0.02)
    y1 = np.asarray(jax.jit(jquant.int8_conv3x3_pre)(x, w1, sw1, sx1))
    h = np.maximum((y1.astype(np.float64) * sc + bi).astype(np.float32), 0)
    want_q = np.asarray(jax.jit(jquant.quantize_act)(h, sx2))
    want_y2 = np.asarray(jax.jit(jquant.int8_conv3x3_pre)(h, w2, sw2, sx2))

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a))

    xt = t(x.transpose(0, 3, 1, 2))
    ones = torch.ones(16)
    q = tic.int8_conv3x3(xt, tfc.pack_conv_weight(w1), t(sw1),
                         torch.tensor(sx1), t(sc), t(bi),
                         s_out=torch.tensor(sx2))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy().transpose(0, 2, 3, 1), want_q)
    w2p = tfc.pack_conv_weight(w2)
    acc = tic.int8_conv3x3(q, w2p, t(sw2), torch.tensor(sx2), ones,
                           torch.zeros(16), raw=True)
    y2 = acc.float() * (torch.tensor(sx2) * t(sw2))[None, :, None, None]
    np.testing.assert_array_equal(y2.numpy().transpose(0, 2, 3, 1), want_y2)
    # the int8 input's epilogue in f32: the affine of that dequant
    out = tic.int8_conv3x3(q, w2p, t(sw2), torch.tensor(sx2), ones,
                           torch.zeros(16), dtype=torch.float32)
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(
        out.numpy().transpose(0, 2, 3, 1), np.maximum(want_y2, 0))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_int8_pair_int8_intermediate_gives_the_same_numbers(dtype):
    """``Int8CBRPair``'s forward (the intermediate as int8, quantized after
    the compute-dtype rounding) equals the two convs with the intermediate
    in the compute dtype, bit for bit, with some intermediate values
    clipping."""
    from att_aspp_unet_tpu_torch.nn.blocks import Int8CBRPair

    rng = np.random.default_rng(10)
    pair = Int8CBRPair(16, 32, 24, dtype=dtype)
    with torch.no_grad():
        for i, (ci, co) in ((1, (16, 32)), (2, (32, 24))):
            getattr(pair, f"w{i}").copy_(torch.from_numpy(
                rng.integers(-127, 128, (co, 9 * ci)).astype(np.int8)))
            getattr(pair, f"w_scale{i}").copy_(torch.from_numpy(
                (rng.random(co) * 1e-2).astype(np.float32)))
            getattr(pair, f"s{i}").copy_(torch.from_numpy(
                (rng.random(co) + 0.5).astype(np.float32)))
            getattr(pair, f"b{i}").copy_(torch.from_numpy(
                (rng.standard_normal(co) * 0.1).astype(np.float32)))
    x = torch.from_numpy((rng.standard_normal((2, 16, 12, 14)) * 2)
                         .astype(np.float32)).to(dtype)
    pair.s_x1.fill_(5.0 / 127)
    h = tic.int8_conv3x3(x, pair.w1, pair.w_scale1, pair.s_x1, pair.s1,
                         pair.b1)
    pair.s_x2.fill_(float(h.float().amax()) / 100)
    want = tic.int8_conv3x3(h, pair.w2, pair.w_scale2, pair.s_x2, pair.s2,
                            pair.b2)
    got = pair(x)
    assert got.dtype == dtype and torch.equal(got, want)


# ------------------------------------------------- calibration and the model

def _jax_calib(variables, x_nhwc, use_aspp, dtype="float32"):
    model = JModel.from_config(JModelConfig(
        base_c=4, use_aspp=use_aspp, compute_dtype=dtype,
        conv_lowering="int8_calib"))
    _, upd = jax.jit(lambda v, x: model.apply(v, x, train=False,
                                              mutable=["quant"]))(
        variables, x_nhwc)
    return _np_tree(upd["quant"])


def _port_calib(variables, x_nchw, use_aspp, dtype="float32"):
    model = jax_variables_to_torch(_np_tree(variables), ModelConfig(
        base_c=4, use_aspp=use_aspp, compute_dtype=dtype))
    return jax.tree_util.tree_map(lambda t: t.numpy(),
                                  model.calibrate(torch.from_numpy(x_nchw)))


@pytest.mark.parametrize("use_aspp", [True, False])
def test_calibration_tree_matches_jax_int8_calib(use_aspp):
    """The ``act_absmax`` tree of the direct model's calibration forward
    against flax's ``int8_calib`` collection on the same variables and
    input: the same 16 (17) sites, within 1e-6 relative in f32 (measured
    3.8e-7); in bf16 within 2e-2 relative (measured 7.1e-3: flax rounds
    the conv output to bf16 before the unfolded BN, the port the folded
    BN's result, a bf16 ulp is 2^-8 and the difference compounds over the
    depth)."""
    variables = jax_variables(use_aspp, seed=5)
    x = np.random.default_rng(6).random((3, IMG, IMG, 1)).astype(np.float32)
    for dtype, rtol in (("float32", 1e-6), ("bfloat16", 2e-2))[
            :2 if use_aspp else 1]:
        want = _jax_calib(variables, x, use_aspp, dtype)
        got = _port_calib(variables, x.transpose(0, 3, 1, 2).copy(),
                          use_aspp, dtype)
        assert len(jax.tree_util.tree_leaves(got)) == (16 if use_aspp
                                                       else 17)
        jax.tree_util.tree_map(lambda g, w: np.testing.assert_allclose(
            g, w, rtol=rtol, atol=0), got, want)


@pytest.mark.parametrize("use_aspp,prequantized", [(True, True),
                                                    (False, False)])
def test_int8_model_matches_flax_int8_apply(use_aspp, prequantized):
    """The port's int8 model against flax's ``int8`` apply on the same
    input and the same ``quant`` tree, f32: logits within 1e-3 of their
    range (measured: at most 1.6e-7 of it, the folded BN's last bits; no
    quantization step moved).  Prequantized: the JAX engine's form, int8
    kernels with their ``w_scale``."""
    variables = jax_variables(use_aspp, seed=7)
    x = np.random.default_rng(8).random((2, IMG, IMG, 1)).astype(np.float32)
    quant = _jax_calib(variables, x, use_aspp)
    params = variables["params"]
    if prequantized:
        params, ws = jax.jit(jquant.prequantize_params)(params)
        quant = jquant.merge_quant(quant, _np_tree(ws))
    jvars = {"params": params, "batch_stats": variables["batch_stats"],
             "quant": quant}
    model = JModel.from_config(JModelConfig(base_c=4, use_aspp=use_aspp,
                                            compute_dtype="float32",
                                            conv_lowering="int8"))
    want, _ = jax.jit(lambda v, x: model.apply(v, x, train=False))(jvars, x)
    want = np.asarray(want)[..., 0]
    port = jax_variables_to_torch(_np_tree(jvars), ModelConfig(
        base_c=4, use_aspp=use_aspp, compute_dtype="float32",
        conv_lowering="int8"))
    got = port(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))[:, 0]
    span = float(want.max() - want.min())
    assert np.abs(got.numpy() - want).max() <= 1e-3 * span
    tree = quant_tree(port)
    for site in tquant.conv_sites(use_aspp):
        node = tquant.tree_get(tree, site)
        np.testing.assert_array_equal(
            node["act_absmax"], tquant.tree_get(quant, site)["act_absmax"])
        assert node["w_scale"].shape == (
            np.asarray(tquant.tree_get(params, site)["kernel"]).shape[-1],)


def test_int8_model_needs_the_quant_collection():
    variables = _np_tree(jax_variables(seed=9))
    with pytest.raises(ValueError, match="act_absmax"):
        jax_variables_to_torch(variables, ModelConfig(
            base_c=4, conv_lowering="int8"))
    with pytest.raises(ValueError, match="ROADMAP"):
        ModelConfig(conv_lowering="w2d_stage")


# --------------------------------------------------------------- the engine

@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """The JAX int8 engines (direct, and cascade for the bulk path) with
    every result the tests compare, each path run once."""
    variables = jax_variables(seed=11)
    vnp = _np_tree(variables)
    jcfg, cfg = _cfgs()
    sweep, sweep2 = _sweep(1), _sweep(2)
    jeng = JEngine(jcfg, variables)
    assert "quant" not in jeng.variables
    jfull = np.asarray(jeng.predict_full(sweep))
    # a data-derived threshold keeps the masks of random weights non-empty
    thr = float(np.quantile(jfull, 0.85))
    out = dict(variables=variables, vnp=vnp, jcfg=jcfg, cfg=cfg, thr=thr,
               sweep=sweep, sweep2=sweep2, jfull=jfull)
    out["quant"] = _np_tree(jeng.variables["quant"])
    out["jcase"] = jeng.predict_case(sweep, SPACING, threshold=thr)
    out["jroi"] = np.asarray(jeng.predict_roi(sweep))
    out["jpsi"] = np.asarray(jeng.psi_sweep(sweep))
    # the bulk group's first sweep is the cascade of that sweep (the JAX
    # engine's bulk results equal its per-case ones)
    jc = JEngine(dataclasses.replace(jcfg, predict=dataclasses.replace(
        jcfg.predict, **CASCADE)), variables)
    out["jbulk"] = jc.predict_bulk(np.stack([sweep, sweep2]), SPACING,
                                   threshold=thr)
    path = tmp_path_factory.mktemp("jax_npz") / "w.npz"
    jnpz.save_npz_variables(jax.device_get(jeng.variables), path)
    out["jnpz"] = path
    return out


def _engine(e, cfg=None, quant=True, **kw):
    """The port's int8 engine on the CPU, with the JAX engine's scales
    (``quant``) or calibrating its own."""
    v = {**e["vnp"], "quant": e["quant"]} if quant else e["vnp"]
    return AttAsppEngine(cfg or e["cfg"], v, device="cpu", **kw)


def _iou(a, b):
    a, b = np.asarray(a) > 0, np.asarray(b) > 0
    return (a & b).sum() / max((a | b).sum(), 1)


def test_engine_calibrates_lazily_and_matches_jax_int8(engines):
    """First sweep calibrates (the model exists only afterwards) on the
    same frames the JAX engine uses; probabilities against the JAX int8
    engine at ``tests/test_quant_int8.py``'s tolerances (mean < 0.02,
    max < 0.25), the scales within 1e-6 relative of JAX's."""
    eng = _engine(engines, quant=False)
    assert eng.model is None
    p = eng.predict_full(engines["sweep"]).numpy()
    assert eng.model is not None and eng.model.cfg.conv_lowering == "int8"
    d = np.abs(p - engines["jfull"])
    assert d.mean() < 0.02 and d.max() < 0.25
    jax.tree_util.tree_map(
        lambda g, w: np.testing.assert_allclose(g, w, rtol=1e-6),
        quant_tree(eng.model),
        jax.tree_util.tree_map(np.asarray, engines["quant"]))
    f, m, _ = eng.predict_case(engines["sweep"], SPACING, engines["thr"])
    jf, jm, _ = engines["jcase"]
    assert f == int(jf) and _iou(m, jm) > 0.9


def test_engine_accepts_precalibrated_scales(engines):
    """With the JAX engine's ``quant`` collection nothing is calibrated:
    the int8 model exists at construction, its scales are JAX's bit for
    bit, and the case path gives the JAX engine's frame with its mask
    (IoU > 0.9)."""
    eng = _engine(engines)
    assert eng.model is not None and eng._calib_model is None
    for site in tquant.conv_sites():
        assert tquant.tree_get(quant_tree(eng.model), site)["act_absmax"] \
            == tquant.tree_get(engines["quant"], site)["act_absmax"]
    p = eng.predict_full(engines["sweep"]).numpy()
    np.testing.assert_allclose(p, engines["jfull"], atol=1e-3)
    f, m, ac = eng.predict_case(engines["sweep"], SPACING, engines["thr"])
    jf, jm, jac = engines["jcase"]
    assert f == int(jf) and _iou(m, jm) > 0.9 and np.asarray(m).sum() > 0


def test_engine_int8_roi_and_psi_paths(engines):
    """The ROI path calibrates on full frames at ``img_size`` and serves
    the crops (mean |diff| < 0.02 against JAX, as ``test_engine_int8_roi_
    path``); ``psi_sweep`` through the int8 model."""
    eng = _engine(engines, quant=False)
    got = eng.predict_roi(engines["sweep"]).numpy()
    assert eng.model is not None
    assert got.shape == engines["jroi"].shape
    assert np.abs(got - engines["jroi"]).mean() < 0.02
    psi = _engine(engines).psi_sweep(engines["sweep"])
    assert psi.shape == engines["jpsi"].shape
    assert np.abs(psi - engines["jpsi"]).mean() < 0.02


def test_engine_int8_cascade_and_bulk(engines):
    """The cascade (its scout direct, the tier-2 forward int8) and a bulk
    group against the JAX int8 cascade engine's bulk group (whose sweeps
    equal its per-case cascades): frames equal, masks IoU > 0.9; bulk
    equals per-case serving exactly."""
    cfg = dataclasses.replace(engines["cfg"], predict=dataclasses.replace(
        engines["cfg"].predict, **CASCADE))
    eng = _engine(engines, cfg)
    f, m, _ = eng.predict_case(engines["sweep"], SPACING, engines["thr"])
    jf, jm, _ = engines["jbulk"][0]
    assert f == int(jf) and _iou(m, jm) > 0.9
    bulk = eng.predict_bulk(np.stack([engines["sweep"], engines["sweep2"]]),
                            SPACING, engines["thr"])
    for s, ((fb, mb, acb), (jfb, jmb, _)) in enumerate(zip(bulk,
                                                           engines["jbulk"])):
        assert fb == int(jfb) and _iou(mb, jmb) > 0.9
        single = eng.predict_case([engines["sweep"], engines["sweep2"]][s],
                                  SPACING, engines["thr"])
        assert single[0] == fb and single[2] == acb
        np.testing.assert_array_equal(single[1], mb)
    lazy = _engine(engines, cfg, quant=False)
    lazy.predict_bulk(np.stack([engines["sweep"]] * 2), SPACING,
                      engines["thr"])
    assert lazy.model.cfg.conv_lowering == "int8"


def test_npz_round_trip_both_ways_without_recalibration(engines, tmp_path):
    """The JAX engine's archive (prequantized int8 kernels, w_scale,
    act_absmax) serves in the port with no calibration, equal to the port
    engine given JAX's scales; the port's archive (``quant_variables``)
    serves in the JAX engine with no calibration, on the port's scales."""
    loaded = tnpz.load_npz_variables(engines["jnpz"])
    assert loaded["params"]["d1_0"]["conv"]["kernel"].dtype == np.int8
    eng = AttAsppEngine(engines["cfg"], loaded, device="cpu")
    assert eng.model is not None and eng._calib_model is None
    p = eng.predict_full(engines["sweep"]).numpy()
    # params other than the int8 kernels are f16-narrowed in the archive
    assert np.abs(p - engines["jfull"]).max() < 0.02

    port = _engine(engines, quant=False)
    want = port.predict_full(engines["sweep"]).numpy()
    path = tmp_path / "port.npz"
    tnpz.save_npz_variables(port.quant_variables(), path)
    jloaded = jnpz.load_npz_variables(path)
    jeng = JEngine(engines["jcfg"], jloaded)
    assert "quant" in jeng.variables
    np.testing.assert_array_equal(
        np.asarray(jeng.variables["quant"]["d2_1"]["conv"]["act_absmax"]),
        tquant.tree_get(quant_tree(port.model), "d2_1/conv")["act_absmax"])
    assert np.abs(np.asarray(jeng.predict_full(engines["sweep"]))
                  - want).max() < 0.02
    back = AttAsppEngine(engines["cfg"], tnpz.load_npz_variables(path),
                         device="cpu")
    assert back.model is not None


def test_int8_on_two_devices_equals_one(engines):
    """``devices=["cpu", "cpu"]``: calibrated once on the primary device,
    every replica serving the same int8 weights and scales; probabilities
    and the case equal the one-device engine's bit for bit."""
    one = _engine(engines, quant=False)
    two = _engine(engines, quant=False, devices=["cpu", "cpu"])
    np.testing.assert_array_equal(two.predict_full(engines["sweep"]).numpy(),
                                  one.predict_full(engines["sweep"]).numpy())
    a = two.predict_case(engines["sweep"], SPACING, engines["thr"])
    b = one.predict_case(engines["sweep"], SPACING, engines["thr"])
    assert a[0] == b[0] and a[2] == b[2]
    np.testing.assert_array_equal(a[1], b[1])


# ------------------------------------------------------------------ the CLI

def test_cli_int8_flag_reaches_model_config():
    """``--int8`` of predict, infer-container and warm sets
    ``conv_lowering``, as the JAX CLI's ``_base_config`` does."""
    ap = cli.build_parser()
    for argv in (["predict", "--weights", "w", "--input_dir", "d"],
                 ["infer-container"], ["warm"]):
        on = ap.parse_args(argv + ["--int8"])
        off = ap.parse_args(argv)
        assert cli._config(on).model.conv_lowering == "int8"
        assert cli._config(off).model.conv_lowering == "direct"
    assert jcli._base_config(argparse.Namespace(int8=True)) \
        .model.conv_lowering == "int8"


def test_cli_predict_int8_matches_the_jax_cli(tmp_path):
    """``predict --int8 --device cpu`` end to end against the JAX CLI's
    ``predict --int8`` on the same flat-npz weights and ``.mha`` sweep
    (bf16 at 512, hflip TTA, both calibrating on the sweep): the same
    frame, mask IoU > 0.9, AC within 2 %.  The kernels are drawn with
    variance 3 / fan-in (at 1 / fan-in the probabilities of this depth span
    1e-3) and the threshold is a quantile of the port's probabilities, so
    that the mask is neither empty nor the whole frame.  Random weights
    draw nearly the same mask on every frame, so which frame wins is a tie
    of a few pixels: the sweep is one frame."""
    variables = jax_variables(seed=13, gain=3.0)
    jnpz.save_npz_variables(jax.device_get(variables), tmp_path / "w.npz")
    inp = tmp_path / "in"
    inp.mkdir()
    sweep = _sweep(3, n=5)[2:3]
    write_mha(inp / "case.mha", MetaImage(sweep, spacing=(0.28, 0.28, 1.0)))
    probs = AttAsppEngine(
        Config(model=ModelConfig(base_c=4, conv_lowering="int8"),
               predict=PredictConfig(tta_hflip=True)),
        tnpz.load_npz_variables(tmp_path / "w.npz"),
        device="cpu").predict_full(sweep).numpy()
    thr = float(np.quantile(probs, 0.8))
    common = ["predict", "--weights", str(tmp_path / "w.npz"),
              "--input_dir", str(inp), "--base_c", "4", "--int8",
              "--thr", str(thr)]
    assert cli.main(common + ["--out_dir", str(tmp_path / "port"),
                              "--device", "cpu"]) == 0
    assert jcli.main(common + ["--out_dir", str(tmp_path / "jax")]) == 0
    rel = "case/images/fetal-abdomen-segmentation/output.mha"
    got = read_mha(tmp_path / "port" / rel).array
    want = read_mha(tmp_path / "jax" / rel).array
    assert read_json(tmp_path / "port/case/fetal-abdomen-frame-number.json") \
        == read_json(tmp_path / "jax/case/fetal-abdomen-frame-number.json")
    assert got.any() and _iou(got, want) > 0.9
    ac = [float((tmp_path / d / "ac_results.csv").read_text().splitlines()[1]
                .split(",")[2]) for d in ("port", "jax")]
    assert abs(ac[0] - ac[1]) <= 0.02 * ac[1]


def test_cli_warm_on_the_cpu(capsys, tmp_path):
    """Two tiny shapes each print JAX's ``[warm] <shape>: thr ... ran in``
    line (the int8 path, calibrated on the first zero sweep); ``--bulk 1``
    and the TPU-only flags exit."""
    argv = ["warm", "--device", "cpu", "--base_c", "4", "--img-size", "32",
            "--shapes", "3x40x48,2x32x32", "--thr", "0.5"]
    assert cli.main(argv + ["--int8"]) == 0
    out = capsys.readouterr().out.splitlines()
    for spec in ("3x40x48", "2x32x32"):
        assert any(line.startswith(f"[warm] {spec}: thr 0.500 ran in")
                   for line in out), out
    assert any(line.startswith("[warm] host ops:") for line in out)
    for bad in (["--bulk", "1"], ["--bulk", "-2"], ["--bulk", "2"],
                ["--roi"], ["--c1_pad", "64"], ["--lowering", "w2d_stage"],
                ["--export-aot", str(tmp_path)]):
        with pytest.raises(SystemExit):
            cli.main(argv + bad)
