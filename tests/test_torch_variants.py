"""Port parity of the model variants (v2 gates, ``--no_att``, ``--no_aspp``,
``--att_depth``): the forward with its psi maps against the flax model, the
seeded ``init_variables`` layout against flax's ``init``, reference ``.pt``
import against the JAX package's importer, and the engine's psi maps."""

import dataclasses
import io
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from att_aspp_unet_tpu.config import Config as JConfig
from att_aspp_unet_tpu.config import ModelConfig as JModelConfig
from att_aspp_unet_tpu.config import PredictConfig as JPredictConfig
from att_aspp_unet_tpu.config import PreprocessConfig as JPreprocessConfig
from att_aspp_unet_tpu.infer.engine import AttAsppEngine as JEngine
from att_aspp_unet_tpu.models import AttentionASPPUNet as JModel
from att_aspp_unet_tpu.utils import torch_import as jti
from att_aspp_unet_tpu_torch.config import (Config, ModelConfig,
                                            PredictConfig, PreprocessConfig)
from att_aspp_unet_tpu_torch.infer.engine import AttAsppEngine
from att_aspp_unet_tpu_torch.utils import torch_import as tti
from att_aspp_unet_tpu_torch.utils.convert import (init_variables,
                                                   jax_variables_to_torch)

from . import torch_ref
from .test_torch_threads import one_torch_thread  # noqa: F401

# (gate, use_att, use_aspp, att_depth)
VARIANTS = [("v2", True, True, 4), ("v2", True, True, 3),
            ("v2", True, False, 4), ("v1", False, True, 4),
            ("v1", True, False, 4), ("v2", False, False, 0)]
BASE_C = 4


def variant_kwargs(gate, use_att, use_aspp, att_depth):
    return dict(gate_variant=gate, use_att=use_att, use_aspp=use_aspp,
                att_depth=att_depth)


def random_variant_variables(kw, seed=0, base_c=BASE_C, spread=False):
    """``init_variables`` of the variant with every leaf redrawn from a numpy
    generator: kernels ~ N(0, 1/fan-in), BN variances in [0.5, 1.5), scales
    near 1, biases and means ~ 0.1 N(0, 1).  Such a model's logits hardly
    vary over an image; ``spread`` rescales the output conv so that on
    seeded 64 x 64 frames they have median 0 and standard deviation 2, and
    the probabilities spread over (0, 1) as a trained model's do."""
    rng = np.random.default_rng(seed)

    def leaf(path, v):
        name = str(path[-1].key)
        if name in ("var", "scale"):
            return (rng.random(v.shape) + 0.5).astype(np.float32)
        if name in ("mean", "bias"):
            return (rng.standard_normal(v.shape) * 0.1).astype(np.float32)
        fan_in = int(np.prod(v.shape[:-1]))
        return (rng.standard_normal(v.shape) / np.sqrt(fan_in)
                ).astype(np.float32)

    v = jax.tree_util.tree_map_with_path(
        leaf, init_variables(ModelConfig(base_c=base_c, **kw)))
    if spread:
        out = v["params"]["out_conv"]
        out["bias"][:] = 0.0
        x = np.random.default_rng(seed).random((4, 1, 64, 64))
        x[:, :, 16:48, 12:52] += 1.0
        logits = jax_variables_to_torch(v, ModelConfig(
            base_c=base_c, compute_dtype="float32", **kw))(
                torch.from_numpy(x.astype(np.float32))).numpy()
        scale = 2.0 / logits.std()
        out["kernel"] *= np.float32(scale)
        out["bias"][:] = np.float32(-np.median(logits) * scale)
    return v


def gap_threshold(probs, q=0.7, clearance=1e-6):
    """A threshold near the ``q`` quantile of ``probs`` in the middle of the
    widest gap between neighbouring values there, at least ``clearance``
    from every value: random weights give flat probabilities, and a
    threshold that grazes one would let f32 rounding decide its pixel."""
    v = np.unique(np.asarray(probs, np.float64).ravel())
    i = int(q * (len(v) - 1))
    w = v[max(i - 1000, 0): i + 1000]
    k = int(np.argmax(np.diff(w)))
    thr = float((w[k] + w[k + 1]) / 2)
    assert np.abs(v - thr).min() > clearance
    return thr


def _flax(kw, dtype, variables, x_nchw):
    model = JModel.from_config(JModelConfig(base_c=BASE_C,
                                            compute_dtype=dtype, **kw))
    apply = jax.jit(lambda v, x: model.apply(v, x, train=False))
    logits, psis = apply(variables, jnp.asarray(x_nchw.transpose(0, 2, 3, 1)))
    return (np.asarray(logits).transpose(0, 3, 1, 2),
            [None if p is None else
             np.asarray(p, np.float32).transpose(0, 3, 1, 2) for p in psis])


@pytest.mark.parametrize("variant", VARIANTS, ids=lambda v: "-".join(map(str, v)))
def test_variant_forward_matches_flax(variant):
    """Logits and each psi map of ``forward(x, return_psi=True)`` against
    flax ``apply``: f32 at rtol/atol 1e-4, bf16 (the main path's precision,
    K1's plain version on the CPU) at 2e-2.  psi is ``[psi3, psi2]`` from u4
    and u3 only, None where the level is ungated."""
    kw = variant_kwargs(*variant)
    variables = random_variant_variables(kw, seed=1)
    x = np.random.default_rng(2).random((2, 1, 32, 32)).astype(np.float32)
    for dtype, tol in (("float32", 1e-4), ("bfloat16", 2e-2)):
        want, want_psi = _flax(kw, dtype, variables, x)
        model = jax_variables_to_torch(variables, ModelConfig(
            base_c=BASE_C, compute_dtype=dtype, **kw))
        got, got_psi = model(torch.from_numpy(x), return_psi=True)
        np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)
        assert len(got_psi) == 2
        for g, w in zip(got_psi, want_psi):
            assert (g is None) == (w is None)
            if w is not None:
                np.testing.assert_allclose(g.float().numpy(), w, rtol=tol,
                                           atol=tol)
        # the plain forward returns the same logits
        np.testing.assert_array_equal(model(torch.from_numpy(x)).numpy(),
                                      got.numpy())


@pytest.mark.parametrize("variant", VARIANTS + [("v1", True, True, 4)],
                         ids=lambda v: "-".join(map(str, v)))
def test_init_variables_layout_matches_flax_init(variant):
    """Keys, shapes and dtypes of ``init_variables`` equal flax ``init`` of
    the same variant (the template of non-strict ``.pt`` import)."""
    kw = variant_kwargs(*variant)
    model = JModel.from_config(JModelConfig(base_c=BASE_C, **kw))
    want = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 1)), train=False))
    got = init_variables(ModelConfig(base_c=BASE_C, **kw), seed=3)

    def layout(tree):
        return {jax.tree_util.keystr(k): (tuple(v.shape), np.dtype(v.dtype))
                for k, v in jax.tree_util.tree_leaves_with_path(tree)}

    assert layout(got) == layout(want)
    again = init_variables(ModelConfig(base_c=BASE_C, **kw), seed=3)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(again)):
        np.testing.assert_array_equal(a, b)


def _oracle(kind, seed=0):
    gen = torch.Generator().manual_seed(seed)
    torch.manual_seed(seed)
    if kind == "v1":
        model, kw = torch_ref.AttentionASPPUNetV1(base_c=8), {}
    elif kind == "v2":
        model, kw = (torch_ref.AttentionASPPUNetV2(base_c=8),
                     dict(gate_variant="v2"))
    else:
        model, kw = (torch_ref.AttentionASPPUNetV2(
            base_c=8, use_att=False, use_aspp=False, att_depth=0),
            dict(gate_variant="v2", use_att=False, use_aspp=False,
                 att_depth=0))
    torch_ref.randomize_bn_stats(model, gen)
    return model.eval(), kw


def _jax_template(kw):
    """The JAX importer's template: the port's seeded tree, whose layout is
    flax init's (``test_init_variables_layout_matches_flax_init``)."""
    return init_variables(ModelConfig(base_c=8, **kw), seed=1)


@pytest.mark.parametrize("kind", ["v1", "v2", "v2-noatt-noaspp"])
def test_pt_import_matches_jax_importer_and_oracle(kind, tmp_path):
    """A reference state dict (the ``tests/torch_ref.py`` oracles) saved as
    ``.pt``: both packages' importers give an identical variables tree (so
    the forward parity above carries over), and the port's f32 logits agree
    with the oracle's."""
    oracle, kw = _oracle(kind)
    path = tmp_path / "ckpt.pt"
    torch.save(oracle.state_dict(), path)
    cfg = ModelConfig(base_c=8, compute_dtype="float32", **kw)
    with redirect_stdout(io.StringIO()) as out:
        got = tti.load_torch_checkpoint(path, cfg, init_variables(cfg, 0))
    assert "loaded with 0 missing & 0 unexpected keys" in out.getvalue()
    want = jti.load_torch_checkpoint(path, JModelConfig(base_c=8, **kw),
                                     _jax_template(kw), verbose=False)
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = jax.tree_util.tree_leaves_with_path(want)
    assert [k for k, _ in flat_got] == [k for k, _ in flat_want]
    for (k, a), (_, b) in zip(flat_got, flat_want):
        assert np.array_equal(a, np.asarray(b)), jax.tree_util.keystr(k)

    x = torch.rand((2, 1, 32, 32), generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        ref = oracle(x)
    ref = ref[0] if isinstance(ref, tuple) else ref
    model = jax_variables_to_torch(got, cfg)
    logits = model(x)
    np.testing.assert_allclose(logits.numpy(), ref.numpy(), rtol=1e-4,
                               atol=1e-4)


def _counts(text):
    line = [s for s in text.splitlines() if "loaded with" in s][-1]
    return line.split("loaded with ")[1]


@pytest.mark.parametrize("kind", ["v1", "v2"])
def test_pt_wrapper_renames_and_key_counts_match_jax(kind):
    """``{"state_dict": ...}`` and the legacy ``W_g`` / ``W_x`` names load
    like the plain dict; with one key dropped and one added both importers
    report the same missing / unexpected counts and fill the same leaves."""
    oracle, kw = _oracle(kind, seed=1)
    cfg = ModelConfig(base_c=8, **kw)
    sd = {k: v.numpy() for k, v in oracle.state_dict().items()}
    plain = tti.convert_reference_state_dict(sd, cfg, init_variables(cfg),
                                             verbose=False)
    legacy = {"state_dict": {k.replace(".Wg.", ".W_g.").replace(
        ".Wx.", ".W_x."): v for k, v in sd.items()}}
    assert any(".W_g." in k for k in legacy["state_dict"])
    wrapped = tti.convert_reference_state_dict(legacy, cfg,
                                               init_variables(cfg),
                                               verbose=False)
    for a, b in zip(jax.tree_util.tree_leaves(plain),
                    jax.tree_util.tree_leaves(wrapped)):
        np.testing.assert_array_equal(a, b)

    broken = dict(sd)
    dropped = "u4.conv.0.block.0.weight"
    del broken[dropped]
    broken["extra.weight"] = np.zeros(3, np.float32)
    with redirect_stdout(io.StringIO()) as out:
        got = tti.convert_reference_state_dict(broken, cfg, init_variables(cfg))
        want = jti.convert_reference_state_dict(
            broken, JModelConfig(base_c=8, **kw), _jax_template(kw))
    port_line, jax_line = [s for s in out.getvalue().splitlines()
                           if "loaded with" in s]
    assert _counts(port_line) == _counts(jax_line) == \
        "1 missing & 1 unexpected keys"
    keys = {jax.tree_util.keystr(k) for k, _ in
            jax.tree_util.tree_leaves_with_path(got)}
    assert keys == {jax.tree_util.keystr(k) for k, _ in
                    jax.tree_util.tree_leaves_with_path(want)}
    # the dropped kernel keeps the template's value, the rest is filled
    np.testing.assert_array_equal(
        got["params"]["u4"]["conv1"]["conv"]["kernel"],
        plain["params"]["u4"]["conv1"]["conv"]["kernel"])


def test_extra_subtrees_are_ignored_as_flax_ignores_them():
    """The v1 + ASPP tree (the main weights) served as the ``--no_att``
    model, as ``--weights_noatt`` may be given: the gates' subtrees go
    unused in both packages and the logits agree."""
    v1 = random_variant_variables({}, seed=4)
    kw = dict(use_att=False, att_depth=0)
    x = np.random.default_rng(6).random((1, 1, 32, 32)).astype(np.float32)
    want, _ = _flax(kw, "float32", v1, x)
    got = jax_variables_to_torch(v1, ModelConfig(
        base_c=BASE_C, compute_dtype="float32", **kw))(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_engine_psi_sweep_matches_jax(rng):
    """``psi_sweep`` of a v2 model gated at u3 only (``att_depth`` 3): the
    mean of the returned psi maps that are not None at the input size,
    resized to the frame, against the JAX engine's; a gate-free model gives
    zeros.  (Which maps a variant returns is held by the forward test above;
    ``refine`` and ``select_best`` over every frame by the ``.mha``
    diagnostics test in ``test_torch_calibrate.py``.)"""
    kw = variant_kwargs("v2", True, True, 3)
    variables = random_variant_variables(kw, seed=7, spread=True)
    jcfg = JConfig(preprocess=JPreprocessConfig(img_size=64),
                   model=JModelConfig(base_c=BASE_C, compute_dtype="float32",
                                      **kw),
                   predict=JPredictConfig(frame_batch=2))
    cfg = Config(preprocess=PreprocessConfig(img_size=64),
                 model=ModelConfig(base_c=BASE_C, compute_dtype="float32",
                                   **kw),
                 predict=PredictConfig(frame_batch=2))
    sweep = (rng.random((3, 40, 48)) * 200).astype(np.uint8)
    sweep[1, 10:30, 8:40] = 245
    want = JEngine(jcfg, variables).psi_sweep(sweep)
    got = AttAsppEngine(cfg, variables, device="cpu").psi_sweep(sweep)
    assert got.shape == sweep.shape and got.dtype == np.float32
    assert got.std() > 1e-3
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    na = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, use_att=False, att_depth=0))
    assert not AttAsppEngine(na, variables, device="cpu").psi_sweep(
        sweep).any()


def test_cascade_with_a_variant_main_model_keeps_a_v1_scout(tmp_path, rng):
    """A v2 main model with a distilled scout: the scout is built as the v1
    + ASPP model its checkpoint holds, tier 2 as the v2 model."""
    from att_aspp_unet_tpu_torch.models.att_aspp_unet import gated
    from att_aspp_unet_tpu_torch.nn.blocks import AttentionGateV2

    scout = random_variant_variables({}, seed=8, base_c=4)
    path = tmp_path / "scout.npz"
    np.savez(path, **{f"{c}/{'/'.join(jax.tree_util.keystr(k, simple=True, separator='/').split('/'))}": v
                      for c in ("params", "batch_stats")
                      for k, v in jax.tree_util.tree_leaves_with_path(
                          scout[c])})
    kw = dict(gate_variant="v2")
    cfg = Config(preprocess=PreprocessConfig(img_size=64),
                 model=ModelConfig(base_c=BASE_C, compute_dtype="float32",
                                   **kw),
                 predict=PredictConfig(frame_batch=2, cascade=True,
                                       cascade_scouts=2,
                                       cascade_img_size=32,
                                       cascade_scout_weights=str(path),
                                       cascade_scout_base_c=4))
    eng = AttAsppEngine(cfg, random_variant_variables(kw, seed=9),
                        device="cpu")
    assert eng.scout_model.cfg.gate_variant == "v1"
    assert eng.scout_model.cfg.use_aspp and gated(eng.scout_model.cfg, 2)
    assert isinstance(eng.model.u4.att, AttentionGateV2)
    sweep = (rng.random((4, 40, 48)) * 200).astype(np.uint8)
    frame, mask, ac = eng.predict_case(sweep, (0.28, 0.28), 0.5)
    assert 0 <= frame < 4 and mask.shape == (40, 48)
    cfg_direct = dataclasses.replace(cfg, predict=dataclasses.replace(
        cfg.predict, cascade=False, cascade_scout_weights=None))
    assert AttAsppEngine(cfg_direct, random_variant_variables(kw, seed=9),
                         device="cpu").scout_model is None


def test_cli_predict_and_container_take_model_flags_and_pt(tmp_path, rng,
                                                         monkeypatch):
    """``cli predict`` and ``cli infer-container`` (``att_aspp``) on the CPU
    with ``--gate v2 --no_aspp`` and a reference ``.pt`` state dict: the
    import reports 0 missing & 0 unexpected keys, and the outputs equal
    those of the same weights given as the JAX-layout tree."""
    from att_aspp_unet_tpu_torch import cli
    from att_aspp_unet_tpu_torch.infer.container import run
    from att_aspp_unet_tpu_torch.infer.predict_cli import predict_directory
    from att_aspp_unet_tpu_torch.io import (MetaImage, read_json, read_mha,
                                            write_mha)
    from att_aspp_unet_tpu_torch.config import ContainerConfig

    oracle = torch_ref.AttentionASPPUNetV2(base_c=BASE_C, use_aspp=False)
    torch_ref.randomize_bn_stats(oracle, torch.Generator().manual_seed(2))
    torch.save({"state_dict": oracle.state_dict()}, tmp_path / "w.pt")
    kw = dict(gate_variant="v2", use_aspp=False)
    mcfg = ModelConfig(base_c=BASE_C, **kw)
    variables = tti.convert_reference_state_dict(
        {k: v.numpy() for k, v in oracle.state_dict().items()}, mcfg,
        init_variables(mcfg), verbose=False)
    sweep = (rng.random((4, 40, 48)) * 200).astype(np.uint8)
    sweep[2, 8:30, 10:40] = 240
    (tmp_path / "in").mkdir()
    write_mha(tmp_path / "in/case.mha", MetaImage(sweep,
                                                  spacing=(0.3, 0.3, 1.0)))
    flags = ["--base_c", str(BASE_C), "--gate", "v2", "--no_aspp",
             "--deterministic", "--device", "cpu"]
    with redirect_stdout(io.StringIO()) as out:
        assert cli.main(["predict", "--weights", str(tmp_path / "w.pt"),
                         "--input_dir", str(tmp_path / "in"), "--out_dir",
                         str(tmp_path / "cli"), "--thr", "0.5"] + flags) == 0
    assert "[torch_import] loaded with 0 missing & 0 unexpected keys" in \
        out.getvalue()
    want = predict_directory(Config(model=mcfg, predict=PredictConfig(
        tta_hflip=True)), variables, tmp_path / "in", tmp_path / "lib",
        threshold=0.5, device="cpu", log=lambda *a: None)
    assert (tmp_path / "cli/ac_results.csv").read_text().splitlines()[1:] \
        == [f"{c},{f},{a}" for c, f, a in want]

    src = tmp_path / "box/images/stacked-fetal-ultrasound"
    src.mkdir(parents=True)
    write_mha(src / "case.mha", MetaImage(sweep, spacing=(0.3, 0.3, 1.0)))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("MODEL_TAG", "att_aspp")
    with redirect_stdout(io.StringIO()):
        assert cli.main(["infer-container", "--input", str(tmp_path / "box"),
                         "--output", str(tmp_path / "cout"), "--weights",
                         str(tmp_path / "w.pt"), "--no-save-probabilities",
                         "--no-debug-frames"] + flags) == 0
        cfg = Config(model=mcfg, container=ContainerConfig(
            input_path=str(tmp_path / "box"),
            output_path=str(tmp_path / "lout"), model_tag="att_aspp"))
        run(cfg, variables, save_probabilities=False, debug_frames=False,
            device="cpu")
    assert read_json(tmp_path / "cout/fetal-abdomen-frame-number.json") == \
        read_json(tmp_path / "lout/fetal-abdomen-frame-number.json")
    rel = "images/fetal-abdomen-segmentation/output.mha"
    np.testing.assert_array_equal(read_mha(tmp_path / "cout" / rel).array,
                                  read_mha(tmp_path / "lout" / rel).array)
