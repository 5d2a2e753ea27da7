"""The port's reference-API facade (``att_aspp_unet_tpu_torch/compat.py``)
and its environment-driven container entry point
(``python -m att_aspp_unet_tpu_torch.inference``) against the JAX package's
``compat.py`` and the root ``inference.py``, on the CPU at the small
configuration of ``tests/test_compat.py`` (base_c 4, f32, network input 32,
ROI 32, 4 subsampled frames; a three-stage PlainConvUNet with 32 x 32
tiles).  Probabilities agree to atol 1e-4 (f32 on both sides); masks, frames
and written files are equal."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from att_aspp_unet_tpu import compat as jcompat
from att_aspp_unet_tpu.config import Config as JConfig
from att_aspp_unet_tpu.config import ModelConfig as JModelConfig
from att_aspp_unet_tpu.config import PlainUNetConfig as JPlainUNetConfig
from att_aspp_unet_tpu.config import PredictConfig as JPredictConfig
from att_aspp_unet_tpu.config import PreprocessConfig as JPreprocessConfig
from att_aspp_unet_tpu.models import PlainConvUNet as JPlainConvUNet
from att_aspp_unet_tpu.utils.npz_weights import save_npz_variables
from att_aspp_unet_tpu_torch import compat, inference
from att_aspp_unet_tpu_torch.config import (Config, ModelConfig,
                                            PlainUNetConfig, PredictConfig,
                                            PreprocessConfig)
from att_aspp_unet_tpu_torch.io import MetaImage, read_json, read_mha, \
    write_mha
from att_aspp_unet_tpu_torch.utils.npz_weights import load_npz_variables

from . import torch_ref
from .test_torch_model import random_variables
from .test_torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
SMALL_PLAIN = dict(base_c=4, max_c=16, n_stages=3, patch_size=(32, 32),
                   compute_dtype="float32")
SMALL_PREDICT = dict(frame_batch=2, roi_size=32, subsample_frames=4)


def _cfgs():
    jcfg = JConfig(preprocess=JPreprocessConfig(img_size=32),
                   model=JModelConfig(base_c=4, compute_dtype="float32",
                                      param_dtype="float32"),
                   plain_unet=JPlainUNetConfig(**SMALL_PLAIN),
                   predict=JPredictConfig(**SMALL_PREDICT))
    cfg = Config(preprocess=PreprocessConfig(img_size=32),
                 model=ModelConfig(base_c=4, compute_dtype="float32"),
                 plain_unet=PlainUNetConfig(**SMALL_PLAIN),
                 predict=PredictConfig(**SMALL_PREDICT))
    return jcfg, cfg


def _plain_variables(seed=5):
    """PlainConvUNet params with every leaf from a numpy generator; the
    head's kernel scaled by 4 so that class probabilities cross 0.5."""
    model = JPlainConvUNet.from_config(JPlainUNetConfig(**SMALL_PLAIN))
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 1)), train=False))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = str(path[-1].key)
        if name == "scale":
            return (rng.random(s.shape) + 0.5).astype(np.float32)
        if name == "bias":
            return (rng.standard_normal(s.shape) * 0.1).astype(np.float32)
        fan_in = int(np.prod(s.shape[:-1]))
        gain = 4.0 if str(path[-2].key) == "seg_head" else 1.0
        return (gain * rng.standard_normal(s.shape)
                / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _sweep(seed, n, h=40, w=48):
    """Speckle with a bright ellipse whose size peaks mid-sweep."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    out = (rng.random((n, h, w)) * 120).astype(np.uint8)
    for i in range(n):
        s = 0.3 + 0.7 * (1.0 - abs(i - 0.5 * n) / n)
        e = ((yy - 0.5 * h) / (0.3 * h * s)) ** 2 \
            + ((xx - 0.5 * w) / (0.3 * w * s)) ** 2 <= 1
        out[i][e] = np.minimum(out[i][e] + 120, 255)
    return out


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Configurations, weights and one case per tag, with the JAX facade of
    each tag built once."""
    d = tmp_path_factory.mktemp("compat")
    jcfg, cfg = _cfgs()
    att = random_variables(4, seed=3)
    plain = _plain_variables()
    write_mha(d / "case_7.mha", MetaImage(_sweep(1, 6), spacing=(0.28,) * 3))
    write_mha(d / "case_8.mha", MetaImage(_sweep(2, 3), spacing=(0.28,) * 3))
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    # the flat .npz archives (f16 leaves) serve both packages' facades, so
    # that each JAX facade compiles once
    npz = {}
    for tag, v in (("att_aspp", att), ("baseline", plain)):
        npz[tag] = d / f"{tag}.npz"
        save_npz_variables(np_tree(v), npz[tag])
    jfac = {tag: jcompat.FetalAbdomenSegmentation(str(npz[tag]), cfg=jcfg,
                                                  model_tag=tag)
            for tag in npz}
    jprobs = {tag: np.asarray(jfac[tag].predict(str(d / CASES[tag])))
              for tag in npz}
    return dict(dir=d, jcfg=jcfg, cfg=cfg, npz=npz, jfac=jfac, jprobs=jprobs,
                vars={tag: load_npz_variables(npz[tag]) for tag in npz})


CASES = {"att_aspp": "case_7.mha", "baseline": "case_8.mha"}


@pytest.mark.parametrize("tag", ["att_aspp", "baseline"])
def test_facade_matches_jax(setup, tag):
    path = str(setup["dir"] / CASES[tag])
    fac = compat.FetalAbdomenSegmentation(
        cfg=setup["cfg"], variables=setup["vars"][tag], model_tag=tag,
        device="cpu")
    jfac = setup["jfac"][tag]
    probs = fac.predict([path])
    want = setup["jprobs"][tag]
    assert isinstance(probs, np.ndarray) and probs.dtype == np.float32
    assert probs.shape == want.shape == ((4, 40, 48) if tag == "att_aspp"
                                         else (3, 3, 40, 48))
    np.testing.assert_allclose(probs, want, rtol=0, atol=1e-4)
    assert fac.case_id == jfac.case_id == Path(path).stem
    masks = fac.postprocess(want)
    jmasks = np.asarray(jfac.postprocess(want))
    assert isinstance(masks, np.ndarray)
    np.testing.assert_array_equal(masks, jmasks)
    assert masks.any()
    sel, frame = compat.select_fetal_abdomen_mask_and_frame(masks)
    jsel, jframe = jcompat.select_fetal_abdomen_mask_and_frame(jmasks)
    assert frame == jframe and frame >= 0
    np.testing.assert_array_equal(sel, jsel)
    # the index is on the stack passed in: the subsampled axis for ROI
    assert frame < masks.shape[0]


@pytest.mark.parametrize("tag", ["att_aspp", "baseline"])
def test_save_probabilities_relative_to_the_working_directory(
        setup, tag, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    fac = compat.FetalAbdomenSegmentation(
        cfg=setup["cfg"], variables=setup["vars"][tag], model_tag=tag,
        device="cpu")
    probs = fac.predict(str(setup["dir"] / CASES[tag]),
                        save_probabilities=True)
    saved = tmp_path / "output/probabilities" / (
        Path(CASES[tag]).stem + "_prob.npy")
    np.testing.assert_array_equal(np.load(saved), probs)


@pytest.mark.parametrize("tag", ["att_aspp", "baseline"])
def test_facade_from_npz_checkpoint(setup, tag):
    """The port's facade reads the same flat ``.npz`` (f16 leaves) as the JAX
    facade it is held against."""
    path = str(setup["dir"] / CASES[tag])
    fac = compat.FetalAbdomenSegmentation(str(setup["npz"][tag]),
                                          model_tag=tag, cfg=setup["cfg"],
                                          device="cpu")
    np.testing.assert_allclose(fac.predict(path), setup["jprobs"][tag],
                               rtol=0, atol=1e-4)


def test_facade_from_pt_checkpoint(setup, tmp_path):
    """A reference ``.pt`` state dict through the facade equals the facade
    serving what the JAX package's importer makes of the same file (into
    the port's seeded template, whose layout is flax init's)."""
    from att_aspp_unet_tpu.utils.torch_import import load_torch_checkpoint
    from att_aspp_unet_tpu_torch.utils.convert import init_variables

    gen = torch.Generator().manual_seed(0)
    torch.manual_seed(0)
    oracle = torch_ref.AttentionASPPUNetV1(base_c=4)
    torch_ref.randomize_bn_stats(oracle, gen)
    ckpt = tmp_path / "best_model.pth"
    torch.save(oracle.eval().state_dict(), ckpt)
    jvars = load_torch_checkpoint(ckpt, setup["jcfg"].model,
                                  init_variables(setup["cfg"].model, seed=1),
                                  verbose=False)
    path = str(setup["dir"] / CASES["att_aspp"])
    fac = compat.FetalAbdomenSegmentation(str(ckpt), cfg=setup["cfg"],
                                          device="cpu")
    ref = compat.FetalAbdomenSegmentation(
        cfg=setup["cfg"], variables=jax.tree_util.tree_map(np.asarray, jvars),
        device="cpu")
    probs = fac.predict(path)
    np.testing.assert_allclose(probs, ref.predict(path), rtol=0, atol=1e-6)
    assert probs.max() > 0


@pytest.mark.parametrize("entry", ["facade", "inference"])
def test_missing_checkpoint_and_unknown_tag_raise(setup, entry, tmp_path,
                                                  monkeypatch):
    """The facade: a missing checkpoint raises ``FileNotFoundError`` as the
    JAX facade's does, and an unknown ``model_tag`` a ``ValueError`` naming
    it, with a checkpoint too.  The entry point: an unknown ``MODEL_TAG``
    raises the same ``ValueError``, with ``WEIGHTS`` or without."""
    if entry == "facade":
        for mod in (compat, jcompat):
            with pytest.raises(FileNotFoundError):
                mod.FetalAbdomenSegmentation(
                    checkpoint_path="/nonexistent/x.pth")
            with pytest.raises(FileNotFoundError):
                mod.FetalAbdomenSegmentation(checkpoint_path=None)
        with pytest.raises(ValueError, match="nnunet"):
            compat.FetalAbdomenSegmentation(
                variables=setup["vars"]["att_aspp"], model_tag="nnunet",
                device="cpu")
        with pytest.raises(ValueError, match="nnunet"):
            compat.FetalAbdomenSegmentation(str(setup["npz"]["att_aspp"]),
                                            model_tag="nnunet", device="cpu")
        return
    _case_tree(tmp_path, _sweep(3, 5))
    monkeypatch.chdir(tmp_path)
    for k, v in dict(MODEL_TAG="nnunet", DEVICE="cpu").items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("PLANS", raising=False)
    monkeypatch.delenv("WEIGHTS", raising=False)
    with pytest.raises(ValueError, match="nnunet"):
        inference.main()
    monkeypatch.setenv("WEIGHTS", str(setup["npz"]["att_aspp"]))
    with pytest.raises(ValueError, match="nnunet"):
        inference.main()
    assert not (tmp_path / "test/output").exists()


class _Row:
    def __init__(self, path):
        self.path = path


class _Frame:
    """DataFrame-like: a ``path`` column."""

    def __init__(self, paths):
        self.path = paths


@pytest.mark.parametrize("kind", ["unique", "same content", "same index",
                                  "no index", "rows", "frame"])
def test_validators_match_jax(tmp_path, kind):
    files = {"case_001.mha": b"AAA", "case_002.mha": b"BBB",
             "other_001.mha": b"CCC", "dup_003.mha": b"AAA",
             "noindex.mha": b"DDD", "alsonone.mha": b"EEE"}
    for name, data in files.items():
        (tmp_path / name).write_bytes(data)
    pick = {"unique": ["case_001.mha", "case_002.mha"],
            "same content": ["case_001.mha", "dup_003.mha"],
            "same index": ["case_001.mha", "other_001.mha"],
            "no index": ["noindex.mha", "alsonone.mha", "case_002.mha"],
            "rows": ["case_001.mha", "other_001.mha"],
            "frame": ["case_001.mha", "dup_003.mha"]}[kind]
    paths = [tmp_path / p for p in pick]
    cases = {"rows": [_Row(p) for p in paths],
             "frame": _Frame(paths)}.get(kind, [str(p) for p in paths])

    def outcome(mod, validator):
        try:
            getattr(mod, validator)()(cases)
            return "ok"
        except Exception as err:        # the exception's class name
            return type(err).__name__

    for validator in ("UniqueImagesValidator", "UniquePathIndicesValidator"):
        assert outcome(compat, validator) == outcome(jcompat, validator)
    fac_ok = {"unique": True, "no index": True}.get(kind, False)
    fac = compat.FetalAbdomenSegmentation.__new__(
        compat.FetalAbdomenSegmentation)
    fac.validators = dict(input_image=(compat.UniqueImagesValidator(),
                                       compat.UniquePathIndicesValidator()))
    if fac_ok:
        fac.validate(cases)
    else:
        with pytest.raises(compat.ValidationError):
            fac.validate(cases)


def _stacks():
    rng = np.random.default_rng(9)
    binary = (rng.random((5, 12, 14)) < 0.3).astype(np.uint8)
    labelled = np.zeros((4, 10, 12), np.uint8)
    labelled[1, :3] = 2                      # class 2 larger on frame 1
    labelled[1, 5, :2] = 1
    labelled[2, :4] = 1
    labelled[3, :6] = 2
    return {"2-D": (rng.random((9, 11)) < 0.5).astype(np.uint8),
            "binary": binary, "binary 0/255": binary * 255,
            "labelled": labelled, "empty": np.zeros((3, 6, 6), np.uint8),
            "one frame": binary[:1]}


@pytest.mark.parametrize("name", list(_stacks()))
def test_select_fetal_abdomen_mask_and_frame_matches_jax(name):
    stack = _stacks()[name]
    sel, frame = compat.select_fetal_abdomen_mask_and_frame(stack)
    jsel, jframe = jcompat.select_fetal_abdomen_mask_and_frame(stack)
    assert frame == int(jframe)
    np.testing.assert_array_equal(sel, np.asarray(jsel))
    assert sel.dtype == np.uint8


# ------------------------------------------------------- the entry point

def _case_tree(root: Path, sweep: np.ndarray) -> None:
    d = root / "test/input/images/stacked-fetal-ultrasound"
    d.mkdir(parents=True)
    write_mha(d / "case-0001_1_0000.mha",
              MetaImage(sweep, spacing=(0.28, 0.28, 0.28)))


def _small_plans(path: Path) -> Path:
    path.write_text(json.dumps({"configurations": {"2d": {
        "UNet_class_name": "PlainConvUNet", "UNet_base_num_features": 4,
        "unet_max_num_features": 16, "n_conv_per_stage_encoder": [2, 2, 2],
        "conv_kernel_sizes": [[3, 3]] * 3,
        "pool_op_kernel_sizes": [[1, 1], [2, 2], [2, 2]],
        "patch_size": [32, 32]}}}))
    return path


def test_entry_point_matches_the_root_inference(setup, tmp_path):
    """``python -m att_aspp_unet_tpu_torch.inference`` (``DEVICE=cpu``) and
    the root ``inference.py``, each run from a directory holding the same
    ``./test/input`` with ``MODEL_TAG`` unset, ``PLANS`` = a three-stage plan,
    ``WEIGHTS`` = the same ``.npz`` and ``CASE_ID``: the same files, the same
    frame JSON, equal volumes under the container contract."""
    sweep = _sweep(6, 4)
    weights = tmp_path / "w.npz"
    save_npz_variables(setup["vars"]["baseline"], weights)
    plans = _small_plans(tmp_path / "plans.json")
    env = {k: v for k, v in os.environ.items() if k != "MODEL_TAG"}
    env.update(WEIGHTS=str(weights), PLANS=str(plans), CASE_ID="case42",
               DEVICE="cpu", JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               PYTHONPATH=str(REPO))
    runs = {"port": [sys.executable, "-m", "att_aspp_unet_tpu_torch.inference"],
            "jax": [sys.executable, str(REPO / "inference.py")]}
    procs, outs = {}, {}
    for name, cmd in runs.items():          # both at once
        cwd = tmp_path / name
        _case_tree(cwd, sweep)
        procs[name] = subprocess.Popen(cmd, cwd=cwd, env=env, text=True,
                                       stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE)
        outs[name] = cwd / "test/output"
    for name, proc in procs.items():
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, (name, err[-3000:])
    files = {n: sorted(str(p.relative_to(o)) for p in o.rglob("*")
                       if p.is_file()) for n, o in outs.items()}
    assert files["port"] == files["jax"]
    assert "images/fetal-abdomen-segmentation/case42.mha" in files["port"]
    frame = read_json(outs["port"] / "fetal-abdomen-frame-number.json")
    assert frame == read_json(outs["jax"] / "fetal-abdomen-frame-number.json")
    rel = "images/fetal-abdomen-segmentation/case42.mha"
    got, want = read_mha(outs["port"] / rel), read_mha(outs["jax"] / rel)
    # both run the default configuration's bf16 forward, whose sums differ
    # in order between the packages: a few border pixels may flip
    a, b = got.array > 0, want.array > 0
    assert 2 * (a & b).sum() / (a.sum() + b.sum()) >= 0.98
    assert got.array.dtype == np.uint8 and got.array.shape == sweep.shape
    assert set(np.unique(got.array)) <= {0, 1}
    assert got.spacing == pytest.approx((0.28,) * 3)
    fg = np.flatnonzero(got.array.reshape(len(sweep), -1).any(axis=1))
    assert fg.tolist() == ([frame] if frame >= 0 else [])
    for png in sorted(p for p in files["port"] if p.endswith(".png")):
        assert (outs["port"] / png).read_bytes() == \
            (outs["jax"] / png).read_bytes()


def test_entry_point_reads_the_environment(setup, tmp_path, monkeypatch):
    """In process: ``MODEL_TAG=att_aspp`` with ``WEIGHTS`` serves the ROI
    path and names the output ``CASE_ID``; without ``WEIGHTS`` it exits with
    a message (the JAX entry point random-inits instead)."""
    _case_tree(tmp_path, _sweep(3, 5))
    monkeypatch.chdir(tmp_path)
    weights = tmp_path / "w.npz"
    save_npz_variables(setup["vars"]["att_aspp"], weights)
    monkeypatch.setenv("MODEL_TAG", "att_aspp")
    monkeypatch.setenv("CASE_ID", "roi_case")
    monkeypatch.setenv("DEVICE", "cpu")
    monkeypatch.delenv("PLANS", raising=False)
    monkeypatch.delenv("WEIGHTS", raising=False)
    with pytest.raises(SystemExit, match="WEIGHTS"):
        inference.main()
    monkeypatch.setenv("WEIGHTS", str(weights))
    # the small configuration in place of the full-width default
    monkeypatch.setattr("att_aspp_unet_tpu_torch.config.Config",
                        lambda: setup["cfg"])
    assert inference.main() == 0
    out = tmp_path / "test/output"
    vol = read_mha(out / "images/fetal-abdomen-segmentation/roi_case.mha")
    frame = read_json(out / "fetal-abdomen-frame-number.json")
    assert vol.array.shape == (5, 40, 48) and vol.array.dtype == np.uint8
    assert frame in np.linspace(0, 4, 4).astype(int).tolist() + [-1]
    assert (tmp_path / "output/probabilities/case-0001_1_0000_prob.npy").exists()
