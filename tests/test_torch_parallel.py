"""The port's data axis and frame-sharded serving against the JAX package on
the CPU: ``make_mesh_for_batch`` against the JAX function, and the port's
``AttAsppEngine`` / ``BaselineEngine`` with ``devices`` (2, 3 and 4 CPU
shards) against the JAX engines on the 8-device virtual CPU mesh and
against the port's one-device engines, on the same weights.  f32 at a tiny
size (base_c 4, network input 32); probabilities within rtol/atol 1e-5 (the
tolerance of ``tests/test_sharded_inference.py``), frames, masks and ACs
equal; the cascade and the bulk path bit for bit equal to one device."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from att_aspp_unet_tpu.config import Config as JConfig
from att_aspp_unet_tpu.config import MeshConfig as JMeshConfig
from att_aspp_unet_tpu.config import ModelConfig as JModelConfig
from att_aspp_unet_tpu.config import PlainUNetConfig as JPlainUNetConfig
from att_aspp_unet_tpu.config import PredictConfig as JPredictConfig
from att_aspp_unet_tpu.config import PreprocessConfig as JPreprocessConfig
from att_aspp_unet_tpu.infer import engine as jengine
from att_aspp_unet_tpu.models import PlainConvUNet as JPlainConvUNet
from att_aspp_unet_tpu.parallel import mesh as jmesh
from att_aspp_unet_tpu_torch.config import (Config, MeshConfig, ModelConfig,
                                            PlainUNetConfig, PredictConfig,
                                            PreprocessConfig)
from att_aspp_unet_tpu_torch.infer import engine as tengine
from att_aspp_unet_tpu_torch.parallel import mesh as tmesh
from att_aspp_unet_tpu_torch.utils.convert import init_variables
from att_aspp_unet_tpu_torch.utils.npz_weights import save_npz_variables

from .test_torch_model import random_variables
from .test_torch_threads import one_torch_thread  # noqa: F401

SPACING = (0.28, 0.28)
SHARDS = [2, 4]
TOL = dict(rtol=1e-5, atol=1e-5)
PREDICT = dict(frame_batch=2, roi_size=32, subsample_frames=6)
PLAIN = dict(base_c=4, max_c=16, n_stages=3, patch_size=(32, 32),
             compute_dtype="float32")
# the cascade of the sharded cascade and bulk tests: scout micro-batches of
# 2 frames, tier-2 micro-batches of 2 (shards are cut at both)
CASCADE = dict(cascade=True, cascade_img_size=16, cascade_scout_batch=2,
               bulk_frame_batch=2)


def _sweep(seed, n, h, w):
    return (np.random.default_rng(seed).random((n, h, w)) * 255
            ).astype(np.uint8)


def _ellipses(seed, n, h, w):
    """Speckle with a bright ellipse whose size peaks at 0.55 n (as
    ``test_torch_serving._sweep``), so that masks are not empty and frames
    differ in area."""
    out = (np.random.default_rng(seed).random((n, h, w)) * 120
           ).astype(np.uint8)
    yy, xx = np.mgrid[:h, :w]
    for i in range(n):
        s = 0.25 + 0.75 * (1.0 - abs(i - 0.55 * n) / (0.6 * n))
        e = ((yy - 0.5 * h) / (0.33 * h * s)) ** 2 \
            + ((xx - 0.45 * w) / (0.3 * w * s)) ** 2 <= 1
        out[i][e] = np.minimum(out[i][e] + 130, 255)
    return out


@pytest.fixture(scope="module")
def att(tmp_path_factory):
    """Weights, both packages' configs, the sweeps and every JAX result (one
    one-device and one 8-device mesh engine, each path run once)."""
    variables = random_variables(4, seed=7)
    vnp = jax.tree_util.tree_map(np.asarray, variables)
    jcfg = JConfig(preprocess=JPreprocessConfig(img_size=32),
                   model=JModelConfig(base_c=4, compute_dtype="float32"),
                   predict=JPredictConfig(**PREDICT))
    cfg = Config(preprocess=PreprocessConfig(img_size=32),
                 model=ModelConfig(base_c=4, compute_dtype="float32"),
                 predict=PredictConfig(**PREDICT))
    full = _sweep(1, 7, 24, 28)              # ragged over 2, 4 and 8 shards
    case = _ellipses(2, 11, 48, 56)          # its best frame lies past the
                                             # first shard for 2 and 4
    roi = _sweep(3, 13, 40, 44)
    single = jengine.AttAsppEngine(jcfg, variables)
    sharded = jengine.AttAsppEngine(jcfg, variables,
                                    mesh=jmesh.make_mesh(JMeshConfig()))
    thr = float(np.quantile(np.asarray(single.predict_full(case)), 0.9))
    # the distilled scout (base_c 2) of the cascade tests, one file for both
    # packages
    scout = tmp_path_factory.mktemp("scout") / "scout.npz"
    save_npz_variables(init_variables(ModelConfig(base_c=2), seed=5), scout)
    group = np.stack([_ellipses(s, 11, 48, 56) for s in (2, 8, 9)])
    mesh = jmesh.make_mesh(JMeshConfig())
    cascade = dict(CASCADE, cascade_scouts=11)
    jc = dataclasses.replace(jcfg, predict=dataclasses.replace(
        jcfg.predict, **cascade, cascade_scout_weights=str(scout),
        cascade_scout_base_c=2, cascade_scout_thr=0.5))
    jb = dataclasses.replace(jcfg, predict=dataclasses.replace(
        jcfg.predict, **cascade))
    # the bulk group's first sweep is ``case``: its result is the JAX mesh
    # engine's cascade of the case with the main model as scout
    jbulk = jengine.AttAsppEngine(jb, variables, mesh=mesh).predict_bulk(
        group, SPACING, threshold=thr)
    return dict(
        vnp=vnp, cfg=cfg, full=full, case=case, roi=roi, thr=thr,
        scout=str(scout), group=group, jbulk=jbulk,
        jcascade={"direct": jbulk[0], "scout": jengine.AttAsppEngine(
            jc, variables, mesh=mesh).predict_case(case, SPACING,
                                                   threshold=thr)},
        jfull=np.asarray(sharded.predict_full(full)),
        jcase=sharded.predict_case(case, SPACING, threshold=thr),
        jcase_single=single.predict_case(case, SPACING, threshold=thr),
        jroi=np.asarray(sharded.predict_roi(roi)))


def _engines(att, d):
    one = tengine.AttAsppEngine(att["cfg"], att["vnp"], device="cpu")
    many = tengine.AttAsppEngine(att["cfg"], att["vnp"], devices=["cpu"] * d)
    assert len(many.devices) == d and len(many.models) == 1
    return one, many


@pytest.mark.parametrize("d", SHARDS)
def test_predict_full_ragged_sweep_matches_jax_mesh_and_one_device(att, d):
    one, many = _engines(att, d)
    got = many.predict_full(att["full"]).numpy()
    assert got.shape == att["full"].shape
    np.testing.assert_allclose(got, att["jfull"], **TOL)
    np.testing.assert_allclose(got, one.predict_full(att["full"]).numpy(),
                               **TOL)


@pytest.mark.parametrize("d", SHARDS)
def test_predict_case_matches_jax_mesh_and_one_device(att, d):
    """Frame, mask and AC equal; the candidates rank across shards and the
    padding frames never rank."""
    one, many = _engines(att, d)
    got = many.predict_case(att["case"], SPACING, threshold=att["thr"])
    for want in (att["jcase"], att["jcase_single"],
                 one.predict_case(att["case"], SPACING,
                                  threshold=att["thr"])):
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], np.asarray(want[1]))
        assert got[2] == pytest.approx(float(want[2]), rel=1e-6, abs=1e-9)
    assert got[1].any() and got[0] >= 6


@pytest.mark.parametrize("d", SHARDS)
def test_predict_roi_matches_jax_mesh_and_one_device(att, d):
    one, many = _engines(att, d)
    got = many.predict_roi(att["roi"]).numpy()
    assert got.shape == (PREDICT["subsample_frames"],) + att["roi"].shape[1:]
    np.testing.assert_allclose(got, att["jroi"], **TOL)
    np.testing.assert_allclose(got, one.predict_roi(att["roi"]).numpy(),
                               **TOL)


@pytest.fixture(scope="module")
def baseline():
    jcfg = dataclasses.replace(JConfig(), plain_unet=JPlainUNetConfig(**PLAIN))
    model = JPlainConvUNet.from_config(jcfg.plain_unet)
    variables = model.init(jax.random.PRNGKey(1),
                           np.zeros((1, 32, 32, 1), np.float32), train=False)
    sweep = _sweep(4, 11, 40, 48)            # ragged over 2, 4 and 8 shards
    want = jengine.BaselineEngine(jcfg, variables,
                                  mesh=jmesh.make_mesh(JMeshConfig()))
    return dict(vnp=jax.tree_util.tree_map(np.asarray, variables),
                cfg=dataclasses.replace(
                    Config(), plain_unet=PlainUNetConfig(**PLAIN)),
                sweep=sweep, jprobs=np.asarray(want.predict(sweep)))


@pytest.mark.parametrize("d", SHARDS)
def test_baseline_engine_matches_jax_mesh_and_one_device(baseline, d):
    """The softmax stack gathers whole on the primary device, and the 3-D
    postprocess of it equals the one-device engine's."""
    one = tengine.BaselineEngine(baseline["cfg"], baseline["vnp"],
                                 device="cpu")
    many = tengine.BaselineEngine(baseline["cfg"], baseline["vnp"],
                                  devices=["cpu"] * d)
    got = many.predict(baseline["sweep"])
    want_one = one.predict(baseline["sweep"])
    assert tuple(got.shape) == (3,) + baseline["sweep"].shape
    np.testing.assert_allclose(got.numpy(), baseline["jprobs"], **TOL)
    np.testing.assert_allclose(got.numpy(), want_one.numpy(), **TOL)
    np.testing.assert_array_equal(many.postprocess(got).numpy(),
                                  one.postprocess(want_one).numpy())


@pytest.mark.parametrize("n_devices,batch,mp", [(8, 4, 1), (8, 8, 2),
                                                (8, 6, 1), (8, 3, 2),
                                                (4, 8, 1), (6, 4, 3)])
def test_make_mesh_for_batch_matches_jax(n_devices, batch, mp):
    """The data axis's size and which devices it takes (the first of each
    group of ``model_parallelism``), against the JAX mesh over the same
    virtual CPU devices."""
    jm = jmesh.make_mesh_for_batch(JMeshConfig(model_parallelism=mp), batch,
                                   jax.devices()[:n_devices])
    got = tmesh.make_mesh_for_batch(MeshConfig(model_parallelism=mp), batch,
                                    ["cpu"] * n_devices)
    assert len(got) == jm.shape["data"]
    # the same positions: tag each device by its place in the list
    tags = list(range(n_devices))
    mp_ = max(1, mp)
    data = len(got)
    assert tags[: data * mp_][::mp_] == [d.id for d in jm.devices[:, 0]]


@pytest.mark.parametrize("n,d,align", [(7, 4, 1), (13, 2, 4), (3, 4, 2)])
def test_split_frames_is_the_stage_frames_layout_without_padding(n, d,
                                                                 align):
    """Shard k holds the real rows of JAX's shard k under ``stage_frames``
    (the frame axis padded to a multiple of D x align, ``batch_sharding``
    over D devices); shards of padding only are left out; gather inverts
    the split."""
    x = np.arange(n * 2 * 3, dtype=np.int32).reshape(n, 2, 3)
    shards = tmesh.split_frames(x, [torch.device("cpu")] * d, align)
    staged, pad = jengine.stage_frames(
        jmesh.make_mesh(JMeshConfig(), jax.devices()[:d]), x, align)
    want = [np.asarray(s.data) for s in sorted(
        staged.addressable_shards, key=lambda s: s.index[0].start)]
    want = [w[:max(0, n - k * len(w))] for k, w in enumerate(want)]
    want = [w for w in want if len(w)]
    assert [s.shape[0] for s in shards] == [len(w) for w in want]
    assert all(s.shape[0] % align == 0 for s in shards[:-1])
    for shard, w in zip(shards, want):
        np.testing.assert_array_equal(shard.numpy(), w)
    np.testing.assert_array_equal(
        tmesh.gather(shards, torch.device("cpu")).numpy(), x)
    assert tmesh.pad_to_multiple(n, d * align) == n + pad


def _same(a, b):
    """Two (frame, mask, AC) results bit for bit equal."""
    assert a[0] == int(b[0]) and a[2] == b[2]
    np.testing.assert_array_equal(a[1], np.asarray(b[1]))


def _cascade_cfg(att, scout, **kw):
    extra = (dict(cascade_scout_weights=att["scout"], cascade_scout_base_c=2,
                  cascade_scout_thr=0.5) if scout else {})
    return dataclasses.replace(att["cfg"], predict=dataclasses.replace(
        att["cfg"].predict, **CASCADE, **extra, **kw))


@pytest.mark.parametrize("scout", [False, True])
@pytest.mark.parametrize("d", [2, 3])
def test_sharded_cascade_equals_one_device_and_jax_mesh(att, d, scout):
    """The scout tier splits at scout micro-batches (11 frames over 2: 6 +
    5, over 3: 4 + 4 + 3), promotion runs on the primary device from the
    gathered keys, tier 2 splits again: with 5 frames promoted the result
    is bit for bit the one-device engine's; with every frame promoted it
    equals the JAX mesh engine's cascade (frame, mask, AC)."""
    for promoted, want in ((4, None), (11, att["jcascade"]["direct" if not
                                                           scout else
                                                           "scout"])):
        cfg = _cascade_cfg(att, scout, cascade_scouts=promoted)
        many = tengine.AttAsppEngine(cfg, att["vnp"], devices=["cpu"] * d)
        got = many.predict_case(att["case"], SPACING, threshold=att["thr"])
        one = tengine.AttAsppEngine(cfg, att["vnp"], device="cpu") \
            .predict_case(att["case"], SPACING, threshold=att["thr"])
        _same(got, one)
        if want is not None:
            _same(got, want)
        assert got[1].any()


@pytest.mark.parametrize("d", [2, 3])
def test_sharded_bulk_equals_one_device_and_jax_mesh(att, d):
    """A group of 3 sweeps of 11 frames (padded to 12 each): its 36 scout
    frames split at scout micro-batches, the promoted frames of all sweeps
    split at tier-2 micro-batches; bit for bit the one-device engine's with
    4 promoted per sweep, the JAX mesh engine's (which shards the sweep
    axis) with every frame promoted."""
    for promoted, want in ((4, None), (11, att["jbulk"])):
        cfg = _cascade_cfg(att, False, cascade_scouts=promoted)
        many = tengine.AttAsppEngine(cfg, att["vnp"], devices=["cpu"] * d)
        got = many.predict_bulk(att["group"], SPACING, threshold=att["thr"])
        one = tengine.AttAsppEngine(cfg, att["vnp"], device="cpu") \
            .predict_bulk(att["group"], SPACING, threshold=att["thr"])
        assert len(got) == 3
        for s in range(3):
            _same(got[s], one[s])
            if want is not None:
                _same(got[s], want[s])


def test_devices_that_are_not_there_raise(att):
    with pytest.raises((RuntimeError, ValueError)):
        tengine.AttAsppEngine(att["cfg"], att["vnp"], devices=["cuda:0"])
    with pytest.raises(ValueError):
        tmesh.resolve_devices([])
    with pytest.raises(ValueError):
        tmesh.make_mesh(MeshConfig(model_parallelism=3), ["cpu"] * 4)


FAKE_NVCC = """#!/bin/sh
echo "$@" >> "{log}"
sleep 0.5
prev=""
for a in "$@"; do
  if [ "$prev" = "-o" ]; then out="$a"; fi
  prev="$a"
done
echo built > "$out"
"""


def test_ranks_building_the_kernels_at_once_compile_each_source_once(
        tmp_path):
    """Three processes that find no library (as ranks or test workers
    starting together): under the build's file lock each source is compiled
    once, by a stand-in ``nvcc`` that logs its calls, and every process
    finds the libraries."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    from att_aspp_unet_tpu_torch.ops.kernels import _build

    bin_dir, build = tmp_path / "bin", tmp_path / "build"
    bin_dir.mkdir()
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(log=tmp_path / "calls.log"))
    nvcc.chmod(0o755)
    code = ("import sys; from pathlib import Path; "
            "from att_aspp_unet_tpu_torch.ops.kernels import _build; "
            "_build.BUILD_DIR = Path(sys.argv[1]); _build.build_all(); "
            "print(sorted(p.name for p in Path(sys.argv[1]).glob('*.so')))")
    env = dict(os.environ, PATH=f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    repo = Path(__file__).resolve().parents[1]
    procs = [subprocess.Popen([sys.executable, "-c", code, str(build)],
                              cwd=repo, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(3)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e for _, e in outs]
    calls = (tmp_path / "calls.log").read_text().splitlines()
    assert sorted(c.split()[-1].split("/")[-1] for c in calls) == \
        sorted(f"{n}.cu" for n in _build.KERNEL_SOURCES)
    names = sorted(_build.library_path(n).name for n in _build.KERNEL_SOURCES)
    assert all(o.strip() == str(names) for o, _ in outs)
    assert not list(build.glob("*.tmp"))
