"""The serving modes of the port against the JAX package on the CPU, in f32 at
a tiny size (base_c 4, network input 64, scout input 32, 10 frames of
96 x 128): ROI crop and paste, device ranking, the two-tier cascade with and
without a distilled scout, bulk multi-sweep serving, the ROI container path,
grouped directory prediction and the command line's guards.

Masks, frames and ACs are compared exactly unless a test states a tolerance;
thresholds are derived from the data so that random weights give
non-degenerate masks, and both engines receive the same value."""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from att_aspp_unet_tpu.config import Config as JConfig
from att_aspp_unet_tpu.config import ContainerConfig as JContainerConfig
from att_aspp_unet_tpu.config import ModelConfig as JModelConfig
from att_aspp_unet_tpu.config import PredictConfig as JPredictConfig
from att_aspp_unet_tpu.config import PreprocessConfig as JPreprocessConfig
from att_aspp_unet_tpu.infer import container as jcontainer
from att_aspp_unet_tpu.infer import engine as jengine
from att_aspp_unet_tpu.preprocess import roi as jroi
from att_aspp_unet_tpu.utils.npz_weights import save_npz_variables
from att_aspp_unet_tpu_torch import cli
from att_aspp_unet_tpu_torch.config import (Config, ContainerConfig,
                                            ModelConfig, PlainUNetConfig,
                                            PredictConfig, PreprocessConfig)
from att_aspp_unet_tpu_torch.infer import container as tcontainer
from att_aspp_unet_tpu_torch.infer import engine as tengine
from att_aspp_unet_tpu_torch.infer.models import SERVED
from att_aspp_unet_tpu_torch.infer import predict_cli as tpredict
from att_aspp_unet_tpu_torch.io import MetaImage, read_json, read_mha, \
    write_mha
from att_aspp_unet_tpu_torch.models import PlainConvUNet
from att_aspp_unet_tpu_torch.preprocess import roi as troi

from .test_torch_model import random_variables
from .test_torch_threads import one_torch_thread  # noqa: F401

IMG, LOW = 64, 32
N, H, W = 10, 96, 128
SPACING = (0.28, 0.28)
CASCADE = dict(cascade=True, cascade_img_size=LOW, cascade_scout_batch=4,
               bulk_frame_batch=4)


def _t(a):
    return torch.from_numpy(np.array(a))


def _quiet(*a):
    pass


def _sweep(seed, n=N, h=H, w=W):
    """Speckle with one bright ellipse per frame whose size peaks mid-sweep,
    so that frames differ clearly in mask area."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    out = (rng.random((n, h, w)) * 120).astype(np.uint8)
    for i in range(n):
        s = 0.25 + 0.75 * (1.0 - abs(i - 0.55 * n) / (0.6 * n))
        e = ((yy - 0.5 * h) / (0.33 * h * s)) ** 2 \
            + ((xx - 0.45 * w) / (0.3 * w * s)) ** 2 <= 1
        out[i][e] = np.minimum(out[i][e] + 130, 255)
    return out


@pytest.fixture(scope="module")
def setup():
    variables = random_variables(4, seed=3)
    jcfg = JConfig(preprocess=JPreprocessConfig(img_size=IMG),
                   model=JModelConfig(base_c=4, compute_dtype="float32",
                                      param_dtype="float32"),
                   predict=JPredictConfig(frame_batch=4, tta_hflip=True,
                                          roi_size=48, subsample_frames=6))
    cfg = Config(preprocess=PreprocessConfig(img_size=IMG),
                 model=ModelConfig(base_c=4, compute_dtype="float32"),
                 predict=PredictConfig(frame_batch=4, tta_hflip=True,
                                       roi_size=48, subsample_frames=6))
    vnp = jax.tree_util.tree_map(np.asarray, variables)
    return jcfg, variables, cfg, vnp


def _with(cfg, **kw):
    return dataclasses.replace(cfg, predict=dataclasses.replace(
        cfg.predict, **kw))


def _data_threshold(cfg, vnp, sweep, q=0.8):
    probs = tengine.AttAsppEngine(cfg, vnp, device="cpu").predict_full(sweep)
    return float(np.quantile(probs.numpy(), q))


@pytest.fixture(scope="module")
def scout_dir(tmp_path_factory):
    """A base_c 2 scout as a flat-npz archive with its sidecar files: trained
    size 32, no CLAHE, threshold in thr.json."""
    d = tmp_path_factory.mktemp("scout")
    save_npz_variables(random_variables(2, seed=11), d / "weights.npz")
    (d / "summary.json").write_text(json.dumps(
        {"img_size": LOW, "base_c": 2, "use_clahe": False,
         "best_thr": 0.9, "best_thr_no_tta": 0.8}))
    (d / "thr.json").write_text(json.dumps({"best_thr": 0.5}))
    return d


# ---------------------------------------------------------------- ROI ops

@pytest.mark.parametrize("shape,roi", [((5, 96, 128), 48), ((3, 40, 70), 48),
                                       ((2, 30, 36), 48), ((4, 48, 48), 48)])
def test_crop_roi_and_paste_bit_exact(shape, roi):
    """Origins equal and patches bit-exact, frames smaller than the ROI and a
    frame with no bright pixel included; paste-back bit-exact."""
    rng = np.random.default_rng(5)
    x = rng.random(shape).astype(np.float32)
    x[0, 5:25, 10:30] += 3.0                    # centroid near a corner
    x[-1] = 0.25                                # constant: no pixel > 1.2 mean
    jp, jo = jroi.crop_roi(jnp.asarray(x), roi)
    tp, to = troi.crop_roi(_t(x), roi)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    probs = rng.random((shape[0], roi, roi)).astype(np.float32)
    want = np.asarray(jroi.paste_roi_probs(jnp.asarray(probs), jo,
                                           shape[1:]))
    got = troi.paste_roi_probs(_t(probs), to, shape[1:]).numpy()
    np.testing.assert_array_equal(got, want)


def test_crop_roi_origins_at_native_size():
    """``crop_roi`` on seeded 562 x 744 synthetic frames (a 16-frame sweep of
    the generator the container case is made of): the port's centroid is
    exact (int64 sums; a numpy reference in int64 gives the same origins),
    and on the input the ROI path gives it, the enhanced frames / 255, its
    origins equal the JAX package's f32 ones.  ``tests/compare_roi_origins.py``
    counts the differing origins over the six 140-frame sweeps: 0 of 840
    enhanced, 2 of 840 raw / 255, where JAX's f32 sums round the centroid
    across an integer."""
    from att_aspp_unet_tpu_torch.tools.synthetic import make_sweep

    from .compare_roi_origins import differing_origins, roi_inputs

    sweep = make_sweep(16, 562, 744, seed=0)[0]
    inputs = roi_inputs(sweep)
    assert differing_origins(inputs["enhanced"]) == 0
    for frames in inputs.values():
        _, got = troi.crop_roi(_t(frames), 224)
        m = frames > frames.mean(axis=(1, 2), dtype=np.float32,
                                 keepdims=True) * np.float32(1.2)
        cnt = m.sum(axis=(1, 2), dtype=np.int64)
        cy = (m.sum(axis=2, dtype=np.int64) * np.arange(562)).sum(1) // cnt
        cx = (m.sum(axis=1, dtype=np.int64) * np.arange(744)).sum(1) // cnt
        want = np.stack([np.clip(cy - 112, 0, 562 - 224),
                         np.clip(cx - 112, 0, 744 - 224)], axis=1)
        np.testing.assert_array_equal(got.numpy(), want)


def test_predict_roi_full_width_in_repo_weights_matches_jax():
    """The ROI container path with the repo's trained base_c 48 weights on
    two native 562 x 744 synthetic frames at the abdomen, f32 on both
    sides: probabilities within atol 1e-3 (trained logits reach ~10 and f32
    sums over up to 9 x 768 terms run in different orders), the same
    postprocessed stack and the same frame."""
    from att_aspp_unet_tpu_torch.tools.synthetic import make_sweep
    from att_aspp_unet_tpu_torch.utils.npz_weights import load_npz_variables

    weights = Path(__file__).resolve().parents[1] / \
        "resources/synthetic/weights.npz"
    vnp = load_npz_variables(weights)
    sweep, best, _ = make_sweep(12, 562, 744, seed=1)
    frames = sweep[best:best + 2]
    jcfg = JConfig(model=JModelConfig(compute_dtype="float32",
                                      param_dtype="float32"))
    cfg = Config(model=ModelConfig(compute_dtype="float32"))
    got = tengine.AttAsppEngine(cfg, vnp, device="cpu").predict_roi(frames)
    jeng = jengine.AttAsppEngine(jcfg, {"params": vnp["params"],
                                        "batch_stats": vnp["batch_stats"]})
    want = np.asarray(jeng.predict_roi(frames))
    assert got.shape == want.shape == (2, 562, 744)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3)
    assert (want > 0.5).any()
    post = tengine.AttAsppEngine(cfg, vnp, device="cpu").postprocess_roi(got)
    jpost = np.asarray(jeng.postprocess_roi(jnp.asarray(want)))
    np.testing.assert_array_equal(post.numpy(), jpost)
    assert tengine.select_mask_and_frame(post)[1] == \
        int(jengine.select_mask_and_frame(jpost)[1]) >= 0


# ------------------------------------------------------- ranking, batches

def _lexsort_rank(areas, keys, n_valid):
    a = np.where(keys < n_valid, areas, -1)
    return np.lexsort((-keys, -a))


@pytest.mark.parametrize("n_valid", [12, 9, 0])
def test_rank_order_equals_lexsort_with_ties_and_n_valid(n_valid):
    """Device ranking == ``np.lexsort((-idx, -areas))`` per row, by position
    and by a key of its own (the tier-2 tie-break on original indices)."""
    rng = np.random.default_rng(n_valid)
    areas = rng.integers(0, 4, (5, 12)) * 7                # many ties
    pos = np.arange(12)
    got = tengine.rank_order(_t(areas), None, n_valid).numpy()
    for s in range(5):
        np.testing.assert_array_equal(
            got[s], _lexsort_rank(areas[s], pos, n_valid))
    keys = np.stack([rng.permutation(20)[:12] for _ in range(5)])
    got = tengine.rank_order(_t(areas), _t(keys), 15).numpy()
    for s in range(5):
        np.testing.assert_array_equal(
            got[s], _lexsort_rank(areas[s], keys[s], 15))


def test_scout_micro_batch_equals_jax_over_a_grid():
    for n in (1, 7, 8, 37, 140, 144, 560, 840):
        for requested in (0, 4, 16, 32, 128, 256):
            for fb in (1, 4, 16):
                assert tengine.scout_micro_batch(n, requested, fb) == \
                    jengine.scout_micro_batch(n, requested, fb), \
                    (n, requested, fb)
    assert tengine.scout_micro_batch(840, 128, 16) == 128
    assert tengine.scout_micro_batch(140, 128, 16) == 32


# ------------------------------------------------------------- the cascade

@pytest.mark.parametrize("lowres", [True, False])
@pytest.mark.parametrize("scout", [False, True])
def test_cascade_all_promoted_equals_direct(setup, scout_dir, lowres, scout):
    """With every frame promoted the cascade is the direct path plus a scout
    pass, whatever the scout: frame, mask and AC equal exactly."""
    _, _, cfg, vnp = setup
    sweep = _sweep(1)
    thr = _data_threshold(cfg, vnp, sweep)
    want = tengine.AttAsppEngine(cfg, vnp, device="cpu").predict_case(
        sweep, SPACING, thr)
    kw = dict(CASCADE, cascade_scouts=N, cascade_lowres_enhance=lowres)
    if scout:
        # without low-res enhance tier 1 shares the CLAHE frames, so the
        # scout must be declared a CLAHE one there
        kw.update(cascade_scout_weights=str(scout_dir / "weights.npz"),
                  cascade_scout_clahe=None if lowres else True)
    eng = tengine.AttAsppEngine(_with(cfg, **kw), vnp, device="cpu")
    assert (eng.scout_model is not None) == scout
    got = eng.predict_case(sweep, SPACING, thr)
    assert got[0] == want[0] and got[2] == want[2]
    assert want[1].sum() > 0
    np.testing.assert_array_equal(got[1], want[1])


def _tier1_probs(eng, sweep):
    """The scout tier's probabilities of one sweep, from the port's pieces
    (low-res enhancement)."""
    p, pc = eng.cfg.preprocess, eng.cfg.predict
    low = eng._scout_img_size or pc.cascade_img_size
    x = tengine.resize_bilinear(_t(sweep).float(), (low, low))
    x = tengine.enhance_frames(
        x, p.clahe_clip if eng._scout_clahe else 0.0, p.clahe_grid,
        p.median_kernel).float() / 255.0
    return tengine.predict_sweep_probs(eng.scout_model or eng.model, x, 4,
                                       hflip=False)


@pytest.mark.parametrize("scout", [False, True])
def test_cascade_subset_equals_jax_engine(setup, scout_dir, scout):
    """4 of 10 frames promoted: best frame within the promoted set, refine
    set clamped to the promote count (but never below topk), and frame, mask
    and AC equal to the JAX engine's on the same weights.  The sweep is one
    whose tier-1 areas leave a gap of several pixels at the promote boundary,
    so that a one-grey-level difference in the low-res enhancement (the
    bilinear resize differs from JAX's by a few f32 ulp) cannot move it."""
    jcfg, variables, cfg, vnp = setup
    sweep = _sweep(7)
    thr = _data_threshold(cfg, vnp, sweep)
    kw = dict(CASCADE, cascade_scouts=4)
    if scout:
        kw.update(cascade_scout_weights=str(scout_dir / "weights.npz"))
    eng = tengine.AttAsppEngine(_with(cfg, **kw), vnp, device="cpu")
    # a threshold of the scout tier's own, from its probabilities
    probs_lo = _tier1_probs(eng, sweep)
    kw.update(cascade_scout_thr=float(np.quantile(probs_lo.numpy(), 0.8)))
    eng = tengine.AttAsppEngine(_with(cfg, **kw), vnp, device="cpu")
    areas = np.sort(tengine.candidate_rank_areas(
        tengine._threshold(probs_lo, eng._scout_thr), 7).numpy())[::-1]
    # n_scout = max(4, topk 5) = 5 frames are promoted
    assert areas[5] < areas[4] - 3, areas

    handle = eng.predict_case_submit(sweep, thr)
    cand_idx, refined, unsettled = tengine._unpack_result(*handle[:2])
    # the refine set is clamped to the 5 promoted frames
    assert cand_idx.shape == (5,) and refined.shape == (5, H, W)
    assert not unsettled
    f, m, ac = eng.predict_case_collect(handle, SPACING)
    assert f in cand_idx.tolist()

    jeng = jengine.AttAsppEngine(_with(jcfg, **kw), variables)
    jf, jm, jac = jeng.predict_case(sweep, SPACING, threshold=thr)
    assert f == int(jf) and ac == jac
    assert m.sum() > 0
    np.testing.assert_array_equal(m, np.asarray(jm))


def test_init_scout_adopts_sidecar_files(setup, scout_dir, tmp_path):
    """use_clahe, img_size and base_c from summary.json; the threshold from
    thr.json if it holds either key, else summary.json, the no-TTA key first
    within the chosen file; explicit configuration wins."""
    _, _, cfg, vnp = setup
    w = str(scout_dir / "weights.npz")

    def eng(**kw):
        return tengine.AttAsppEngine(
            _with(cfg, cascade=True, cascade_scout_weights=w, **kw), vnp,
            device="cpu")

    e = eng()
    assert e._scout_clahe is False and e._scout_img_size == LOW
    assert e.scout_model.cfg.base_c == 2
    assert e._scout_thr == 0.5             # thr.json best_thr beats summary
    assert eng(cascade_scout_clahe=True)._scout_clahe is True
    assert eng(cascade_scout_thr=0.31)._scout_thr == 0.31
    (scout_dir / "thr.json").write_text(json.dumps(
        {"best_thr": 0.5, "best_thr_no_tta": 0.45}))
    assert eng()._scout_thr == 0.45        # no-TTA key first
    (scout_dir / "thr.json").write_text("{}")
    assert eng()._scout_thr == 0.8         # summary fallback, no-TTA first
    (scout_dir / "thr.json").write_text(json.dumps({"best_thr": 0.5}))
    # a scout that is not loaded (cascade off) adopts nothing
    off = tengine.AttAsppEngine(_with(cfg, cascade_scout_weights=w), vnp,
                                device="cpu")
    assert off.scout_model is None and off._scout_thr == 0.0
    # no sidecar files: CLAHE on, configured size, fallback width 16
    bare = tmp_path / "bare"
    bare.mkdir()
    save_npz_variables(random_variables(16, seed=1), bare / "weights.npz")
    e = tengine.AttAsppEngine(
        _with(cfg, cascade=True,
              cascade_scout_weights=str(bare / "weights.npz")), vnp,
        device="cpu")
    assert e._scout_clahe is True and e._scout_img_size is None
    assert e.scout_model.cfg.base_c == 16 and e._scout_thr == 0.0


def test_no_clahe_scout_without_lowres_enhance_raises(setup, scout_dir):
    _, _, cfg, vnp = setup
    eng = tengine.AttAsppEngine(
        _with(cfg, **dict(CASCADE, cascade_lowres_enhance=False,
                          cascade_scout_weights=str(scout_dir /
                                                    "weights.npz"))),
        vnp, device="cpu")
    with pytest.raises(ValueError, match="cascade_lowres_enhance"):
        eng.predict_case(_sweep(1), SPACING, 0.5)


@pytest.mark.parametrize("cascade", [False, True])
@pytest.mark.parametrize("iters", [16, 1])
def test_speculative_submit_equals_exact(setup, monkeypatch, cascade, iters):
    """The submit halves' speculative fixed points (what a card runs, forced
    on here).  The noisy masks of random weights need up to 11 passes: with
    16 iterations every loop settles and nothing is repeated; with 1 the
    record comes back set and the collect half repeats, with the exact loops,
    the steps from the first unsettled one on: here the last step, so no
    forward; from the cascade's promote step on, tier 2's forward alone.
    Frame, mask and AC equal the exact run's either way."""
    _, _, cfg, vnp = setup
    if cascade:
        cfg = _with(cfg, **dict(CASCADE, cascade_scouts=4))
    sweep = _sweep(7)
    thr = _data_threshold(cfg, vnp, sweep)
    eng = tengine.AttAsppEngine(cfg, vnp, device="cpu")
    assert eng.speculate is False          # the CPU runs the exact loops
    want = eng.predict_case(sweep, SPACING, thr)
    monkeypatch.setattr(tengine.cc, "SPECULATIVE_ITERS", iters)
    eng.speculate = True
    forwards = []
    eng.model.register_forward_hook(
        lambda mod, args, out: forwards.append(args[0].shape[0]))
    handle = eng.predict_case_submit(sweep, thr)
    assert bool(tengine._unpack_result(*handle[:2])[2]) == (iters == 1)
    in_submit = len(forwards)
    got = eng.predict_case_collect(handle, SPACING)
    assert eng.exact_repeats == (iters == 1)
    assert in_submit >= 2 and len(forwards) == in_submit
    if cascade and iters == 16:
        # the promote step's record forced on: the collect repeats from
        # there, tier 2's micro-batches (frames with their hflip twins)
        # included, the scout's not
        forwards.clear()
        handle = eng.predict_case_submit(sweep, thr)
        handle[0][..., -1] = 1
        submitted = list(forwards)
        got = eng.predict_case_collect(handle, SPACING)
        n_scout = max(4, cfg.predict.topk_frames)
        assert forwards[len(submitted):] == submitted[-2:]
        assert sum(submitted[-2:]) == 2 * n_scout and eng.exact_repeats == 1
    assert (got[0], got[2]) == (want[0], want[2]) and want[1].sum() > 0
    np.testing.assert_array_equal(got[1], want[1])
    if cascade:
        bulk = eng.predict_bulk(np.stack([sweep, _sweep(2)]), SPACING, thr)
        assert (bulk[0][0], bulk[0][2]) == (want[0], want[2])
        np.testing.assert_array_equal(bulk[0][1], want[1])


# ------------------------------------------------------------------- bulk

@pytest.mark.parametrize("n", [8, 10])
def test_predict_bulk_equals_per_case_and_jax(setup, n):
    """S = 3 sweeps: bulk == three ``predict_case`` calls == the JAX bulk
    (frames, masks, ACs exactly); n = 10 is ragged against frame_batch 4, so
    the frame axis is padded and the pad frames must never be picked."""
    jcfg, variables, cfg, vnp = setup
    sweeps = np.stack([_sweep(s, n=n) for s in (2, 3, 4)])
    thr = _data_threshold(cfg, vnp, sweeps[0])
    kw = dict(CASCADE, cascade_scouts=4)
    eng = tengine.AttAsppEngine(_with(cfg, **kw), vnp, device="cpu")
    bulk = eng.predict_bulk(sweeps, SPACING, thr)
    jbulk = jengine.AttAsppEngine(_with(jcfg, **kw), variables).predict_bulk(
        sweeps, SPACING, threshold=thr)
    assert len(bulk) == 3
    for s in range(3):
        f, m, ac = eng.predict_case(sweeps[s], SPACING, thr)
        assert 0 <= bulk[s][0] < n
        assert (bulk[s][0], bulk[s][2]) == (f, ac)
        np.testing.assert_array_equal(bulk[s][1], m)
        assert (bulk[s][0], bulk[s][2]) == (int(jbulk[s][0]), jbulk[s][2])
        np.testing.assert_array_equal(bulk[s][1], np.asarray(jbulk[s][1]))
    assert sum(int(b[1].sum() > 0) for b in bulk) >= 2


def test_predict_bulk_requires_cascade(setup):
    _, _, cfg, vnp = setup
    eng = tengine.AttAsppEngine(cfg, vnp, device="cpu")
    with pytest.raises(ValueError, match="cascade"):
        eng.predict_bulk(np.zeros((2, 4, 40, 48), np.uint8))


# -------------------------------------------------------------- ROI path

def test_predict_roi_matches_jax(setup):
    """Probabilities of the ROI path at atol 1e-4 (f32 forward on both
    sides; measured difference ~1e-6), zero outside the pasted windows on
    both, and the same postprocessed stack."""
    jcfg, variables, cfg, vnp = setup
    sweep = _sweep(6)
    eng = tengine.AttAsppEngine(cfg, vnp, device="cpu")
    jeng = jengine.AttAsppEngine(jcfg, variables)
    got = eng.predict_roi(sweep).numpy()
    want = np.asarray(jeng.predict_roi(sweep))
    assert got.shape == want.shape == (6, H, W)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got == 0, want == 0)
    np.testing.assert_array_equal(
        eng.postprocess_roi(_t(want)).numpy(),
        np.asarray(jeng.postprocess_roi(jnp.asarray(want))))


def test_select_mask_and_frame_and_resize_mask_to():
    stack = np.zeros((4, 6, 8), np.uint8)
    stack[1, :2] = 1
    stack[3, :2] = 3                        # same area: the first wins
    m, f = tengine.select_mask_and_frame(stack)
    jm, jf = jengine.select_mask_and_frame(stack)
    assert f == jf == 1
    np.testing.assert_array_equal(m, jm)
    m, f = tengine.select_mask_and_frame(np.zeros((3, 5, 5), np.uint8))
    assert f == -1 and m.shape == (5, 5) and not m.any()
    assert tengine.select_mask_and_frame(stack[1])[1] == 0
    up = tengine.resize_mask_to(stack[1], (25, 31))
    np.testing.assert_array_equal(up, jengine.resize_mask_to(stack[1],
                                                             (25, 31)))
    assert tengine.resize_mask_to(stack[3], (6, 8)).max() == 1


# -------------------------------------------------------------- container

def _case_tree(root, sweep):
    d = root / "input/images/stacked-fetal-ultrasound"
    d.mkdir(parents=True)
    write_mha(d / "case-0001_1_0000.mha",
              MetaImage(sweep, spacing=(0.28, 0.28, 0.28)))


def test_container_run_matches_jax_run(setup, tmp_path, monkeypatch):
    """The same input tree through both packages: same files, same frame
    JSON, equal volumes ({0, 1} uint8, spacing 0.28, foreground only on the
    named frame), the same probability dump at atol 1e-4."""
    jcfg, variables, cfg, vnp = setup
    sweep = _sweep(7)
    _case_tree(tmp_path, sweep)
    monkeypatch.chdir(tmp_path)             # output/probabilities is relative
    outs = {}
    for name, mod, c, v, ccls, extra in (
            ("jax", jcontainer, jcfg, variables, JContainerConfig, {}),
            ("port", tcontainer, cfg, vnp, ContainerConfig,
             {"device": "cpu"})):
        cc = ccls(input_path=str(tmp_path / "input"),
                  output_path=str(tmp_path / name), model_tag="att_aspp",
                  case_id="case42")
        rc = mod.run(dataclasses.replace(c, container=cc), v,
                     save_probabilities=True, debug_frames=True, log=_quiet,
                     **extra)
        assert rc == 0
        prob = tmp_path / "output/probabilities/case-0001_1_0000_prob.npy"
        outs[name] = np.load(prob)
        prob.unlink()
    np.testing.assert_allclose(outs["port"], outs["jax"], rtol=0, atol=1e-4)
    files = {n: sorted(str(p.relative_to(tmp_path / n))
                       for p in (tmp_path / n).rglob("*") if p.is_file())
             for n in ("jax", "port")}
    assert files["port"] == files["jax"] and len(files["port"]) == 8
    frame = read_json(tmp_path / "port/fetal-abdomen-frame-number.json")
    assert frame == read_json(tmp_path / "jax/fetal-abdomen-frame-number.json")
    rel = "images/fetal-abdomen-segmentation/case42.mha"
    got, want = read_mha(tmp_path / "port" / rel), \
        read_mha(tmp_path / "jax" / rel)
    np.testing.assert_array_equal(got.array, want.array)
    assert got.array.dtype == np.uint8 and got.array.shape == sweep.shape
    assert set(np.unique(got.array)) == {0, 1}
    assert got.spacing == pytest.approx((0.28, 0.28, 0.28))
    assert np.flatnonzero(got.array.reshape(N, -1).any(axis=1)).tolist() \
        == [frame]
    assert frame in np.linspace(0, N - 1, 6).astype(int)
    for png in ("frame000_orig.png", "frame005_enh.png"):
        assert (tmp_path / "port/images" / png).read_bytes() == \
            (tmp_path / "jax/images" / png).read_bytes()


@pytest.mark.parametrize("entry", ["run_from_env", "cli"])
def test_run_from_env_honours_model_tag_and_case_id(setup, tmp_path,
                                                    monkeypatch, entry):
    """MODEL_TAG and CASE_ID of the environment override the configuration;
    unset, the configured model serves (``baseline``, the default, is the
    nnU-Net-style model); an unknown tag raises, never falls through.  The
    CLI: ``--model-tag`` takes the tags of the served-models table and no
    other, and an unknown ``MODEL_TAG`` raises as ``run`` does, before any
    weights are read."""
    _, _, cfg, vnp = setup
    _case_tree(tmp_path, _sweep(7, n=4))
    if entry == "cli":
        sub = cli.build_parser()._subparsers._group_actions[0].choices
        tag_flag, = [a for a in sub["infer-container"]._actions
                     if a.dest == "model_tag"]
        assert tag_flag.choices == list(SERVED) == ["baseline", "att_aspp",
                                                    "swin_unetr"]
        argv = ["infer-container", "--input", str(tmp_path / "input"),
                "--output", str(tmp_path / "out"), "--base_c", "4",
                "--device", "cpu"]
        monkeypatch.delenv("MODEL_TAG", raising=False)
        with pytest.raises(SystemExit):
            cli.main(argv + ["--model-tag", "nnunet"])
        monkeypatch.setenv("MODEL_TAG", "nnunet")
        for weights in ([], ["--weights", str(tmp_path / "missing.npz")]):
            with pytest.raises(ValueError, match="nnunet"):
                cli.main(argv + weights)
        assert not (tmp_path / "out").exists()
        return
    small = PlainUNetConfig(base_c=4, max_c=16, n_stages=3,
                            patch_size=(32, 32), compute_dtype="float32")
    plain = PlainConvUNet.from_config(small, seed=1)
    kw = dict(save_probabilities=False, debug_frames=False, device="cpu",
              log=_quiet)

    def cfg_for(tag, out):
        return dataclasses.replace(cfg, plain_unet=small, container=(
            ContainerConfig(input_path=str(tmp_path / "input"),
                            output_path=str(tmp_path / out), model_tag=tag,
                            case_id="from_cfg")))

    def written(out):
        seg = tmp_path / out / "images/fetal-abdomen-segmentation"
        return [p.name for p in seg.iterdir()]

    monkeypatch.delenv("MODEL_TAG", raising=False)
    monkeypatch.delenv("CASE_ID", raising=False)
    assert tcontainer.run_from_env(cfg_for("baseline", "o1"), plain, **kw) == 0
    assert written("o1") == ["from_cfg.mha"]
    monkeypatch.setenv("MODEL_TAG", "att_aspp")
    monkeypatch.setenv("CASE_ID", "from_env")
    assert tcontainer.run_from_env(cfg_for("baseline", "o2"), vnp, **kw) == 0
    assert written("o2") == ["from_env.mha"]
    assert not (tmp_path / "o2/images/frame000_orig.png").exists()
    monkeypatch.setenv("MODEL_TAG", "baseline")
    assert tcontainer.run_from_env(cfg_for("att_aspp", "o3"), plain, **kw) == 0
    assert written("o3") == ["from_env.mha"]
    monkeypatch.setenv("MODEL_TAG", "nnunet")
    with pytest.raises(ValueError, match="nnunet"):
        tcontainer.run_from_env(cfg_for("baseline", "o4"), plain, **kw)


# ------------------------------------------------ directories and the CLI

def _write_cases(inp, shapes):
    inp.mkdir()
    for i, (n, h, w) in enumerate(shapes):
        write_mha(inp / f"case_{i}.mha",
                  MetaImage(_sweep(20 + i, n, h, w),
                            spacing=(0.28, 0.3, 1.0)))


def test_predict_directory_bulk_group_equals_per_case(setup, tmp_path):
    """bulk_group=2 over five cases, the fourth of another shape: groups
    (0, 1), then 2 alone (the shape change closes its group), then 3 alone
    and 4 alone; the files and CSV rows equal the per-case run's, in the same
    order; without cascade mode it raises."""
    _, _, cfg, vnp = setup
    inp = tmp_path / "in"
    _write_cases(inp, [(8, 64, 80)] * 3 + [(8, 56, 80), (8, 64, 80)])
    ccfg = _with(cfg, **dict(CASCADE, cascade_scouts=4))
    calls = []
    orig = tengine.AttAsppEngine.predict_bulk_submit

    def spy(self, sweeps, threshold=None):
        calls.append(np.shape(sweeps))
        return orig(self, sweeps, threshold)

    rows_1 = tpredict.predict_directory(ccfg, vnp, inp, tmp_path / "one",
                                        threshold=0.5, device="cpu",
                                        log=_quiet)
    tengine.AttAsppEngine.predict_bulk_submit = spy
    try:
        rows_b = tpredict.predict_directory(
            ccfg, vnp, inp, tmp_path / "bulk", threshold=0.5, bulk_group=2,
            device="cpu", log=_quiet)
    finally:
        tengine.AttAsppEngine.predict_bulk_submit = orig
    assert calls == [(2, 8, 64, 80)]
    assert rows_b == rows_1
    assert [r[0] for r in rows_b] == [f"case_{i}" for i in range(5)]
    files = sorted(p.relative_to(tmp_path / "one")
                   for p in (tmp_path / "one").rglob("*") if p.is_file())
    assert len(files) == 11
    for rel in files:
        assert (tmp_path / "bulk" / rel).read_bytes() == \
            (tmp_path / "one" / rel).read_bytes(), rel
    with pytest.raises(ValueError, match="cascade"):
        tpredict.predict_directory(cfg, vnp, inp, tmp_path / "x",
                                   bulk_group=2, device="cpu", log=_quiet)


def test_predict_directory_splits_a_group_over_the_budget(setup, tmp_path,
                                                          monkeypatch):
    """A budget that holds two cases splits a group of three into a pair and
    a single; read-ahead off gives the same rows."""
    _, _, cfg, vnp = setup
    inp = tmp_path / "in"
    _write_cases(inp, [(8, 64, 80)] * 3)
    ccfg = _with(cfg, **dict(CASCADE, cascade_scouts=4))
    per_case = 2 * 4 * 8 * 64 * 80
    monkeypatch.setattr(tpredict, "bulk_budget_bytes",
                        lambda device: 2.5 * per_case)
    logs = []
    rows = tpredict.predict_directory(ccfg, vnp, inp, tmp_path / "a",
                                      threshold=0.5, bulk_group=3,
                                      device="cpu", log=logs.append)
    assert any("capped at 2" in l for l in logs)
    rows_1 = tpredict.predict_directory(ccfg, vnp, inp, tmp_path / "b",
                                        threshold=0.5, read_ahead=False,
                                        device="cpu", log=_quiet)
    assert rows == rows_1 and len(rows) == 3


@pytest.mark.parametrize("argv", [
    ["--bulk", "1", "--cascade"], ["--bulk", "-2", "--cascade"],
    ["--bulk", "2"], ["--scout_weights", "s.npz"], ["--scout_thr", "0.4"],
    ["--scout_base_c", "8"], ["--scout_no_clahe"],
    ["--scout_rank", "closed"]])
def test_cli_predict_guards_raise_system_exit(argv, tmp_path):
    with pytest.raises(SystemExit):
        cli.main(["predict", "--weights", str(tmp_path / "w.npz"),
                  "--input_dir", str(tmp_path), "--device", "cpu"] + argv)


def test_cli_infer_container_reads_the_environment(setup, tmp_path,
                                                   monkeypatch):
    """``infer-container`` end to end on the CPU through ``main``: CASE_ID
    and MODEL_TAG of the environment override the flags."""
    _, variables, _, _ = setup
    save_npz_variables(variables, tmp_path / "w.npz")
    _case_tree(tmp_path, _sweep(7, n=4, h=64, w=80))
    monkeypatch.setenv("MODEL_TAG", "att_aspp")
    monkeypatch.setenv("CASE_ID", "c7")
    monkeypatch.chdir(tmp_path)
    rc = cli.main(["infer-container", "--input", str(tmp_path / "input"),
                   "--output", str(tmp_path / "out"), "--model-tag",
                   "baseline", "--weights", str(tmp_path / "w.npz"),
                   "--base_c", "4", "--device", "cpu",
                   "--no-save-probabilities", "--no-debug-frames"])
    assert rc == 0
    vol = read_mha(tmp_path / "out/images/fetal-abdomen-segmentation/c7.mha")
    assert vol.array.shape == (4, 64, 80) and vol.array.dtype == np.uint8
    assert set(np.unique(vol.array)) <= {0, 1}
    assert not (tmp_path / "output").exists()
