"""Port parity of threshold calibration and of the predict CLI's PNG path and
diagnostics: ``dice_curve`` / ``dice_curves``, ``calibrate`` on a seeded PNG
val set at two resolutions (``thr.json``, the curves, the CI tables), PNG
prediction with attention panels and a no-attention companion, and ``.mha``
prediction with the per-slice CSV and the top-K sheet, each against the JAX
package on the same inputs."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from att_aspp_unet_tpu.config import CalibrateConfig as JCalibrateConfig
from att_aspp_unet_tpu.config import Config as JConfig
from att_aspp_unet_tpu.config import ModelConfig as JModelConfig
from att_aspp_unet_tpu.config import PredictConfig as JPredictConfig
from att_aspp_unet_tpu.config import PreprocessConfig as JPreprocessConfig
from att_aspp_unet_tpu.infer import calibrate as jcal
from att_aspp_unet_tpu.infer.predict_cli import \
    predict_directory as j_predict_directory
from att_aspp_unet_tpu_torch import cli
from att_aspp_unet_tpu_torch.config import (Config, ModelConfig,
                                            PredictConfig, PreprocessConfig)
from att_aspp_unet_tpu_torch.infer import calibrate as tcal
from att_aspp_unet_tpu_torch.infer.engine import AttAsppEngine
from att_aspp_unet_tpu_torch.infer.predict_cli import predict_directory
from att_aspp_unet_tpu_torch.io import (MetaImage, read_gray_png, read_json,
                                        read_mha, write_gray_png, write_mha)

from .test_torch_variants import gap_threshold, random_variant_variables
from .test_torch_threads import one_torch_thread  # noqa: F401

IMG, BASE_C = 64, 4


def _configs(kw, **predict):
    jcfg = JConfig(preprocess=JPreprocessConfig(img_size=IMG),
                   model=JModelConfig(base_c=BASE_C, compute_dtype="float32",
                                      **kw),
                   predict=JPredictConfig(frame_batch=4, **predict))
    cfg = Config(preprocess=PreprocessConfig(img_size=IMG),
                 model=ModelConfig(base_c=BASE_C, compute_dtype="float32",
                                   **kw),
                 predict=PredictConfig(frame_batch=4, **predict))
    return jcfg, cfg


def _save_npz(path, variables):
    flat = {}
    for coll in ("params", "batch_stats"):
        for k, v in jax.tree_util.tree_leaves_with_path(variables[coll]):
            flat["/".join([coll] + [str(p.key) for p in k])] = v
    np.savez(path, **flat)


def _frame(rng, hw, blob=True):
    img = (rng.random(hw) * 180).astype(np.uint8)
    if blob:
        h, w = hw
        img[h // 4: 3 * h // 4, w // 5: 4 * w // 5] = 240
    return img


def test_dice_curves_match_jax(rng):
    """One (images x thresholds) reduction; each row equals ``dice_curve``
    of its image; both against the JAX package at atol 1e-6, an empty GT and
    an empty prediction included."""
    probs = rng.random((4, 20, 24)).astype(np.float32)
    gts = rng.random((4, 20, 24)) > 0.6
    gts[2] = False
    probs[3] = 0.0
    thrs = np.linspace(0.1, 0.9, 17).astype(np.float32)
    want = np.asarray(jcal.dice_curves(jnp.asarray(probs), jnp.asarray(gts),
                                       jnp.asarray(thrs)))
    got = tcal.dice_curves(torch.from_numpy(probs), torch.from_numpy(gts),
                           torch.from_numpy(thrs)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    for i in range(4):
        one = tcal.dice_curve(torch.from_numpy(probs[i]),
                              torch.from_numpy(gts[i]),
                              torch.from_numpy(thrs)).numpy()
        np.testing.assert_array_equal(one, got[i])
        np.testing.assert_allclose(one, np.asarray(jcal.dice_curve(
            jnp.asarray(probs[i]), jnp.asarray(gts[i]), jnp.asarray(thrs))),
            rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def val_set(tmp_path_factory):
    """Six seeded PNG frames and masks at two native resolutions, 40 x 48
    and 36 x 52 (file order interleaves them): two ``predict_full`` groups."""
    rng = np.random.default_rng(11)
    val = tmp_path_factory.mktemp("val")
    for i in range(6):
        hw = (40, 48) if i % 2 == 0 else (36, 52)
        img = _frame(rng, hw, blob=i != 4)
        msk = np.zeros(hw, np.uint8)
        msk[hw[0] // 4: 3 * hw[0] // 4, hw[1] // 5: 4 * hw[1] // 5] = 255
        write_gray_png(val / "images" / f"v{i}.png", img)
        write_gray_png(val / "masks" / f"v{i}.png", msk)
    return val


def test_calibrate_matches_jax(val_set, tmp_path):
    """``calibrate`` with hflip TTA (as the CLI runs it) against the JAX
    package's, with the CI outputs: the same ``best_thr`` and ``thr.json``,
    Dice curves within 1e-4 (f32), CI tables of the same shape whose values
    agree within 1e-4; without ``with_ci`` the port writes the same
    ``thr.json`` and no tables."""
    kw = dict(gate_variant="v2", att_depth=3)
    variables = random_variant_variables(kw, seed=12, spread=True)
    jcfg, cfg = _configs(kw, tta_hflip=True)
    ccfg = dict(thr_lo=0.3, thr_hi=0.7, thr_steps=9, with_ci=True)
    jcfg = dataclasses.replace(jcfg, calibrate=JCalibrateConfig(**ccfg))
    want = jcal.calibrate(jcfg, variables, val_set, tmp_path / "jax",
                          log=lambda *a: None)
    for with_ci in (True, False):
        out = tmp_path / f"port_{with_ci}"
        cfg = dataclasses.replace(cfg, calibrate=type(cfg.calibrate)(
            **dict(ccfg, with_ci=with_ci)))
        got = tcal.calibrate(cfg, variables, val_set, out, device="cpu",
                             log=lambda *a: None)
        assert got["best_thr"] == want["best_thr"]
        assert read_json(out / "thr.json") == \
            read_json(tmp_path / "jax/thr.json")
        assert got["curves"].shape == (6, 9)
        assert np.ptp(got["curves"]) > 0.1          # the curves are not flat
        np.testing.assert_allclose(got["curves"], want["curves"], rtol=0,
                                   atol=1e-4)
        assert (out / "calibrate_curve.csv").exists() == with_ci
    for name in ("calibrate_curve.csv", "calibrate_raw.csv"):
        a = (tmp_path / "port_True" / name).read_text().splitlines()
        b = (tmp_path / "jax" / name).read_text().splitlines()
        assert a[0] == b[0] and len(a) == len(b)
        np.testing.assert_allclose(
            np.array([r.split(",") for r in a[1:]], float),
            np.array([r.split(",") for r in b[1:]], float), rtol=0, atol=1e-4)


def test_calibrate_cli_reads_npz_and_pt(val_set, tmp_path):
    """``cli calibrate`` with the model flags on the CPU: a flat ``.npz`` and
    the same weights as a reference ``.pt`` state dict write the same
    ``thr.json`` as the library call; a checkpoint directory is refused."""
    from . import torch_ref

    oracle = torch_ref.AttentionASPPUNetV2(base_c=BASE_C, att_depth=3)
    torch_ref.randomize_bn_stats(oracle, torch.Generator().manual_seed(0))
    torch.save(oracle.state_dict(), tmp_path / "w.pt")
    flags = ["--base_c", str(BASE_C), "--gate", "v2", "--att_depth", "3",
             "--device", "cpu", "--no-tta", "--deterministic"]
    base = ["calibrate", "--val_dir", str(val_set)]
    assert cli.main(base + ["--weights", str(tmp_path / "w.pt"),
                            "--output_dir", str(tmp_path / "pt")] + flags) == 0
    from att_aspp_unet_tpu_torch.utils.convert import init_variables
    from att_aspp_unet_tpu_torch.utils.torch_import import \
        load_torch_checkpoint

    mcfg = ModelConfig(base_c=BASE_C, gate_variant="v2", att_depth=3)
    variables = load_torch_checkpoint(tmp_path / "w.pt", mcfg,
                                      init_variables(mcfg), verbose=False)
    _save_npz(tmp_path / "w.npz", variables)
    assert cli.main(base + ["--weights", str(tmp_path / "w.npz"),
                            "--output_dir", str(tmp_path / "npz")] + flags) == 0
    assert read_json(tmp_path / "pt/thr.json") == \
        read_json(tmp_path / "npz/thr.json")
    lib = tcal.calibrate(Config(model=mcfg), variables, val_set,
                         tmp_path / "lib", device="cpu", log=lambda *a: None)
    assert read_json(tmp_path / "npz/thr.json")["best_thr"] == lib["best_thr"]
    with pytest.raises(SystemExit, match="--export_npz"):
        cli.main(base + ["--weights", str(tmp_path)] + flags)


def test_png_predict_with_panels_matches_jax(tmp_path):
    """PNG frames through ``predict_directory`` with ``viz_att`` and a
    no-attention companion model: the same ``<stem>_mask.png`` files and AC
    rows (spacing map keyed by case id) as the JAX package, and panels of
    the same size whose pixels agree (jet of the same probabilities and psi
    maps)."""
    rng = np.random.default_rng(13)
    kw = dict(gate_variant="v2")
    variables = random_variant_variables(kw, seed=14,
                                         spread=True)
    na_kw = dict(gate_variant="v2", use_att=False, att_depth=0)
    na_vars = random_variant_variables(na_kw, seed=15,
                                         spread=True)
    jcfg, cfg = _configs(kw, tta_hflip=True)
    jna, na = _configs(na_kw, tta_hflip=True)
    inp = tmp_path / "in"
    write_gray_png(inp / "caseA_s3.png", _frame(rng, (40, 48)))
    write_gray_png(inp / "caseB_s7.png", _frame(rng, (40, 48)))
    write_gray_png(inp / "plain.png", _frame(rng, (40, 48), blob=False))
    (inp / "notes.txt").write_text("not an image")
    spacing = tmp_path / "spacing.json"
    spacing.write_text(json.dumps({"caseA": {"spacing": [0.3, 0.3, 1.0]},
                                   "caseB": [0.25, 0.28]}))
    # a data-derived threshold keeps the masks non-degenerate for random
    # weights; both packages receive the same value
    probs = AttAsppEngine(cfg, variables, device="cpu").predict_full(
        read_gray_png(inp / "caseA_s3.png")[None])
    thr = gap_threshold(probs, q=0.4)
    want = j_predict_directory(jcfg, variables, inp, tmp_path / "jax",
                               spacing_json=spacing, threshold=thr,
                               viz_att=True, noatt=(jna, na_vars),
                               log=lambda *a: None)
    got = predict_directory(cfg, variables, inp, tmp_path / "port",
                            spacing_json=spacing, threshold=thr, viz_att=True,
                            noatt=(na, na_vars), device="cpu",
                            log=lambda *a: None)
    assert got == [(c, f, a) for c, f, a in want] and len(got) == 2
    assert (tmp_path / "port/ac_results.csv").read_text() == \
        (tmp_path / "jax/ac_results.csv").read_text()
    from PIL import Image

    for stem in ("caseA_s3", "caseB_s7", "plain"):
        m = read_gray_png(tmp_path / f"port/{stem}_mask.png")
        np.testing.assert_array_equal(
            m, read_gray_png(tmp_path / f"jax/{stem}_mask.png"))
        a = np.asarray(Image.open(tmp_path / f"port/panels/{stem}_panel.png"))
        b = np.asarray(Image.open(tmp_path / f"jax/panels/{stem}_panel.png"))
        assert a.shape == b.shape == (2 * m.shape[0], 4 * m.shape[1], 3)
        assert (a == b).all(axis=-1).mean() > 0.99
    assert read_gray_png(tmp_path / "port/caseA_s3_mask.png").any()


def test_mha_diagnostics_match_jax(tmp_path):
    """``.mha`` sweeps with ``slice_metrics`` and ``topk_viz``: every frame
    refined, the exact selection; the same frame, AC row, output volume and
    per-slice CSV rows as the JAX package, and a top-K sheet."""
    rng = np.random.default_rng(16)
    kw = dict(use_aspp=False)
    variables = random_variant_variables(kw, seed=17,
                                         spread=True)
    jcfg, cfg = _configs(kw, tta_hflip=True, topk_frames=3)
    inp = tmp_path / "in"
    inp.mkdir()
    sweep = np.stack([_frame(rng, (40, 48), blob=i in (1, 3))
                      for i in range(5)])
    sweep[3, 12:28, 14:34] = 250
    write_mha(inp / "caseM.mha", MetaImage(sweep, spacing=(0.3, 0.3, 1.0)))
    thr = gap_threshold(AttAsppEngine(cfg, variables, device="cpu")
                        .predict_full(sweep))
    want = j_predict_directory(jcfg, variables, inp, tmp_path / "jax",
                               threshold=thr, slice_metrics=True,
                               topk_viz=True, log=lambda *a: None)
    got = predict_directory(cfg, variables, inp, tmp_path / "port",
                            threshold=thr, slice_metrics=True, topk_viz=True,
                            device="cpu", log=lambda *a: None)
    assert got == [(c, int(f), a) for c, f, a in want]
    for name in ("ac_results.csv", "caseM_slices.csv"):
        assert (tmp_path / "port" / name).read_text() == \
            (tmp_path / "jax" / name).read_text()
    rel = "caseM/images/fetal-abdomen-segmentation/output.mha"
    np.testing.assert_array_equal(read_mha(tmp_path / "port" / rel).array,
                                  read_mha(tmp_path / "jax" / rel).array)
    assert read_mha(tmp_path / "port" / rel).array.any()
    assert (tmp_path / "port/caseM_topk.png").stat().st_size > 0
