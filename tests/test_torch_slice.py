"""The whole ported slice against the JAX package: ``predict_case`` and the
``.mha`` directory prediction give the same frame, mask and AC; and the port
imports nothing of JAX or of the JAX package."""

import ast
from pathlib import Path

import jax
import numpy as np
import pytest

from att_aspp_unet_tpu.config import Config as JConfig
from att_aspp_unet_tpu.config import ModelConfig as JModelConfig
from att_aspp_unet_tpu.config import PredictConfig as JPredictConfig
from att_aspp_unet_tpu.config import PreprocessConfig as JPreprocessConfig
from att_aspp_unet_tpu.infer.engine import AttAsppEngine as JEngine
from att_aspp_unet_tpu.infer.predict_cli import \
    predict_directory as j_predict_directory
from att_aspp_unet_tpu_torch.config import (Config, ModelConfig,
                                            PredictConfig, PreprocessConfig)
from att_aspp_unet_tpu_torch.infer.engine import AttAsppEngine
from att_aspp_unet_tpu_torch.infer.predict_cli import predict_directory
from att_aspp_unet_tpu_torch.io import MetaImage, read_json, read_mha, \
    write_mha

from .test_torch_model import random_variables
from .test_torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
IMG = 64
SPACING = (0.28, 0.28)


@pytest.fixture(scope="module")
def slice_setup():
    """base_c 4, f32, 64x64 network input, frame batch 4, hflip TTA on —
    the configuration of ``tests/test_e2e_reference_parity.py``."""
    variables = random_variables(4, seed=3)
    jcfg = JConfig(preprocess=JPreprocessConfig(img_size=IMG),
                   model=JModelConfig(base_c=4, compute_dtype="float32",
                                      param_dtype="float32"),
                   predict=JPredictConfig(frame_batch=4, tta_hflip=True))
    cfg = Config(preprocess=PreprocessConfig(img_size=IMG),
                 model=ModelConfig(base_c=4, compute_dtype="float32"),
                 predict=PredictConfig(frame_batch=4, tta_hflip=True))
    vnp = jax.tree_util.tree_map(np.asarray, variables)
    return jcfg, variables, cfg, vnp


def _sweep(rng, shape=(5, 40, 48)):
    sweep = (rng.random(shape) * 200).astype(np.uint8)
    sweep[3, 10:30, 8:40] = 245          # dominant bright blob
    sweep[1, 15:25, 15:30] = 235         # runner-up
    return sweep


def test_predict_case_matches_jax_engine(slice_setup, rng):
    jcfg, variables, cfg, vnp = slice_setup
    sweep = _sweep(rng)
    jeng = JEngine(jcfg, variables)
    jprobs = np.asarray(jeng.predict_full(sweep))
    # a data-derived threshold keeps the masks non-degenerate for any
    # random weights; both engines receive the same value
    thr = float(np.quantile(jprobs, 0.8))

    eng = AttAsppEngine(cfg, vnp, device="cpu")
    probs = eng.predict_full(sweep).numpy()
    np.testing.assert_allclose(probs, jprobs, rtol=1e-5, atol=1e-6)

    jf, jm, jac = jeng.predict_case(sweep, SPACING, threshold=thr)
    f, m, ac = eng.predict_case(sweep, SPACING, threshold=thr)
    assert f == int(jf)
    assert np.asarray(m).sum() > 0
    np.testing.assert_array_equal(m, np.asarray(jm))
    assert ac == jac


def test_predict_directory_matches_jax(slice_setup, rng, tmp_path):
    jcfg, variables, cfg, vnp = slice_setup
    inp = tmp_path / "in"
    inp.mkdir()
    for i in range(2):
        sweep = _sweep(rng)
        write_mha(inp / f"case_{i}.mha",
                  MetaImage(sweep, spacing=(0.28, 0.3, 1.0)))
    thr = 0.5
    j_rows = j_predict_directory(jcfg, variables, inp, tmp_path / "jax",
                                 threshold=thr, log=lambda *a: None)
    rows = predict_directory(cfg, vnp, inp, tmp_path / "port", threshold=thr,
                             device="cpu", log=lambda *a: None)
    assert rows == [(c, int(f), a) for c, f, a in j_rows]
    assert (tmp_path / "port/ac_results.csv").read_text() == \
        (tmp_path / "jax/ac_results.csv").read_text()
    for i in range(2):
        case = f"case_{i}"
        assert read_json(tmp_path / "port" / case /
                         "fetal-abdomen-frame-number.json") == \
            read_json(tmp_path / "jax" / case /
                      "fetal-abdomen-frame-number.json")
        rel = Path(case) / "images/fetal-abdomen-segmentation/output.mha"
        got, want = read_mha(tmp_path / "port" / rel), \
            read_mha(tmp_path / "jax" / rel)
        np.testing.assert_array_equal(got.array, want.array)
        assert got.spacing == want.spacing
        assert (tmp_path / "port" / rel).read_bytes() == \
            (tmp_path / "jax" / rel).read_bytes()


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_no_jax():
    files = sorted((REPO / "att_aspp_unet_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "att_aspp_unet_tpu"), \
                f"{f.relative_to(REPO)} imports {mod}"
