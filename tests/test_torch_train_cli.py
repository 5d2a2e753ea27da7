"""The port's training end to end on the CPU: one train step against the JAX
package's ``make_train_step``, ``fit`` / ``cli train`` on a tiny PNG
directory (2 epochs, a resumed third, finetune with the differential
learning rate from the port's own checkpoint), the exported ``weights.npz``
against the JAX package's export layout and loader, and the port's
independence from JAX."""

import csv
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from att_aspp_unet_tpu.config import AugmentConfig as JAugmentConfig
from att_aspp_unet_tpu.config import Config as JConfig
from att_aspp_unet_tpu.config import ModelConfig as JModelConfig
from att_aspp_unet_tpu.config import TrainConfig as JTrainConfig
from att_aspp_unet_tpu.io import write_gray_png
from att_aspp_unet_tpu.models import AttentionASPPUNet as JModel
from att_aspp_unet_tpu.train.train_loop import (create_train_state,
                                                make_train_step)
from att_aspp_unet_tpu.utils import npz_weights as jnpz
from att_aspp_unet_tpu_torch import cli
from att_aspp_unet_tpu_torch.config import AugmentConfig, Config, \
    ModelConfig, TrainConfig
from att_aspp_unet_tpu_torch.infer.models import load_variables
from att_aspp_unet_tpu_torch.train import train_loop as ttl
from att_aspp_unet_tpu_torch.utils.convert import (init_variables,
                                                   jax_variables_to_torch,
                                                   torch_tensors_to_jax)
from att_aspp_unet_tpu_torch.utils.npz_weights import load_npz_variables

from .test_torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
S, BASE_C = 32, 4
# the JAX package's metrics.csv header (train/train_loop.py:283-284) and
# summary.json keys (cli.py:207-214)
CSV_HEADER = ["epoch", "train_loss", "val_loss", "train_dice", "val_dice",
              "train_iou", "val_iou", "secs"]
SUMMARY_KEYS = ["best_val_dice", "epochs_run", "img_size", "base_c",
                "use_clahe", "stage"]
# every random transform off: the augmentation is then deterministic in both
# packages, so a port step and a JAX step see the same batch (CLAHE off too:
# it is held bit-exact elsewhere, and its compile would double the JAX step's)
NO_AUG = dict(hflip_p=0, affine_p=0, gamma_p=0, brightness_contrast_p=0,
              elastic_p=0, use_clahe=False)


def _blobs(rng, n):
    imgs = (rng.random((n, S, S)) * 60).astype(np.uint8)
    msks = np.zeros((n, S, S), np.uint8)
    yy, xx = np.mgrid[:S, :S]
    for i in range(n):
        cy, cx = rng.integers(10, S - 10, 2)
        blob = (yy - cy) ** 2 + (xx - cx) ** 2 <= 36
        imgs[i][blob] = 220
        msks[i][blob] = 255
    return imgs, msks


def test_one_train_step_matches_the_jax_train_step():
    """The same init, batch and (deterministic) augmentation through one step
    of each package, f32: loss, Dice and IoU within 1e-5 relative, the
    updated BN statistics within 1e-5, and the parameters after AdamW's first
    update (``p - lr (g / (|g| + eps) + wd p)``, each element moving by about
    lr = 3e-3) within 1e-6 except where the gradient's sign differs (XLA's f32
    gradient strays on a few near-zero elements; at most 0.5 % of them)."""
    rng = np.random.default_rng(0)
    imgs, msks = _blobs(rng, 4)
    mcfg = dict(base_c=BASE_C, compute_dtype="float32", aspp_dropout=0.0)
    tcfg = dict(batch_size=4, epochs=2, lr=3e-3)
    jcfg = JConfig(model=JModelConfig(**mcfg), train=JTrainConfig(
        augment=JAugmentConfig(**NO_AUG), **tcfg))
    cfg = Config(model=ModelConfig(**mcfg), train=TrainConfig(
        augment=AugmentConfig(**NO_AUG), **tcfg))

    v = init_variables(cfg.model, 0)
    jstate = create_train_state(jcfg.model, jcfg.train, 1,
                                jax.random.PRNGKey(0), (S, S),
                                init_variables=v)
    jstate, jm = jax.jit(make_train_step(jcfg))(jstate, imgs, msks,
                                                jax.random.PRNGKey(1))
    state = ttl.create_train_state(cfg.model, cfg.train, 1, "cpu",
                                   init_variables=v)
    p = ttl.sample_params(torch.Generator().manual_seed(0), 4, S, S,
                          cfg.train.augment)
    m = ttl.train_step(state, cfg, imgs, msks, aug_params=p).numpy()
    np.testing.assert_allclose(
        m, [float(jm[k]) for k in ("loss", "dice", "iou")], rtol=1e-5)
    got = torch_tensors_to_jax(state.model.state_dict(), cfg.model)

    def stats(path, want, have):
        assert np.abs(np.asarray(want) - have).max() <= 1e-5, path

    jax.tree_util.tree_map_with_path(stats, jax.device_get(jstate.batch_stats),
                                     got["batch_stats"])
    want = np.concatenate([np.ravel(a) for a in jax.tree_util.tree_leaves(
        jax.device_get(jstate.params))])
    have = np.concatenate([np.ravel(a) for a in
                           jax.tree_util.tree_leaves(got["params"])])
    off = np.abs(want - have) > 1e-6
    assert off.mean() <= 0.005, off.mean()


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_data")
    rng = np.random.default_rng(5)
    for name, n in (("train", 8), ("val", 4)):
        imgs, msks = _blobs(rng, n)
        for i in range(n):
            write_gray_png(root / name / "images" / f"s{i}.png", imgs[i])
            write_gray_png(root / name / "masks" / f"s{i}.png", msks[i])
    return root


def _train(dirs, out, *extra):
    return cli.main(["train", "--train_dir", str(dirs / "train"),
                     "--val_dir", str(dirs / "val"), "--output_dir", str(out),
                     "--img_size", str(S), "--base_c", str(BASE_C),
                     "--batch_size", "4", "--device", "cpu", *extra])


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def test_cli_train_resume_finetune_and_export(dirs, tmp_path):
    """2 epochs, then a second call that resumes at epoch 3; the JAX
    package's layout and formats; finetune with ``--differential_lr`` from
    the port's own ``best`` checkpoint; the exported npz."""
    out = tmp_path / "run"
    assert _train(dirs, out, "--epochs", "2", "--export_npz") == 0
    ck = out / "ckpt_main"
    for f in ("best", "last", "best.extra.json", "last.extra.json",
              "metrics.csv"):
        assert (ck / f).exists(), f
    assert json.loads((ck / "last.extra.json").read_text())["epoch"] == 2
    step_after_2 = ttl.read_checkpoint(ck / "last")["step"]
    assert step_after_2 == 4                   # 8 images / batch 4, 2 epochs

    assert _train(dirs, out, "--epochs", "3", "--export_npz") == 0
    rows = _rows(ck / "metrics.csv")
    assert rows[0] == CSV_HEADER
    assert [r[0] for r in rows[1:]] == ["1", "2", "3"]
    for r in rows[1:]:
        assert all(len(v.split(".")[1]) == 6 for v in r[1:]), r
    assert ttl.read_checkpoint(ck / "last")["step"] == 6
    summary = json.loads((out / "summary.json").read_text())
    assert list(summary) == SUMMARY_KEYS
    assert {k: summary[k] for k in SUMMARY_KEYS[1:]} == {
        "epochs_run": 3, "img_size": S, "base_c": BASE_C, "use_clahe": True,
        "stage": "main"}
    assert 0 < summary["best_val_dice"] <= 1

    # --pretrained and --weights read the port's checkpoint
    variables = load_variables(ck / "best", ModelConfig(base_c=BASE_C))
    assert _train(dirs, out, "--stage", "finetune", "--pretrained",
                  str(ck / "best"), "--differential_lr", "--epochs", "1") == 0
    assert len(_rows(out / "ckpt_finetune" / "metrics.csv")) == 2
    assert json.loads((out / "summary.json").read_text())["stage"] == \
        "finetune"

    # the npz of the main run: the best checkpoint in f16
    npz = load_npz_variables(out / "weights.npz")
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_array_equal(
            a, np.asarray(b, np.float16).astype(np.float32)), npz, variables)


def test_exported_npz_is_the_jax_export_and_jax_serves_it(dirs, tmp_path):
    """The port's ``weights.npz`` has the key set, shapes and dtypes of the
    JAX package's ``save_npz_variables`` of the same config; the JAX package
    loads it, and its forward (f32) equals the port's served model on it."""
    out = tmp_path / "scout"
    assert _train(dirs, out, "--epochs", "1", "--export_npz",
                  "--no_clahe") == 0
    assert json.loads((out / "summary.json").read_text())["use_clahe"] is False
    model = JModel.from_config(JModelConfig(base_c=BASE_C,
                                            compute_dtype="float32"))
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, S, S, 1)), train=False))
    jnpz.save_npz_variables(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), shapes), tmp_path / "jax.npz")
    with np.load(out / "weights.npz") as got, \
            np.load(tmp_path / "jax.npz") as want:
        assert set(got.files) == set(want.files)
        for k in want.files:
            assert got[k].shape == want[k].shape, k
            assert got[k].dtype == want[k].dtype, k

    jvars = jnpz.load_npz_variables(out / "weights.npz")
    x = np.random.default_rng(2).random((2, 1, S, S)).astype(np.float32)
    want, _ = jax.jit(lambda v, a: model.apply(v, a, train=False))(
        jvars, jnp.asarray(x.transpose(0, 2, 3, 1)))
    served = jax_variables_to_torch(
        load_npz_variables(out / "weights.npz"),
        ModelConfig(base_c=BASE_C, compute_dtype="float32"))
    with torch.no_grad():
        got = served(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(want).transpose(0, 3, 1, 2),
                               rtol=0, atol=1e-4)


def test_weights_that_are_not_the_ports_are_refused(tmp_path):
    """An Orbax directory exits with the way to export it; a file that is no
    checkpoint of the port, or one of another variant, exits too."""
    (tmp_path / "orbax").mkdir()
    with pytest.raises(SystemExit, match="--export_npz"):
        load_variables(tmp_path / "orbax", ModelConfig(base_c=BASE_C))
    (tmp_path / "junk").write_bytes(b"not a checkpoint")
    with pytest.raises(SystemExit, match="checkpoint of this package"):
        load_variables(tmp_path / "junk", ModelConfig(base_c=BASE_C))
    cfg = ModelConfig(base_c=BASE_C)
    state = ttl.create_train_state(cfg, TrainConfig(), 1, "cpu")
    ttl.save_checkpoint(tmp_path / "ck", state)
    assert load_variables(tmp_path / "ck", cfg)["params"]["d1_0"]
    with pytest.raises(SystemExit, match="--base_c"):
        load_variables(tmp_path / "ck", ModelConfig(base_c=8))


def test_train_refuses_cuda_without_a_card_and_finetune_without_weights(
        dirs, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["train", "--train_dir", str(dirs / "train"),
                  "--output_dir", str(tmp_path), "--img_size", str(S),
                  "--base_c", str(BASE_C), "--epochs", "1"])
    with pytest.raises(SystemExit, match="--pretrained"):
        _train(dirs, tmp_path, "--stage", "finetune")


def test_port_imports_without_jax_or_the_jax_package():
    """Every module of the port imports in a process where ``jax``,
    ``jaxlib``, ``flax``, ``optax``, ``orbax`` and ``att_aspp_unet_tpu`` cannot
    be imported, and ``chip_smoke.py`` too; ``--int8`` and ``cli warm`` (the
    int8 path calibrated and served on the CPU) run there."""
    code = r"""
import importlib, pkgutil, sys
BLOCKED = {"jax", "jaxlib", "flax", "optax", "orbax", "att_aspp_unet_tpu"}
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked: {name}")
        return None
sys.meta_path.insert(0, Block())
import att_aspp_unet_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
from att_aspp_unet_tpu_torch import cli
args = cli.build_parser().parse_args(["infer-container", "--int8"])
assert cli._config(args).model.conv_lowering == "int8"
assert cli.main(["warm", "--device", "cpu", "--base_c", "4", "--img-size",
                 "32", "--shapes", "2x32x32", "--thr", "0.5", "--int8"]) == 0
assert not BLOCKED & {m.split(".")[0] for m in sys.modules}
print(len(names))
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) > 40
