"""Data-parallel training on the CPU: one spawned 4-rank gloo run of the port
(``tests/torch_ddp_ranks.py``; its results come back through a temporary
directory) against the same code in one process on the same global batch,
and against the JAX package's train step jitted over a 4-device mesh.

- f64 (model, parameters and AdamW moments): two steps on a batch of 16
  whose positive samples fall 3 / 1 / 0 / 0 over the ranks (a mean of the
  ranks' own masked means would be wrong here), in the main and the
  finetune stage, and once with the augmentation on and ASPP Dropout 0.3:
  the loss, every gradient leaf, the BatchNorm buffers after each step and
  the parameters after both within 1e-10 of each leaf's max-abs;
- ``fit_rank`` for 2 epochs and resumed to 3: the same metrics.csv as the
  one-process run, the checkpoints written by rank 0 alone;
- f32, no-op augmentation, Dropout 0: the loss and the BatchNorm statistics
  of one step against JAX's ``make_train_step`` on a 4-device mesh, with the
  tolerances of ``test_torch_train_model.py``;
- ``fit`` with two devices spawns its own two ranks and gives the
  one-process run's metrics."""

import csv
import dataclasses
import threading
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from att_aspp_unet_tpu.config import AugmentConfig as JAugmentConfig
from att_aspp_unet_tpu.config import Config as JConfig
from att_aspp_unet_tpu.config import MeshConfig as JMeshConfig
from att_aspp_unet_tpu.config import ModelConfig as JModelConfig
from att_aspp_unet_tpu.config import TrainConfig as JTrainConfig
from att_aspp_unet_tpu.parallel import mesh as jmesh
from att_aspp_unet_tpu.train.train_loop import create_train_state, \
    make_train_step
from att_aspp_unet_tpu_torch.config import AugmentConfig, Config, \
    ModelConfig, TrainConfig
from att_aspp_unet_tpu_torch.parallel import mesh as tmesh
from att_aspp_unet_tpu_torch.train import train_loop as ttl
from att_aspp_unet_tpu_torch.train.data import ArrayDataset
from att_aspp_unet_tpu_torch.utils.convert import init_variables, \
    torch_tensors_to_jax

from . import torch_ddp_ranks as ranks
from .test_torch_threads import one_torch_thread  # noqa: F401

WORLD, S, BASE_C = 4, 32, 4
NO_AUG = dict(hflip_p=0, affine_p=0, gamma_p=0, brightness_contrast_p=0,
              elastic_p=0, use_clahe=False)
F64_CASES = ["main", "finetune", "aug_dropout"]


def _cfg(dtype, stage="main", dropout=0.0, aug=NO_AUG, batch=16):
    return Config(model=ModelConfig(base_c=BASE_C, compute_dtype=dtype,
                                    aspp_dropout=dropout),
                  train=TrainConfig(stage=stage, batch_size=batch, epochs=2,
                                    lr=3e-3, augment=AugmentConfig(**aug)))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The spec, the four ranks' results and the fit directory."""
    v = init_variables(ModelConfig(base_c=BASE_C), 0)
    batch = ranks.positives(16, [0, 1, 2, 4], S, 0)     # 3 / 1 / 0 / 0
    fit_train = ranks.positives(16, range(0, 16, 2), S, 2)
    fit_val = ranks.positives(11, range(0, 11, 3), S, 3)  # 8 + a ragged 3
    spec = {
        "steps": {
            "main": (_cfg("float64"), v, *batch),
            "finetune": (_cfg("float64", "finetune"), v, *batch),
            "aug_dropout": (_cfg("float64", dropout=0.3, aug={}), v, *batch),
            "jax_f32": (_cfg("float32", batch=4), v,
                        *ranks.positives(4, [0, 1], S, 1), 1),
        },
        "fit_cfg": dataclasses.replace(
            _cfg("float64", aug={}, batch=8), model=ModelConfig(
                base_c=BASE_C, compute_dtype="float64")),
        "fit_data": dict(train_imgs=fit_train[0], train_msks=fit_train[1],
                         val_imgs=fit_val[0], val_msks=fit_val[1]),
    }
    out = tmp_path_factory.mktemp("ranks")
    # the ranks run while this process compiles JAX's step
    failed = []

    def launch():
        try:
            tmesh.run_ranks(ranks.rank_work, [torch.device("cpu")] * WORLD,
                            spec, str(out))
        except Exception as err:                 # re-raised below
            failed.append(err)

    thread = threading.Thread(target=launch)
    thread.start()
    try:
        jax_result = _jax_step(*spec["steps"]["jax_f32"][1:4])
    finally:
        thread.join(timeout=600)
    assert not thread.is_alive()
    if failed:
        raise failed[0]
    res = [torch.load(out / f"rank{r}.pt", weights_only=False)
           for r in range(WORLD)]
    return spec, res, out, jax_result


def _close(got: dict, want: dict, what: str, tol: float = 1e-10):
    assert got.keys() == want.keys()
    for k, w in want.items():
        err = (got[k].double() - w.double()).abs().max().item()
        scale = max(w.double().abs().max().item(), 1e-30)
        assert err <= tol * scale, (what, k, err, scale)


@pytest.mark.parametrize("case", F64_CASES)
def test_ranks_equal_one_process_in_f64(run, case):
    """Loss, gradients, BN buffers after each step, parameters after two
    AdamW steps: on every rank, the one-process run's."""
    spec, res = run[:2]
    want = ranks.steps(*spec["steps"][case])
    for r in range(WORLD):
        got = res[r][case]
        np.testing.assert_allclose(np.stack(got["metrics"]),
                                   np.stack(want["metrics"]), rtol=1e-10,
                                   atol=0)
        for k in range(2):
            _close(got["grads"][k], want["grads"][k], f"rank {r} grads {k}")
            _close(got["buffers"][k], want["buffers"][k],
                   f"rank {r} buffers {k}")
        _close(got["params"], want["params"], f"rank {r} params")


def test_positives_split_unevenly_over_the_ranks(run):
    """The trap the global sums avoid: the mean of the ranks' own criterion
    values is not the global batch's loss."""
    spec, res = run[:2]
    cfg, v, imgs, msks = spec["steps"]["finetune"]
    per_rank = [(m.reshape(4, -1).any(1)).sum() for m in
                np.split(msks, WORLD)]
    assert per_rank == [3, 1, 0, 0]
    crit = ttl.build_criterion(cfg.train.loss, cfg.train.stage)
    state = ttl.create_train_state(cfg.model, cfg.train, 1, "cpu", v)
    state.model.double().train()
    x = torch.from_numpy(imgs[:, None] / 255.0)
    y = torch.from_numpy((msks[:, None] > 127).astype(np.float64))
    with torch.no_grad():
        logits, _ = state.model(x)
        whole = crit(logits, y).item()
        naive = np.mean([crit(lg, yy).item() for lg, yy in
                         zip(logits.split(4), y.split(4))])
    assert abs(naive - whole) > 1e-3 * abs(whole)


def test_dropout_and_augmentation_draw_the_global_batch(run):
    """With Dropout and the augmentation on, the ranks' loss is the
    one-process loss (each draws the global batch's parameters and mask and
    keeps its rows), not a rank-seeded draw."""
    spec, res = run[:2]
    want = ranks.steps(*spec["steps"]["aug_dropout"], n_steps=1)
    nodrop = dataclasses.replace(
        spec["steps"]["aug_dropout"][0], model=ModelConfig(
            base_c=BASE_C, compute_dtype="float64", aspp_dropout=0.0))
    other = ranks.steps(nodrop, *spec["steps"]["aug_dropout"][1:],
                        n_steps=1)
    assert res[1]["aug_dropout"]["metrics"][0][0] == pytest.approx(
        want["metrics"][0][0], rel=1e-10)
    assert abs(other["metrics"][0][0] - want["metrics"][0][0]) > 1e-6


def _rows(path: Path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def test_fit_writes_once_from_rank0_and_resumes(run, tmp_path):
    """Rank 0 alone writes the checkpoints; the resumed run continues the
    CSV (epochs 1, 2, 3) and the step count; the numbers are the
    one-process run's (the ragged 3-image val batch runs whole on every
    rank)."""
    spec, res, out = run[:3]
    assert res[0]["fit"]["saved"] and not any(res[r]["fit"]["saved"]
                                              for r in range(1, WORLD))
    assert all(res[r]["fit"]["runs"] == res[0]["fit"]["runs"]
               for r in range(WORLD))
    ck = out / "fit" / "ckpt_main"
    assert ttl.read_checkpoint(ck / "last")["step"] == 6
    want_dir = tmp_path / "one"
    ranks.fit_and_resume(spec["fit_cfg"], spec["fit_data"], want_dir)
    got, want = _rows(ck / "metrics.csv"), _rows(
        want_dir / "ckpt_main" / "metrics.csv")
    assert [r[0] for r in got] == [r[0] for r in want] == \
        ["epoch", "1", "2", "3"]
    np.testing.assert_allclose(
        np.array([r[1:7] for r in got[1:]], float),
        np.array([r[1:7] for r in want[1:]], float), rtol=0, atol=2e-6)
    # f32 parameters: AdamW's update g / (|g| + 1e-8) turns the f32
    # rounding of near-zero gradient elements into steps of up to lr
    _close(ttl.read_checkpoint(ck / "last")["model"],
           ttl.read_checkpoint(want_dir / "ckpt_main" / "last")["model"],
           "last checkpoint", tol=1e-4)


def _jax_step(v, imgs, msks):
    """JAX's train step over a 4-device mesh on the ``jax_f32`` batch:
    (batch_stats, metrics)."""
    jcfg = JConfig(model=JModelConfig(base_c=BASE_C, compute_dtype="float32",
                                      aspp_dropout=0.0),
                   train=JTrainConfig(augment=JAugmentConfig(**NO_AUG),
                                      batch_size=4, epochs=2, lr=3e-3))
    mesh = jmesh.make_mesh(JMeshConfig(), jax.devices()[:WORLD])
    rep, data = jmesh.replicate(mesh), jmesh.batch_sharding(mesh, 3)
    state = jax.device_put(create_train_state(
        jcfg.model, jcfg.train, 1, jax.random.PRNGKey(0), (S, S),
        init_variables=v), rep)
    step = jax.jit(make_train_step(jcfg), in_shardings=(rep, data, data, rep),
                   out_shardings=(rep, rep))
    state, m = step(state, imgs, msks, jax.random.PRNGKey(1))
    return jax.device_get(state.batch_stats), m


def test_four_ranks_match_the_jax_step_on_a_4_device_mesh(run):
    """f32: loss, Dice and IoU within 1e-5 relative, the updated BN
    statistics within 1e-5, on every rank."""
    spec, res, _, (stats, m) = run
    for r in range(WORLD):
        got = res[r]["jax_f32"]
        np.testing.assert_allclose(got["metrics"][0],
                                   [float(m[k]) for k in
                                    ("loss", "dice", "iou")], rtol=1e-5)
        have = torch_tensors_to_jax(got["buffers"][0],
                                    spec["steps"]["jax_f32"][0].model)

        def check(path, want, h):
            assert np.abs(np.asarray(want) - h).max() <= 1e-5, path

        jax.tree_util.tree_map_with_path(check, stats, have["batch_stats"])


def test_fit_with_two_devices_spawns_its_ranks(tmp_path):
    """``fit(devices=[cpu, cpu])`` runs two gloo ranks of its own and
    returns rank 0's result; the metrics are the one-process run's."""
    cfg = dataclasses.replace(_cfg("float64", batch=4), train=TrainConfig(
        batch_size=4, epochs=1, lr=3e-3, augment=AugmentConfig(**NO_AUG)))
    imgs, msks = ranks.positives(8, [0, 3, 5], S, 4)
    ds = ArrayDataset(imgs, msks, msks.reshape(8, -1).any(1))
    val = ArrayDataset(imgs[:3], msks[:3], msks[:3].reshape(3, -1).any(1))
    got = ttl.fit(cfg, ds, val, tmp_path / "two", devices=["cpu", "cpu"],
                  log=ranks._quiet)
    want = ttl.fit(cfg, ds, val, tmp_path / "one", device="cpu",
                   log=ranks._quiet)
    assert got["epochs_run"] == want["epochs_run"] == 1
    assert got["best_dice"] == pytest.approx(want["best_dice"], abs=1e-6)
    a = _rows(tmp_path / "two" / "ckpt_main" / "metrics.csv")
    b = _rows(tmp_path / "one" / "ckpt_main" / "metrics.csv")
    np.testing.assert_allclose(np.array(a[1][1:7], float),
                               np.array(b[1][1:7], float), atol=2e-6)


def test_a_failing_rank_or_group_raises(tmp_path):
    """Nothing falls back quietly: a rank that raises makes the launcher
    raise (the other rank is stopped), a rank whose rendezvous fails raises,
    and a batch that does not split over the devices is refused before any
    rank starts."""
    with pytest.raises(torch.multiprocessing.ProcessRaisedException):
        tmesh.run_ranks(ranks.fail_on_rank_1, [torch.device("cpu")] * 2)
    with pytest.raises(RuntimeError):        # no rank 0 ever listens there
        tmesh.init_process_group(1, 2, "gloo", tmesh.free_port(),
                                 timeout_s=2)
    assert not torch.distributed.is_initialized()
    cfg = _cfg("float32", batch=6)
    imgs, msks = ranks.positives(6, [0], S, 5)
    ds = ArrayDataset(imgs, msks, msks.reshape(6, -1).any(1))
    with pytest.raises(ValueError, match="does not split"):
        ttl.fit(cfg, ds, ds, tmp_path, devices=["cpu"] * 4)
