"""The port's benchmark (``att_aspp_unet_tpu_torch/bench.py``) against the
root ``bench.py`` on the CPU: the FLOP count, the keys of each mode's JSON
line (read from ``bench.py``'s source), each mode at a tiny size (base_c 4,
network input 32, frames of 40 x 48, one iteration) printing one line, the
weights, thresholds and scout taken from ``resources/``, the quantile of the
random-weights threshold, and no run without a card unless the CPU is asked
for."""

import ast
import dataclasses
import json
import os
import subprocess
import sys
from argparse import Namespace
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as root_bench
from att_aspp_unet_tpu_torch import bench
from att_aspp_unet_tpu_torch.config import PlainUNetConfig

from .test_torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
DEVICE_KEYS = {"device", "device_count", "power_limit"}
TINY = ["--device", "cpu", "--base-c", "4", "--img-size", "32", "--frames",
        "6", "--case-frames", "12", "--height", "40", "--width", "48",
        "--batch", "4", "--iters", "1", "--pipeline", "1", "--cascade-size",
        "16", "--cascade-scouts", "4"]


@pytest.mark.parametrize("tta", [False, True])
@pytest.mark.parametrize("size", [64, 128, 512])
@pytest.mark.parametrize("base_c", [4, 16, 48])
def test_forward_gflops_is_bench_py_s(base_c, size, tta):
    assert bench.forward_gflops(base_c, size, tta=tta) == \
        root_bench.forward_gflops(base_c, size, tta=tta)


def test_forward_gflops_of_the_served_model():
    assert round(bench.forward_gflops(), 1) == 226.8
    assert round(bench.forward_gflops(tta=True), 1) == 453.5


def _line_keys():
    """Per function of ``bench.py``: the keys of its dict literals bound to
    ``line`` or passed to ``json.dumps``, the keys it sets with ``line[k] =``
    or ``line.update({...})``, and the keys it deletes."""
    def is_line(node):
        return isinstance(node, ast.Name) and node.id == "line"

    def keys(d):
        return {k.value for k in d.keys}

    out = {}
    tree = ast.parse((REPO / "bench.py").read_text())
    for fn in tree.body:
        if not isinstance(fn, ast.FunctionDef):
            continue
        literal, assigned, deleted = set(), set(), set()
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if is_line(t) and isinstance(node.value, ast.Dict):
                        literal |= keys(node.value)
                    elif isinstance(t, ast.Subscript) and is_line(t.value):
                        assigned.add(t.slice.value)
            elif isinstance(node, ast.Call) and isinstance(node.func,
                                                           ast.Attribute):
                f = node.func
                if f.attr == "update" and is_line(f.value):
                    assigned |= keys(node.args[0])
                elif (f.attr == "dumps" and node.args
                      and isinstance(node.args[0], ast.Dict)):
                    literal |= keys(node.args[0])
            elif isinstance(node, ast.Delete):
                deleted |= {t.slice.value for t in node.targets
                            if isinstance(t, ast.Subscript)
                            and is_line(t.value)}
        out[fn.name] = (literal, assigned, deleted)
    return out


def _expected_keys(mode):
    ref = _line_keys()
    if mode in ("roi", "baseline", "train"):
        return ref[f"_bench_{mode}"][0] | DEVICE_KEYS
    literal, assigned, deleted = ref["main"]
    if mode in ("forward_only", "no_postprocess"):
        return literal | DEVICE_KEYS
    full = (literal | assigned) - deleted - {"direct_case_c1_pad"}
    return (full if mode == "bulk" else full - {"bulk"}) | DEVICE_KEYS


def test_bench_py_keys_are_read():
    keys = _expected_keys("bulk")
    assert {"metric", "value", "case_dispatch_only_fps", "direct_case_mfu",
            "tta_case_fps", "bulk", "sweep_dispatch_only_fps"} <= keys
    assert not {"sequential_fps", "dispatch_only_fps",
                "direct_case_c1_pad"} & keys
    assert _expected_keys("roi") == {"metric", "value", "unit",
                                     "vs_baseline"} | DEVICE_KEYS


def _run(capsys, mode, argv):
    """One mode through ``main`` (or its mode function where the tiny size
    needs a configuration the flags do not reach): (returned line, printed
    line)."""
    dev = torch.device("cpu")
    if mode == "roi":
        args = bench.parse_args(TINY + ["--roi", "--frames", "8"])
        cfg = bench.roi_config(args)
        cfg = dataclasses.replace(cfg, predict=dataclasses.replace(
            cfg.predict, roi_size=32, subsample_frames=4))
        line = bench.bench_roi(args, cfg, dev)
    elif mode == "baseline":
        args = bench.parse_args(TINY + ["--baseline", "--frames", "3",
                                        "--tile-batch", "4"])
        cfg = bench.baseline_config(args)
        assert cfg.plain_unet.tile_batch == 4
        cfg = dataclasses.replace(cfg, plain_unet=PlainUNetConfig(
            base_c=4, max_c=16, n_stages=3, patch_size=(32, 32),
            tile_batch=4))
        line = bench.bench_baseline(args, cfg, dev)
    else:
        return bench.main(TINY + argv), capsys.readouterr().out
    line.pop("_picks", None)
    line.update(bench.device_keys(dev))
    return line, json.dumps(line) + "\n"


@pytest.mark.parametrize("mode, argv", [
    ("bulk", ["--bulk", "2"]), ("int8", ["--int8"]), ("roi", []),
    ("baseline", []), ("train", ["--train"]),
    ("forward_only", ["--forward-only"]),
    ("no_postprocess", ["--no-postprocess"])])
def test_each_mode_prints_bench_py_s_line(capsys, mode, argv):
    line, out = _run(capsys, mode, argv)
    printed = out.splitlines()
    assert len(printed) == 1
    assert json.loads(printed[0]) == {k: v for k, v in line.items()
                                      if k != "_picks"}
    assert set(json.loads(printed[0])) == _expected_keys(mode)
    assert line["value"] > 0 and line["device"] == "cpu"
    assert line.get("direct_case_mfu") is None
    if mode in ("bulk", "int8"):
        picks = line["_picks"]
        assert set(picks) == {"sweep", "case", "direct", "tta"} | (
            {"bulk"} if mode == "bulk" else set())
        assert all(0 <= picks[k][0] < 12 for k in ("case", "direct", "tta"))
        assert line["metric"] == "e2e_case_frames_per_sec_512"
        assert line["direct_case_gflop_per_frame"] == round(
            bench.forward_gflops(4, 32), 1)


def _args(*flags):
    return bench.parse_args(list(flags))


def _bench_py_rule(root, tta=False):
    """What ``bench.py`` (main, the trained-weights branch) reads from
    ``root``: (threshold, TTA threshold, scout directory, its threshold,
    tier-1 size, scout width)."""
    syn = root / "synthetic"
    cal = json.loads((syn / "thr.json").read_text())
    thr = float(cal.get("best_thr_tta" if tta else "best_thr_no_tta",
                        cal["best_thr"]))
    thr_tta = float(cal.get("best_thr_tta", cal["best_thr"]))
    for name in ("synthetic_scout_noclahe128", "synthetic_scout_noclahe",
                 "synthetic_scout"):
        scout_dir = root / name
        if (scout_dir / "weights.npz").exists():
            break
    scal = json.loads((scout_dir / "thr.json").read_text())
    scfg = json.loads((scout_dir / "summary.json").read_text())
    return (thr, thr_tta, scout_dir,
            float(scal.get("best_thr_no_tta", scal["best_thr"])),
            int(scfg.get("img_size", 256)), int(scfg.get("base_c", 16)))


def _resolved(args, root):
    t = bench.find_trained(args, root)
    pc = bench.serving_config(args, t).predict
    return (t.thr, t.thr_tta, t.scout.parent, pc.cascade_scout_thr,
            pc.cascade_img_size, pc.cascade_scout_base_c)


@pytest.mark.parametrize("tta", [False, True])
def test_trained_weights_and_scout_are_bench_py_s(tta):
    root = REPO / "resources"
    args = _args(*(["--tta"] if tta else []))
    assert _resolved(args, root) == _bench_py_rule(root, tta)
    t = bench.find_trained(args, root)
    assert t.weights == root / "synthetic/weights.npz"
    assert t.scout.parent.name == "synthetic_scout_noclahe128"
    cfg = bench.serving_config(args, t)
    assert cfg.predict.cascade_scout_weights == str(t.scout)
    assert (cfg.model.base_c, cfg.preprocess.img_size) == (48, 512)


def test_scout_fallback_order(tmp_path):
    """Without the 128-px scout the 256-px no-CLAHE one serves, then the
    CLAHE one, as in bench.py."""
    root = tmp_path / "resources"
    for name in ("synthetic", "synthetic_scout_noclahe", "synthetic_scout"):
        (root / name).mkdir(parents=True)
        src = REPO / "resources" / name
        for f in ("thr.json", "summary.json"):
            (root / name / f).write_text((src / f).read_text())
        (root / name / "weights.npz").write_bytes(b"")
    assert _resolved(_args(), root) == _bench_py_rule(root)
    assert bench.find_trained(_args(), root).scout.parent.name == \
        "synthetic_scout_noclahe"
    (root / "synthetic_scout_noclahe/weights.npz").unlink()
    assert _resolved(_args(), root) == _bench_py_rule(root)


@pytest.mark.parametrize("flags", [["--random-weights"], ["--base-c", "16"],
                                   ["--img-size", "256"]])
def test_random_weights_outside_the_trained_config(flags):
    assert bench.find_trained(_args(*flags)) is None


@pytest.mark.parametrize("flags", [["--no-cascade"], ["--no-scout-model"]])
def test_no_scout_without_the_cascade_or_with_the_full_model(flags):
    t = bench.find_trained(_args(*flags))
    assert t.scout is None and t.thr == 0.525
    pc = bench.serving_config(_args(*flags), t).predict
    assert pc.cascade_scout_weights is None and pc.cascade_img_size == 256


@pytest.mark.parametrize("q", [0.0, 0.25, 0.5, 0.97, 0.999, 1.0])
def test_quantile_is_numpy_s_linear(q):
    a = np.random.default_rng(0).random(1001).astype(np.float32) * 3 - 1
    got = bench.quantile(torch.from_numpy(a).reshape(7, 11, 13), q)
    assert got == np.quantile(a.astype(np.float64), q, method="linear")
    assert got == pytest.approx(float(jnp.quantile(jnp.asarray(a), q)),
                                rel=1e-6)


def test_quantile_past_torch_s_limit():
    """The threshold of the random-weights path reads 140 x 562 x 744
    probabilities; ``torch.quantile`` refuses more than 2**24."""
    a = np.random.default_rng(1).random(2 ** 24 + 1, dtype=np.float32)
    t = torch.from_numpy(a)
    with pytest.raises(RuntimeError):
        torch.quantile(t, 0.97)
    assert bench.quantile(t, 0.97) == np.quantile(a.astype(np.float64), 0.97,
                                                  method="linear")


def test_no_card_raises_and_prints_nothing(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(TINY[2:])
    assert capsys.readouterr().out == ""


def test_the_command_exits_non_zero_without_a_card():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", "PYTHONPATH": str(REPO)}
    res = subprocess.run(
        [sys.executable, "-m", "att_aspp_unet_tpu_torch.bench", "--frames",
         "2"], cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and res.stdout == ""
    assert "no CUDA device" in res.stderr


def test_train_refuses_int8():
    with pytest.raises(SystemExit, match="direct"):
        bench.train_config(Namespace(int8=True))
