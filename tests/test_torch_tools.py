"""The port's dataset tools (``att_aspp_unet_tpu_torch/tools/{convert,split,
leak_check}.py``) and the seven offline subcommands of its command line
(``eval-seg``, ``eval-ac``, ``vis-errors``, ``convert``, ``split``,
``leak-check``, ``dataset-report``) against the JAX package's, on seeded
data: the same draws (frames, partitions), the same files (PNG and JSON
bytes equal, CSV numbers within 1e-12 relative) and the same exit codes;
and the new modules import with JAX, pandas and matplotlib blocked."""

import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from att_aspp_unet_tpu import cli as jcli
from att_aspp_unet_tpu.tools import convert as jconvert
from att_aspp_unet_tpu.tools import leak_check as jleak
from att_aspp_unet_tpu.tools import split as jsplit
from att_aspp_unet_tpu_torch import cli
from att_aspp_unet_tpu_torch.io import MetaImage, write_gray_png, write_mha
from att_aspp_unet_tpu_torch.tools import convert as tconvert
from att_aspp_unet_tpu_torch.tools import leak_check as tleak
from att_aspp_unet_tpu_torch.tools import split as tsplit

from .test_torch_evals import (_ac_inputs, _disk, _files, _seeded_uuid,
                               assert_csv_equal)
from .test_torch_evals import figures_saved_empty  # noqa: F401
from .test_torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
NEW_MODULES = ["compat", "inference", "evals.seg_metrics",
               "evals.ac_analysis", "evals.visualize", "evals.reports",
               "evals.table", "tools.convert", "tools.split",
               "tools.leak_check", "utils.native"]


def quiet(*a):
    pass


def assert_trees_equal(a: Path, b: Path) -> None:
    """Same files; CSVs by value, everything else byte for byte."""
    assert _files(a) == _files(b)
    for f in _files(a):
        if f.endswith(".csv"):
            assert_csv_equal(a / f, b / f)
        else:
            assert (a / f).read_bytes() == (b / f).read_bytes(), f


@pytest.fixture(scope="module")
def mha_root(tmp_path_factory):
    """Five cases of 12-frame image / mask volumes: mask areas that rise and
    fall, one case without foreground, one image without a mask, spacings
    from 0.1 to 0.3 mm."""
    root = tmp_path_factory.mktemp("mha")
    (root / "images").mkdir()
    (root / "masks").mkdir()
    rng = np.random.default_rng(21)
    for c in range(5):
        img = (rng.random((12, 40, 48)) * 200 + 20).astype(np.uint8)
        msk = np.zeros((12, 40, 48), np.uint8)
        for i in range(12):
            r = 0 if c == 3 else max(0, 9 - abs(i - 3 - c))
            if r:
                msk[i] = _disk((40, 48), 20, 24, r + 2) // 255
        sp = (0.1 + 0.05 * c,) * 2 + (1.0,)
        write_mha(root / "images" / f"case{c}.mha", MetaImage(img, spacing=sp))
        write_mha(root / "masks" / f"case{c}.mha", MetaImage(msk, spacing=sp))
    write_mha(root / "images/lonely.mha",
              MetaImage(np.zeros((2, 8, 8), np.uint8)))
    return root


RULES = {
    "random": dict(topk=3, neg_strategy="random", neg_ratio=1.5, neg_cap=4),
    "stride": dict(topk=2, neighbor_pad=1, neg_strategy="stride",
                   neg_stride=3, neg_cap=3, min_area_mm2=None),
    "all, capped": dict(topk=1, neg_strategy="all", neg_total_cap=9,
                        min_area_px=40),
    "negatives only": dict(export_neg_only=True, neg_strategy="random",
                           neg_ratio=2.0, seed=7),
    "random, total cap": dict(topk=2, neg_strategy="random", neg_ratio=3.0,
                              neg_cap=6, neg_total_cap=5, seed=11),
}


@pytest.mark.parametrize("rule", list(RULES))
def test_convert_equals_jax(mha_root, tmp_path, rule):
    got = tconvert.convert_frames_with_negatives(
        mha_root, tmp_path / "port", log=quiet, **RULES[rule])
    want = jconvert.convert_frames_with_negatives(
        mha_root, tmp_path / "jax", log=quiet, **RULES[rule])
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert got                                      # something was exported
    assert_trees_equal(tmp_path / "port", tmp_path / "jax")


def test_convert_helpers_equal_jax():
    rng = np.random.default_rng(3)
    frame = (rng.random((20, 30)) * 900).astype(np.float32)
    np.testing.assert_array_equal(tconvert.window_to_u8(frame),
                                  jconvert.window_to_u8(frame))
    np.testing.assert_array_equal(tconvert.window_to_u8(np.ones((4, 4))),
                                  jconvert.window_to_u8(np.ones((4, 4))))
    for kw in ({}, dict(min_area_mm2=None), dict(min_area_px=5000)):
        for sp in (None, (0.28, 0.28), (0.1, 0.5)):
            assert tconvert.area_threshold_px(tconvert.PositiveRule(**kw),
                                              sp) == \
                jconvert.area_threshold_px(jconvert.PositiveRule(**kw), sp)
    areas = rng.integers(0, 400, 30)
    for kw in (dict(topk=4), dict(topk=3, neighbor_pad=2), dict(topk=0)):
        np.testing.assert_array_equal(
            tconvert.select_positive_frames(areas, 150,
                                            tconvert.PositiveRule(**kw)),
            jconvert.select_positive_frames(areas, 150,
                                            jconvert.PositiveRule(**kw)))
    cand = np.arange(3, 29, 2)
    for kw, budget, take_all in ((dict(ratio=1.5), None, False),
                                 (dict(strategy="stride", stride=4), 2, False),
                                 (dict(), 3, True),
                                 (dict(ratio=9.0, per_case_cap=20), 0, False)):
        a = tconvert.select_negative_frames(
            cand, 4, tconvert.NegativeRule(**kw), np.random.default_rng(5),
            budget, take_all)
        b = jconvert.select_negative_frames(
            cand, 4, jconvert.NegativeRule(**kw), np.random.default_rng(5),
            budget, take_all)
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        tconvert.NegativeRule(strategy="every")


def _raw_pairs(root: Path, n: int = 13):
    rng = np.random.default_rng(8)
    for i in range(n):
        write_gray_png(root / "images" / f"f{i:02d}.png",
                       (rng.random((6, 6)) * 255).astype(np.uint8))
        if i % 4:                                   # some without a mask
            write_gray_png(root / "masks" / f"f{i:02d}.png",
                           np.zeros((6, 6), np.uint8))


@pytest.mark.parametrize("seed,frac", [(42, 0.8), (3, 0.5)])
def test_split_equals_jax(tmp_path, seed, frac):
    _raw_pairs(tmp_path / "raw")
    got = tsplit.split_train_val(tmp_path / "raw", tmp_path / "port", frac,
                                 seed, log=quiet)
    want = jsplit.split_train_val(tmp_path / "raw", tmp_path / "jax", frac,
                                  seed, log=quiet)
    assert got == want
    assert_trees_equal(tmp_path / "port", tmp_path / "jax")


@pytest.mark.parametrize("recursive,by_stem", [(False, False), (True, True)])
def test_leak_check_equals_jax(tmp_path, recursive, by_stem):
    for name in ("a.png", "b.png", "c.jpg", "sub/d.png"):
        (tmp_path / "train" / name).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / "train" / name).write_bytes(b"x")
    for name in ("b.png", "c.png", "sub/d.png", "e.png"):
        (tmp_path / "val" / name).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / "val" / name).write_bytes(b"x")
    got = tleak.check_split_leak(tmp_path / "train", tmp_path / "val",
                                 tmp_path / "port", recursive, by_stem,
                                 log=quiet)
    want = jleak.check_split_leak(tmp_path / "train", tmp_path / "val",
                                  tmp_path / "jax", recursive, by_stem,
                                  log=quiet)
    assert got == want and got["present"]
    assert_trees_equal(tmp_path / "port", tmp_path / "jax")


# ------------------------------------------------------------ the CLIs

def _run_both(argv_for, tmp_path, monkeypatch):
    """Both CLIs from their own working directory: (port rc, jax rc)."""
    rcs = []
    for name, main in (("port", cli.main), ("jax", jcli.main)):
        (tmp_path / name).mkdir(exist_ok=True)
        monkeypatch.chdir(tmp_path / name)
        try:
            rcs.append(main(argv_for(name)))
        except SystemExit as e:
            rcs.append(e.code)
    return tuple(rcs)


def _seg_dirs(root: Path):
    rng = np.random.default_rng(30)
    for i in range(6):
        cid = _seeded_uuid(rng)
        write_gray_png(root / "gt" / f"{cid}.png", _disk((32, 40), 16, 20, 8))
        write_gray_png(root / "base" / f"{cid}.png",
                       _disk((32, 40), 16 + i % 3, 21, 7 + i % 2))
        write_gray_png(root / "new" / f"{cid}_mask.png",
                       _disk((32, 40), 16, 19 + i % 4, 8 - i % 3))


def test_cli_eval_seg_and_vis_errors_equal_jax(tmp_path, monkeypatch):
    _seg_dirs(tmp_path / "d")
    d = tmp_path / "d"
    rcs = _run_both(lambda n: ["eval-seg", "--gt", str(d / "gt"), "--base",
                               str(d / "base"), "--new", str(d / "new")],
                    tmp_path, monkeypatch)
    assert rcs == (0, 0)
    rcs = _run_both(lambda n: ["vis-errors", "--csv", "seg_eval.csv",
                               "--gt", str(d / "gt"), "--base",
                               str(d / "base"), "--new", str(d / "new"),
                               "--top", "3"], tmp_path, monkeypatch)
    assert rcs == (0, 0)
    assert "vis/dice_diff_hist.png" in _files(tmp_path / "port")
    assert_trees_equal(tmp_path / "port", tmp_path / "jax")


def test_cli_eval_ac_on_the_ports_predict_output(tmp_path, monkeypatch):
    """The ``ac_results.csv`` that the port's ``predict`` writes for stacked
    cases reads as the JAX package reads it (frames map to sweeps through
    ``--fps``), and ``eval-ac`` takes it as both models."""
    from att_aspp_unet_tpu.evals.ac_analysis import read_pred as j_read_pred
    from att_aspp_unet_tpu_torch.config import (Config, ModelConfig,
                                                PredictConfig,
                                                PreprocessConfig)
    from att_aspp_unet_tpu_torch.evals.ac_analysis import read_pred
    from att_aspp_unet_tpu_torch.evals.table import column
    from att_aspp_unet_tpu_torch.infer.predict_cli import predict_directory

    from .test_torch_model import random_variables

    cfg = Config(preprocess=PreprocessConfig(img_size=32),
                 model=ModelConfig(base_c=4, compute_dtype="float32"),
                 predict=PredictConfig(frame_batch=4))
    rng = np.random.default_rng(2)
    fps, cases = 3, []
    (tmp_path / "in").mkdir()
    for c in range(2):
        sweep = (rng.random((2 * fps, 40, 48)) * 120).astype(np.uint8)
        sweep[fps + c * 2 - 1, 10:30, 10:36] = 250          # a blob
        write_mha(tmp_path / "in" / f"case_{c}.mha",
                  MetaImage(sweep, spacing=(0.28, 0.28, 1.0)))
        cases.append(f"case_{c}")
    variables = jax.tree_util.tree_map(np.asarray,
                                       random_variables(4, seed=3))
    predict_directory(cfg, variables, tmp_path / "in", tmp_path / "pred",
                      threshold=0.5, device="cpu", log=quiet)
    pred = tmp_path / "pred/ac_results.csv"
    got, want = read_pred(pred, "m", fps), j_read_pred(pred, "m", fps)
    assert [r["sweep_idx"] for r in got] == want["sweep_idx"].tolist()
    assert [r["case_id"] for r in got] == want["case_id"].tolist() == cases
    np.testing.assert_array_equal(column(got, "ac_mm"),
                                  want["ac_mm"].to_numpy(float))
    gt = tmp_path / "gt.csv"
    gt.write_text("case_id,sweep_1_ac_mm,sweep_2_ac_mm\n" + "".join(
        f"{c},{100 + 3 * i},{110 + 5 * i}\n" for i, c in enumerate(cases)))
    rcs = _run_both(lambda n: ["eval-ac", "--gt", str(gt), "--baseline",
                               str(pred), "--new", str(pred), "--fps",
                               str(fps), "--out", "ac"],
                    tmp_path, monkeypatch)
    assert rcs == (0, 0)
    assert_csv_equal(tmp_path / "port/ac/merged_ac_values.csv",
                     tmp_path / "jax/ac/merged_ac_values.csv")
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")


def test_cli_eval_ac_equals_jax(tmp_path, monkeypatch):
    _ac_inputs(tmp_path)
    rcs = _run_both(lambda n: ["eval-ac", "--gt", str(tmp_path / "gt.csv"),
                               "--baseline", str(tmp_path / "base.csv"),
                               "--new", str(tmp_path / "new.csv")],
                    tmp_path, monkeypatch)
    assert rcs == (0, 0)
    for f in _files(tmp_path / "port"):
        if f.endswith((".csv", ".txt")):
            if f.endswith(".csv"):
                assert_csv_equal(tmp_path / "port" / f, tmp_path / "jax" / f)
            else:
                assert (tmp_path / "port" / f).read_text() == \
                    (tmp_path / "jax" / f).read_text()
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    assert "ac_analysis_results/bland_alt_baseline.png" in \
        _files(tmp_path / "port")


def test_cli_convert_split_leak_check_equal_jax(mha_root, tmp_path,
                                                monkeypatch):
    """The offline data loop: ``convert`` → ``split`` → ``leak-check``
    (exit 0), then once more with a file in both sets (exit 1)."""
    rcs = _run_both(lambda n: ["convert", "--mha_root", str(mha_root),
                               "--out_root", "png", "--neg_ratio", "1.0",
                               "--topk", "2", "--seed", "5"],
                    tmp_path, monkeypatch)
    assert rcs == (0, 0)
    rcs = _run_both(lambda n: ["split", "--raw_root", "png", "--out_root",
                               "ds", "--train_frac", "0.7"],
                    tmp_path, monkeypatch)
    assert rcs == (0, 0)
    rcs = _run_both(lambda n: ["leak-check", "--train", "ds/train/images",
                               "--val", "ds/val/images"], tmp_path,
                    monkeypatch)
    assert rcs == (0, 0)
    for name in ("port", "jax"):
        ds = tmp_path / name / "ds"
        leaked = sorted((ds / "train/images").iterdir())[0]
        shutil.copy(leaked, ds / "val/images" / leaked.name)
    rcs = _run_both(lambda n: ["leak-check", "--train", "ds/train/images",
                               "--val", "ds/val/images", "--out", "leak"],
                    tmp_path, monkeypatch)
    assert rcs == (1, 1)
    assert_trees_equal(tmp_path / "port", tmp_path / "jax")


@pytest.mark.parametrize("mode", ["--root", "--flat_root", "--frame_index",
                                  "none"])
def test_cli_dataset_report_equals_jax(tmp_path, monkeypatch, mode):
    from .test_torch_evals import _flat_dataset

    src = tmp_path / "src"
    _flat_dataset(src / "flat")
    for sp, cl, n in (("train", "pos", 3), ("train", "neg", 2),
                      ("val", "pos", 1)):
        for i in range(n):
            write_gray_png(src / "dirs" / sp / cl / f"c{i}_{cl}{i}.png",
                           np.zeros((4, 4), np.uint8))
    (src / "fi.json").write_text(json.dumps(
        {"caseA": {"pos": [1, 2], "neg": [7]}, "caseB": {"neg": [3, 4]}}))
    arg = {"--root": [str(src / "dirs")],
           "--flat_root": [str(src / "flat")],
           "--frame_index": [str(src / "fi.json")], "none": []}[mode]
    rcs = _run_both(lambda n: ["dataset-report", *([mode] if arg else []),
                               *arg, "--outdir", "rep"], tmp_path,
                    monkeypatch)
    if mode == "none":
        assert rcs[0] == rcs[1] and "required" in str(rcs[0])
        return
    assert rcs == (0, 0)
    assert_trees_equal(tmp_path / "port", tmp_path / "jax")


def test_cli_parsers_share_flags_and_defaults():
    """Each offline subcommand of the port takes the JAX CLI's flags with
    its defaults."""
    def actions(parser, cmd):
        sub = next(a for a in parser._actions
                   if a.__class__.__name__ == "_SubParsersAction")
        return {a.dest: (tuple(a.option_strings), a.default, a.required,
                         a.choices)
                for a in sub.choices[cmd]._actions if a.dest != "help"}

    for cmd in ("eval-seg", "eval-ac", "vis-errors", "convert", "split",
                "leak-check", "dataset-report"):
        assert actions(cli.build_parser(), cmd) == \
            actions(jcli.get_parser(), cmd), cmd


# ------------------------------------------------------------ imports

def _toplevel_and_nested_imports(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    top, nested = set(), set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if node.level == 0 else [])
            inside = any(isinstance(p, (ast.FunctionDef, ast.AsyncFunctionDef))
                         for p in _parents(tree, node))
            (nested if inside else top).update(n.split(".")[0] for n in names)
    return top, nested


def _parents(tree, target):
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            if child is target:
                yield node
                yield from _parents(tree, node)


@pytest.mark.parametrize("module", NEW_MODULES)
def test_new_module_imports_no_pandas_and_matplotlib_only_to_draw(module):
    path = REPO / "att_aspp_unet_tpu_torch" / (module.replace(".", "/")
                                               + ".py")
    top, nested = _toplevel_and_nested_imports(path)
    blocked = {"jax", "jaxlib", "flax", "att_aspp_unet_tpu", "pandas"}
    assert not (top | nested) & blocked
    assert "matplotlib" not in top


def test_new_modules_run_with_jax_pandas_and_matplotlib_blocked(tmp_path):
    """In a process where ``jax``, ``att_aspp_unet_tpu``, ``pandas`` and
    ``matplotlib`` cannot be imported, the new modules import, and
    ``eval-seg --plot`` and ``dataset-report`` write their tables with one
    ``[warn] matplotlib unavailable`` line per skipped figure, exit 0."""
    _seg_dirs(tmp_path / "d")
    from .test_torch_evals import _flat_dataset
    _flat_dataset(tmp_path / "flat")
    code = r"""
import importlib, sys
BLOCKED = {"jax", "jaxlib", "flax", "optax", "orbax", "att_aspp_unet_tpu",
           "pandas", "matplotlib"}
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked: {name}")
        return None
sys.meta_path.insert(0, Block())
for m in sys.argv[2].split(","):
    importlib.import_module("att_aspp_unet_tpu_torch." + m)
from att_aspp_unet_tpu_torch import cli
d = sys.argv[1]
rc = cli.main(["eval-seg", "--gt", d + "/d/gt", "--base", d + "/d/base",
               "--new", d + "/d/new", "--out_csv", d + "/seg_eval.csv",
               "--plot", "--plot_dir", d + "/plots"])
rc += cli.main(["dataset-report", "--flat_root", d + "/flat", "--outdir",
                d + "/rep"])
assert not BLOCKED & {m.split(".")[0] for m in sys.modules}
print("rc", rc)
"""
    res = subprocess.run([sys.executable, "-c", code, str(tmp_path),
                          ",".join(NEW_MODULES)], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split()[-2:] == ["rc", "0"]
    warns = [w for w in res.stderr.splitlines()
             if w.startswith("[warn] matplotlib unavailable: skipped ")]
    assert len(warns) == 6 + 2                      # 3 metrics x 2, 2 reports
    assert (tmp_path / "seg_eval.csv").exists()
    assert not (tmp_path / "plots").exists()
    assert _files(tmp_path / "rep") == ["latex_table_split_stats.tex",
                                        "per_case_stats.csv",
                                        "split_stats.csv"]
