"""The port's offline evaluation suite (``att_aspp_unet_tpu_torch/evals/
{seg_metrics,ac_analysis,visualize,reports}.py``, pandas-free) against the
JAX package's on seeded inputs.  Scores are equal; the written CSV files
have the same header, row order and empty fields (NaN), and their numbers
parse equal within 1e-12 relative; TXT, TEX and PNG files are equal byte for
byte; the figures carry the JAX package's file names."""

import csv
import json
import math
import uuid
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from att_aspp_unet_tpu.evals import ac_analysis as jac
from att_aspp_unet_tpu.evals import reports as jrep
from att_aspp_unet_tpu.evals import seg_metrics as jseg
from att_aspp_unet_tpu.evals import visualize as jvis
from att_aspp_unet_tpu_torch.evals import ac_analysis as tac
from att_aspp_unet_tpu_torch.evals import reports as trep
from att_aspp_unet_tpu_torch.evals import seg_metrics as tseg
from att_aspp_unet_tpu_torch.evals import table
from att_aspp_unet_tpu_torch.evals import visualize as tvis
from att_aspp_unet_tpu_torch.io import write_gray_png

from .test_torch_threads import one_torch_thread  # noqa: F401


def quiet(*a):
    pass


@pytest.fixture(autouse=True)
def figures_saved_empty(monkeypatch):
    """Figures are built as usual but saved as empty files, on both sides:
    the tests compare their names, and rasterising them at 200-300 dpi was
    most of these tests' time."""
    import matplotlib
    matplotlib.use("Agg")
    from matplotlib.figure import Figure

    monkeypatch.setattr(Figure, "savefig",
                        lambda self, fname, *a, **k: Path(fname).write_bytes(
                            b""))


class Log(list):
    def __call__(self, msg):
        self.append(str(msg))


def assert_csv_equal(got: Path, want: Path) -> None:
    """Same header and rows; numbers within 1e-12 relative, empty fields
    (NaN) in the same places, text equal."""
    with open(got, newline="") as f:
        g = list(csv.reader(f))
    with open(want, newline="") as f:
        w = list(csv.reader(f))
    assert g[0] == w[0]
    assert len(g) == len(w)
    for rg, rw in zip(g[1:], w[1:]):
        assert len(rg) == len(rw)
        for a, b in zip(rg, rw):
            try:
                fa, fb = float(a), float(b)
            except ValueError:
                assert a == b
                continue
            if math.isinf(fb) or fb == 0:
                assert fa == fb
            else:
                assert abs(fa - fb) <= 1e-12 * abs(fb), (a, b)


def _files(d: Path):
    return sorted(str(p.relative_to(d)) for p in d.rglob("*") if p.is_file())


def _disk(shape, cy, cx, r):
    yy, xx = np.mgrid[: shape[0], : shape[1]]
    return (((yy - cy) ** 2 + (xx - cx) ** 2) <= r * r).astype(np.uint8) * 255


def _masks():
    rng = np.random.default_rng(4)
    a = _disk((48, 48), 24, 24, 12)
    border = np.zeros((48, 48), np.uint8)
    border[:20, :30] = 255
    return {"same": (a, a), "shifted": (a, np.roll(a, 4, axis=1)),
            "empty pred": (np.zeros_like(a), a),
            "both empty": (np.zeros_like(a), np.zeros_like(a)),
            "border": (border, _disk((48, 48), 8, 12, 10)),
            "speckle": ((rng.random((48, 48)) < 0.3) * 255,
                        (rng.random((48, 48)) < 0.3) * 255)}


@pytest.mark.parametrize("name", list(_masks()))
def test_scores_equal_jax(name):
    pred, gt = _masks()[name]
    assert tseg.confusion_counts(pred, gt) == jseg.confusion_counts(pred, gt)
    assert tseg.dice(pred, gt) == jseg.dice(pred, gt)
    assert tseg.iou(pred, gt) == jseg.iou(pred, gt)
    got, want = tseg.hd95(pred, gt), jseg.hd95(pred, gt)
    assert got == want or (math.isnan(got) and math.isnan(want))
    np.testing.assert_array_equal(tseg._surface(gt), jseg._surface(gt))
    s, j = tseg.score_pair(pred, gt), jseg.score_pair(pred, gt)
    assert s.keys() == j.keys()
    np.testing.assert_array_equal(list(s.values()), list(j.values()))


def test_case_id_and_index_dir(tmp_path):
    rng = np.random.default_rng(1)
    cids = [str(uuid.UUID(int=int(rng.integers(1 << 62)))) for _ in range(3)]
    for i, cid in enumerate(cids):
        write_gray_png(tmp_path / f"sub{i}" / f"{cid.upper()}_mask.png",
                       np.zeros((4, 4), np.uint8))
    (tmp_path / "notes.txt").write_text("x")
    for strip in ("", "_mask"):
        assert tseg.index_dir(tmp_path, strip) == \
            jseg.index_dir(tmp_path, strip)
    assert tseg.case_id(cids[0] + "_x") == jseg.case_id(cids[0] + "_x")
    with pytest.raises(ValueError):
        tseg.case_id("no-uuid-here")
    assert tseg.index_dir(tmp_path / "missing") == {}


@pytest.mark.parametrize("hib", [True, False])
def test_paired_comparison_and_show_metric(hib):
    rng = np.random.default_rng(2)
    new = rng.random(12)
    base = rng.random(12)
    base[3] = np.nan                                 # dropped from the stats
    got = tseg.paired_comparison(new, base, hib)
    want = jseg.paired_comparison(new, base, hib)
    for key in ("improved", "n", "stars"):
        assert got[key] == want[key]
    for side in ("new", "base"):
        for k, v in want[side].items():
            assert got[side][k] == pytest.approx(float(v), rel=1e-12)
    assert (math.isnan(got["wilcoxon_p"]) and math.isnan(want["wilcoxon_p"])
            or got["wilcoxon_p"] == want["wilcoxon_p"])
    lt, lj = Log(), Log()
    tseg.show_metric("Dice", new[:-1], rng.random(11), "", hib, log=lt)
    rng = np.random.default_rng(2)
    new = rng.random(12)
    rng.random(12)
    jseg.show_metric("Dice", new[:-1], rng.random(11), "", hib, log=lj)
    assert lt == lj


def _seeded_uuid(rng):
    return str(uuid.UUID(int=int(rng.integers(1 << 62)) << 64
                         | int(rng.integers(1 << 62))))


@pytest.fixture(scope="module")
def eval_dirs(tmp_path_factory):
    """GT, baseline and new-model masks of 8 seeded cases (one empty new
    prediction: HD95 NaN), with background frames for the overlays."""
    root = tmp_path_factory.mktemp("evals")
    rng = np.random.default_rng(0)
    cids = []
    for i in range(8):
        cid = _seeded_uuid(rng)
        cids.append(cid)
        r = 10 + i % 4
        gt = _disk((48, 56), 24, 26, r)
        base = _disk((48, 56), 24 + i % 3, 28, r - 1)
        new = (_disk((48, 56), 24, 27 + i % 2 + i // 4, r) if i != 5
               else np.zeros((48, 56), np.uint8))
        write_gray_png(root / "gt" / f"{cid}.png", gt)
        write_gray_png(root / "base" / f"{cid}.png", base)
        write_gray_png(root / "new" / f"{cid}_mask.png", new)
        write_gray_png(root / "img" / f"{cid}.png",
                       (rng.random((24, 28)) * 255).astype(np.uint8))
    # a GT case without predictions is skipped by both
    write_gray_png(root / "gt" / f"{_seeded_uuid(rng)}.png",
                   _disk((48, 56), 20, 20, 9))
    return root, cids


def test_evaluate_cases_equal_jax(eval_dirs):
    root, _ = eval_dirs
    got = tseg.evaluate_cases(root / "gt", root / "base", root / "new",
                              log=quiet)
    want = jseg.evaluate_cases(root / "gt", root / "base", root / "new",
                               log=quiet)
    assert [r["case"] for r in got] == want["case"].tolist()
    for col in want.columns[1:]:
        np.testing.assert_array_equal(table.column(got, col),
                                      want[col].to_numpy(float))


def test_evaluate_directories_writes_jax_files(eval_dirs, tmp_path):
    root, cids = eval_dirs
    outs, logs = {}, {}
    for name, mod in (("port", tseg), ("jax", jseg)):
        logs[name] = Log()
        outs[name] = mod.evaluate_directories(
            root / "gt", root / "base", root / "new",
            out_csv=tmp_path / name / "seg_eval.csv",
            plot_dir=tmp_path / name / "plots", log=logs[name])
    assert_csv_equal(tmp_path / "port/seg_eval.csv",
                     tmp_path / "jax/seg_eval.csv")
    lines = (tmp_path / "port/seg_eval.csv").read_text().splitlines()
    assert ",," in lines[1 + sorted(cids).index(cids[5])] or \
        any(",," in line for line in lines)        # NaN HD95: empty field
    assert len(outs["port"]) == len(outs["jax"]) == 8
    for g, w in zip(outs["port"], outs["jax"]):
        assert g[0] == w[0]
        np.testing.assert_array_equal(np.array(g[1:], float),
                                      np.array(w[1:], float))
    # no two new-model Dice values tie, so the best / worst lines agree too
    assert [x.replace(str(tmp_path / "port"), "")
            for x in logs["port"]] == \
        [x.replace(str(tmp_path / "jax"), "") for x in logs["jax"]]
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")


def test_ac_parsing_equal_jax(tmp_path):
    gt = pd.DataFrame({"uuid": ["A", "B", "C"],
                       "sweep_1_ac_mm": [100.0, 110.0, np.nan],
                       "notes": ["x", "y", "z"],
                       "sweep_2_ac_mm": [105.0, np.nan, 97.5]})
    gt.to_csv(tmp_path / "gt.csv", index=False)
    got = tac.melt_gt(*table.read_csv(tmp_path / "gt.csv"))
    want = jac.melt_gt(pd.read_csv(tmp_path / "gt.csv"))
    assert got == want.to_dict("records")
    with pytest.raises(ValueError):
        tac.melt_gt(["uuid", "x"], [])
    pd.DataFrame({"case_id": ["A", "B", "C", "A"],
                  "frame_idx": [10, 150, 300, 139],
                  "ac_mm": [99.0, 111.25, 96.0, np.nan]}).to_csv(
        tmp_path / "p.csv", index=False)
    got = tac.read_pred(tmp_path / "p.csv", "m", fps=140)
    want = jac.read_pred(tmp_path / "p.csv", "m", fps=140)
    assert [{k: v for k, v in r.items() if k != "ac_mm"} for r in got] == \
        want.drop(columns="ac_mm").to_dict("records")
    np.testing.assert_array_equal(table.column(got, "ac_mm"),
                                  want["ac_mm"].to_numpy(float))
    np.testing.assert_array_equal(tac.frame_to_sweep([0, 139, 140, 841], 140),
                                  jac.frame_to_sweep([0, 139, 140, 841], 140))
    pd.DataFrame({"case_id": ["A"], "frame": [1]}).to_csv(
        tmp_path / "bad.csv", index=False)
    with pytest.raises(ValueError):
        tac.read_pred(tmp_path / "bad.csv", "m", fps=140)


def _ac_inputs(root: Path, seed: int = 3, same_frames: bool = True):
    """A wide GT table of 5 cases x 3 sweeps (two missing) and two models'
    ac_results.csv with frames over the stacked sweeps (the same frames for
    both, else the models match different GT rows)."""
    rng = np.random.default_rng(seed)
    cases = [f"case_{i}" for i in range(5)]
    gt = {"uuid": cases}
    for s in (1, 2, 3):
        col = 80 + rng.random(5) * 200
        if s != 2:
            col[(s + 1) % 5] = np.nan
        gt[f"sweep_{s}_ac_mm"] = col
    pd.DataFrame(gt).to_csv(root / "gt.csv", index=False)
    frames = rng.integers(0, 420, 5)
    for name, noise in (("base.csv", 9.0), ("new.csv", 3.0)):
        if not same_frames:
            frames = rng.integers(0, 420, 5)
        gtv = [gt[f"sweep_{f // 140 + 1}_ac_mm"][i]
               for i, f in enumerate(frames)]
        pd.DataFrame({"case_id": cases, "frame_idx": frames,
                      "ac_mm": np.nan_to_num(gtv, nan=150.0)
                      + rng.standard_normal(5) * noise}).to_csv(
            root / name, index=False)


@pytest.mark.parametrize("names,same_frames", [
    (("baseline", "attention_aspp_unet"), True),
    (("zeta", "alpha"), True),
    (("baseline", "attention_aspp_unet"), False)])
def test_analyze_ac_writes_jax_files(tmp_path, names, same_frames):
    _ac_inputs(tmp_path, same_frames=same_frames)
    res = {}
    for name, mod in (("port", tac), ("jax", jac)):
        res[name] = mod.analyze_ac(tmp_path / "gt.csv", tmp_path / "base.csv",
                                   tmp_path / "new.csv", tmp_path / name,
                                   model_names=names, make_plots=False,
                                   log=quiet)
    for f in ("merged_ac_values.csv", "metrics.csv"):
        assert_csv_equal(tmp_path / "port" / f, tmp_path / "jax" / f)
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    if same_frames:            # paired errors: the tests are written
        assert (tmp_path / "port/stats.txt").read_text() == \
            (tmp_path / "jax/stats.txt").read_text()
    metrics = res["jax"]["metrics"]
    assert [r["model"] for r in res["port"]["metrics"]] == \
        sorted(names) == metrics.index.tolist()
    # pandas' CSV parser is not round-trip exact: the errors, and with them
    # the statistics, agree to 1e-12
    assert res["port"]["stats"].keys() == res["jax"]["stats"].keys()
    for k, v in res["jax"]["stats"].items():
        assert res["port"]["stats"][k] == pytest.approx(v, rel=1e-12)


def test_ac_helpers_equal_jax():
    rng = np.random.default_rng(8)
    a, b = rng.random(9), rng.random(9)
    assert tac.paired_tests(a, b) == jac.paired_tests(a, b)
    assert tac.paired_tests(a, b[:5]) == jac.paired_tests(a, b[:5]) == {}
    gt_long = [{"case_id": "A", "sweep_idx": 1, "gt_ac_mm": 0.0},
               {"case_id": "A", "sweep_idx": 2, "gt_ac_mm": 120.0},
               {"case_id": "B", "sweep_idx": 2, "gt_ac_mm": 100.0}]
    preds = [[{"case_id": "B", "frame_idx": 150, "ac_mm": 97.0,
               "sweep_idx": 2, "model": "m"},
              {"case_id": "A", "frame_idx": 3, "ac_mm": 118.0,
               "sweep_idx": 1, "model": "m"},
              {"case_id": "A", "frame_idx": 140, "ac_mm": 118.0,
               "sweep_idx": 2, "model": "m"}],
             [{"case_id": "C", "frame_idx": 3, "ac_mm": 1.0,
               "sweep_idx": 1, "model": "n"}]]
    got = tac.match_predictions(gt_long, preds)
    want = jac.match_predictions(pd.DataFrame(gt_long),
                                 [pd.DataFrame(p) for p in preds])
    assert list(got[0]) == list(want.columns) == list(tac.MERGED_COLUMNS)
    assert [r["gt_ac_mm"] for r in got] == want["gt_ac_mm"].tolist()
    np.testing.assert_array_equal(table.column(got, "ape_%"),
                                  want["ape_%"].to_numpy(float))   # inf
    assert tac.error_table(got) == [
        {"model": m, **r} for m, r in jac.error_table(want).to_dict(
            "index").items()]
    with pytest.raises(RuntimeError):
        tac.match_predictions(gt_long, [preds[1]])
    with pytest.raises(ValueError, match="duplicated join key"):
        tac.match_predictions(gt_long + gt_long[:1], preds)


def test_render_worst_cases_equal_jax(eval_dirs, tmp_path):
    root, _ = eval_dirs
    jseg.evaluate_directories(root / "gt", root / "base", root / "new",
                              out_csv=tmp_path / "seg_eval.csv", log=quiet)
    assert tvis.read_seg_eval(tmp_path / "seg_eval.csv") == \
        jvis.read_seg_eval(tmp_path / "seg_eval.csv")
    n = {}
    for name, mod in (("port", tvis), ("jax", jvis)):
        n[name] = mod.render_worst_cases(
            tmp_path / "seg_eval.csv", root / "gt", root / "base",
            root / "new", tmp_path / name, img_dir=root / "img", top=3,
            log=quiet)
    assert n["port"] == n["jax"] == 3
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    for f in _files(tmp_path / "port"):
        if f.endswith("_overlay.png"):
            assert (tmp_path / "port" / f).read_bytes() == \
                (tmp_path / "jax" / f).read_bytes()


def _flat_dataset(root: Path):
    rng = np.random.default_rng(6)
    for split, n in (("train", 7), ("val", 3)):
        for i in range(n):
            case = f"case{i % 3:02d}" if split == "train" else f"v-{i}"
            img = (rng.random((12, 12)) * 255).astype(np.uint8)
            msk = np.zeros((12, 12), np.uint8)
            if i % 2 == 0:
                msk[3:8, 3:8] = 255
            write_gray_png(root / split / "images" / f"{case}_s{i:03d}.png",
                           img)
            write_gray_png(root / split / "masks" / f"{case}_s{i:03d}.png",
                           msk)
    write_gray_png(root / "train/images/orphan_s001.png",
                   np.zeros((12, 12), np.uint8))      # no mask: skipped


def _records(df):
    return df.to_dict("records") if len(df) else []


def test_report_loaders_equal_jax(tmp_path):
    _flat_dataset(tmp_path / "flat")
    for split_name in (None, "all"):
        root = tmp_path / "flat" / ("train" if split_name else "")
        assert trep.load_flat_images_masks(
            root, split_name_override=split_name) == _records(
            jrep.load_flat_images_masks(root, split_name_override=split_name))
    for sp, cl in (("train", "pos"), ("train", "neg"), ("val", "pos")):
        write_gray_png(tmp_path / "dirs" / sp / cl / f"c-{sp}_{cl}1.png",
                       np.zeros((4, 4), np.uint8))
    assert trep.load_from_directory(tmp_path / "dirs") == _records(
        jrep.load_from_directory(tmp_path / "dirs"))
    as_dict = tmp_path / "val_set" / "frame_indices.json"
    as_dict.parent.mkdir()
    as_dict.write_text(json.dumps({"caseA": {"pos": [1, 2], "neg": [7]},
                                   "caseB": {"neg": [3]}}))
    as_list = tmp_path / "frame_list.json"
    as_list.write_text(json.dumps([
        {"split": "Train", "label": 1, "case": "a", "path": "a_1.png"},
        {"subset": "val", "cls": "neg", "file": "b_2.png"},
        {"label": "foreground", "study_id": "s9", "filename": "x.png"}]))
    for p in (as_dict, as_list):
        assert trep.load_from_frame_index(p) == _records(
            jrep.load_from_frame_index(p))


def test_dataset_reports_write_jax_files(tmp_path):
    _flat_dataset(tmp_path / "flat")
    rows = trep.load_flat_images_masks(tmp_path / "flat")
    trep.make_dataset_reports(rows, tmp_path / "port", log=quiet)
    jrep.make_dataset_reports(jrep.load_flat_images_masks(tmp_path / "flat"),
                              tmp_path / "jax", log=quiet)
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    for f in ("per_case_stats.csv", "split_stats.csv"):
        assert_csv_equal(tmp_path / "port" / f, tmp_path / "jax" / f)
    assert (tmp_path / "port/latex_table_split_stats.tex").read_text() == \
        (tmp_path / "jax/latex_table_split_stats.tex").read_text()
    per_case, summary = trep.summarize(rows)
    jper, jsum = jrep.summarize(pd.DataFrame(rows))
    assert per_case == _records(jper)
    assert summary == _records(jsum)


def _seg_eval_pair(root: Path):
    rng = np.random.default_rng(12)
    n = 9
    df = pd.DataFrame({
        "case": [_seeded_uuid(rng) for _ in range(n)],
        "dice_new": rng.random(n), "iou_new": rng.random(n),
        "hd95_new_px": rng.random(n) * 9,
        "dice_base": rng.random(n), "iou_base": rng.random(n),
        "hd95_base_px": rng.random(n) * 9})
    df.loc[2, "hd95_new_px"] = np.nan
    for stem, a, b in (("dice", "dice_new", "dice_base"),
                       ("iou", "iou_new", "iou_base"),
                       ("hd95", "hd95_new_px", "hd95_base_px")):
        df[f"{stem}_diff"] = df[a] - df[b]
    df.to_csv(root / "with.csv", index=False)
    other = df.sample(frac=1.0, random_state=1).iloc[1:]
    other = other.assign(dice_new=other["dice_new"] * 0.9)
    other.to_csv(root / "without.csv", index=False)


@pytest.mark.parametrize("px2mm", [1.0, 0.28])
def test_seg_eval_summary_equal_jax(tmp_path, px2mm):
    _seg_eval_pair(tmp_path)
    got = trep.seg_eval_summary(tmp_path / "with.csv", px2mm, log=quiet)
    (tmp_path / "seg_stats.csv").rename(tmp_path / "port.csv")
    want = jrep.seg_eval_summary(tmp_path / "with.csv", px2mm, log=quiet)
    assert [r["metric"] for r in got] == want["metric"].tolist()
    assert_csv_equal(tmp_path / "port.csv", tmp_path / "seg_stats.csv")


def test_attention_comparison_equal_jax(tmp_path):
    _seg_eval_pair(tmp_path)
    for name, mod in (("port", trep), ("jax", jrep)):
        mod.attention_comparison(tmp_path / "with.csv",
                                 tmp_path / "without.csv", tmp_path / name,
                                 log=quiet)
    assert_csv_equal(tmp_path / "port/attention_comparison.csv",
                     tmp_path / "jax/attention_comparison.csv")
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")


def test_tables_read_and_write_as_pandas(tmp_path):
    """The table helpers against pandas itself: type inference, the float
    and NaN formatting, quoting."""
    df = pd.DataFrame({"a": [0.1 + 0.2, 1 / 3, 1e-20, 2.0, np.nan, np.inf],
                       "b": ["x", "y,z", None, 'q"', "7", "8"],
                       "c": [1, 2, 3, 4, 5, 6],
                       "d": ["007", "8", "9", "10", "11", "12"]})
    df.to_csv(tmp_path / "pd.csv", index=False)
    cols, rows = table.read_csv(tmp_path / "pd.csv")
    back = pd.read_csv(tmp_path / "pd.csv")
    table.write_csv(tmp_path / "t.csv", cols, rows)
    back.to_csv(tmp_path / "pd2.csv", index=False)
    # pandas' own parser is not round-trip exact (0.30000000000000004 reads
    # back as 0.3): the numbers agree within 1e-12
    assert_csv_equal(tmp_path / "t.csv", tmp_path / "pd2.csv")
    assert [type(r["c"]) for r in rows] == [int] * 6
    assert rows[0]["a"] == 0.1 + 0.2
    assert rows[0]["d"] == 7 and rows[2]["b"] is None


@pytest.mark.parametrize("kind", ["str", "int", "two keys"])
def test_inner_join_order_equals_pandas(kind):
    """``table.inner_join`` gives the row pairs of pandas' inner merge in
    pandas' order, on 100 random key sets per kind with unique right keys:
    duplicated and missing keys on the left, sorted and unsorted sides; a
    duplicated right key raises."""
    rng = np.random.default_rng({"str": 0, "int": 1, "two keys": 2}[kind])
    pool = [(f,) if kind != "two keys" else (f, s)
            for f in (("A", "B", "C", "D") if kind != "int" else range(5))
            for s in ((1, 2) if kind == "two keys" else (0,))]
    for _ in range(100):
        left = [pool[int(k)] for k in rng.integers(len(pool),
                                                   size=rng.integers(1, 12))]
        right = [pool[int(k)] for k in rng.permutation(len(pool))[
            :rng.integers(1, len(pool) + 1)]]
        if rng.random() < 0.3:
            left.sort()
        if rng.random() < 0.3:
            right.sort()
        cols = ["k0", "k1"][:len(left[0])]
        ldf = pd.DataFrame(left, columns=cols).assign(li=range(len(left)))
        rdf = pd.DataFrame(right, columns=cols).assign(ri=range(len(right)))
        m = ldf.merge(rdf, on=cols, how="inner")
        assert table.inner_join(left, right) == \
            list(zip(m["li"].tolist(), m["ri"].tolist()))
        with pytest.raises(ValueError, match="duplicated join key"):
            table.inner_join(left, right + right[:1])
