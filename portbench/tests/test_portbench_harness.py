"""CPU tests of the benchmark's harness: the loader finds a cell, a traffic
mix and a metric from added files alone; the metric arithmetic on synthetic
stamps and trace events; nothing the command imports loads JAX or the JAX
package, and the reference loads nothing of the program."""

import json
import math
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import harness, trace  # noqa: E402
from portbench.harness import Record  # noqa: E402


def _copy_root(tmp_path: Path) -> Path:
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    return tmp_path


def test_loader_finds_a_cell_from_added_files_alone(tmp_path):
    root = _copy_root(tmp_path)
    base = root / "portbench"
    bench = json.loads((root / "BENCHMARK.json").read_text())
    before = {p: p.read_bytes() for p in base.rglob("*") if p.is_file()}

    # a new traffic mix, its cell, its limits and a new per-layer metric,
    # each a file of its own plus entries in BENCHMARK.json
    mix = json.loads((base / "traffic" / "direct_tta_sweep140.json")
                     .read_text())
    mix.update(frames_per_sweep=280, in_flight=1)
    (base / "traffic" / "direct_tta_sweep280.json").write_text(
        json.dumps(mix))
    (base / "limits" / "attaspp-direct-tta-sweep280.json").write_text(
        json.dumps({"mask_px": 0.5}))
    (base / "metrics" / "frames_per_request.py").write_text(
        "def read(ctx):\n    return float(ctx['served'][0].frames)\n")
    bench["workloads"].append({
        "name": "attaspp-direct-tta-sweep280", "config": "attaspp_b48_512",
        "traffic": "direct_tta_sweep280", "chips": 1, "why": "a test cell"})
    bench["per_layer"].append({
        "name": "frames_per_request", "unit": "frames", "better": "higher",
        "source": "program_counter", "layer": "engine",
        "moves": "served_frames_per_s",
        "workloads": ["attaspp-direct-tta-sweep280"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = harness.find_cell("attaspp-direct-tta-sweep280", root)
    assert cell.traffic["frames_per_sweep"] == 280
    assert cell.limits == {"mask_px": 0.5}
    assert cell.config["name"] == "attaspp_b48_512"
    assert [m["name"] for m in cell.end_to_end] == ["setup_s"]
    assert [m["name"] for m in cell.per_layer] == ["frames_per_request"]
    reader = harness.load_module(base / "metrics" / "frames_per_request.py")
    assert reader.read({"served": [Record(0, 0, 280)]}) == 280.0
    # the existing cells are found as before, and no existing file changed
    old = harness.find_cell("attaspp-cascade-case840", root)
    assert {m["name"] for m in old.end_to_end} == {
        "case_frames_per_s", "case_latency_p95_s", "setup_s"}
    for p, data in before.items():
        assert p.read_bytes() == data, p


def test_every_cell_of_the_benchmark_loads():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = harness.find_cell(w["name"])
        assert cell.end_to_end and cell.per_layer
        assert "setup_s" in {m["name"] for m in cell.end_to_end}
        for m in cell.per_layer + cell.end_to_end:
            assert (cell.base / "metrics" / f"{m['name']}.py").exists()
        work = cell.config_mod.request_work(cell.config, cell.traffic)
        assert work["flops"] > 0 and work["k2_stacks"]


def _records(lat, frames=140, t0=100.0):
    recs = []
    for k, l in enumerate(lat):
        r = Record(k, k % 3, frames)
        r.t_submit, r.t_submitted = t0 + k, t0 + k + 0.01
        r.t_collect, r.t_done = t0 + k + 0.5, t0 + k + l
        recs.append(r)
    return recs


def test_rate_tail_and_host_means_from_stamps():
    m = lambda n: harness.load_module(  # noqa: E731
        harness.PKG / "metrics" / f"{n}.py")
    lat = [0.5 + 0.01 * i for i in range(200)]
    recs = _records(lat)
    span = recs[-1].t_done - 100.0
    ctx = {"served": recs, "records": recs, "span": span,
           "counters": ({"exact_repeats": 3}, {"exact_repeats": 53}),
           "work": {"flops": 3.0e12}, "setup_s": 12.5}
    assert m("served_frames_per_s").read(ctx) == 200 * 140 / span
    assert m("case_latency_p95_s").read(ctx) == pytest.approx(
        float(np.percentile(lat, 95)), rel=1e-12)
    assert m("case_frames_per_s").read(ctx) == 200 * 140 / span
    assert m("host_submit_ms.case").read(ctx) == pytest.approx(10.0)
    assert m("host_submit_ms.sweep").read(ctx) == pytest.approx(10.0)
    assert m("host_collect_ms.case").read(ctx) == pytest.approx(
        1e3 * (np.mean(lat) - 0.5))
    assert m("exact_repeat_share").read(ctx) == pytest.approx(25.0)
    assert m("mfu.serve").read(ctx) == pytest.approx(
        100 * 200 * 3.0e12 / span / 989e12)
    assert m("mfu.case").read(ctx) == m("mfu.serve").read(ctx)
    assert m("setup_s").read(ctx) == 12.5
    assert m("case_latency_p95_s").read({**ctx, "served": []}) is None


@pytest.mark.parametrize("drain", [False, True])
def test_the_window_counts_by_its_closing_rule(drain):
    """By default only requests completed inside the deadline count, over
    the span to the last of them; a draining window counts every request
    the loop sent, over the span to the last collect."""
    recs = _records([0.5] * 12, t0=100.0)   # done at 100.5, 101.5, ...
    recs[3].ok = False
    served, span = harness.window(recs, 100.0, 8.0, drain)
    if drain:
        assert [r.k for r in served] == [k for k in range(12) if k != 3]
        assert span == pytest.approx(11.5)
    else:
        assert [r.k for r in served] == [0, 1, 2, 4, 5, 6, 7]
        assert span == pytest.approx(7.5)


def test_idle_union_gaps_and_rooflines_from_trace_events():
    kernels = [("fused_double_cbr_wgmma_kernel", 0.10, 0.30),
               ("fused_double_cbr_kernel", 0.25, 0.40),    # overlaps
               ("clahe_interp_kernel", 0.60, 0.65),
               ("other", 0.90, 1.00)]
    copies = [("Memcpy HtoD (Pageable -> Device)", 0.40, 0.60)]
    host = [("portbench.submit", 0.0, 0.55), ("portbench.collect", 0.55, 1.2)]
    s = trace.summarize(kernels, copies, host, (0.0, 1.2))
    assert s["busy_s"] == pytest.approx(0.30 + 0.05 + 0.10)
    assert s["window_s"] == pytest.approx(1.2)
    # holes in the kernel union: (0, .1) and (.4, .6) while submitting,
    # (.65, .9) and (1.0, 1.2) while collecting; the longest first
    assert [(n, round(d, 9)) for n, d in s["idle_gaps"]] == [
        ("collect", 0.25), ("submit", 0.2), ("collect", 0.2),
        ("submit", 0.1)]
    assert sum(d for _, d in s["idle_gaps"]) == pytest.approx(1.2 - 0.45)
    assert s["copy_s"] == pytest.approx(0.20)
    assert trace.kernel_seconds(s, "fused_double_cbr") == pytest.approx(0.35)
    assert s["device_ops"][0][0] == "fused_double_cbr_wgmma_kernel"

    from portbench import readers as rd

    k1 = harness.load_module(harness.PKG / "metrics" / "k1_roofline.py")
    k2 = harness.load_module(harness.PKG / "metrics" / "k2_roofline.case.py")
    idle = harness.load_module(harness.PKG / "metrics"
                               / "device_idle.serve.py")
    work = {"k1_batches": [(48, 512, 16)], "k2_stacks": [(140, 562, 744,
                                                          (8, 8))]}
    ctx = {"trace": s, "traced": [None, None], "work": work}
    assert k1.read(ctx) == pytest.approx(
        100 * 2 * rd.k1_bound_s(48, 512, 16) / 0.35)
    assert k2.read(ctx) == pytest.approx(
        100 * 2 * rd.k2_bound_s(140, 562, 744) / 0.05)
    assert idle.read(ctx) == pytest.approx(100 * (1 - 0.45 / 1.2))
    # a trace without the kernel gives nothing to read, not 0
    bare = trace.summarize([("other", 0.0, 1.0)], [], [], (0.0, 1.0))
    assert k1.read({**ctx, "trace": bare}) is None
    assert k1.read({**ctx, "trace": None}) is None


def test_k1_bound_matches_the_kernel_table():
    # PERF.md's kernel table: the main set (base_c 48, 512 px, N = 32)
    # bound 6.163 ms, the scout set (16, 128, N = 128) 0.214 ms, K2 on the
    # 140-frame sweep 0.193 ms
    from portbench import readers as rd

    assert rd.k1_bound_s(48, 512, 32) * 1e3 == pytest.approx(6.163, abs=1e-3)
    assert rd.k1_bound_s(16, 128, 128) * 1e3 == pytest.approx(0.214,
                                                              abs=1e-3)
    assert rd.k2_bound_s(140, 562, 744) * 1e3 == pytest.approx(0.193,
                                                               abs=1e-3)


def test_quantile_is_numpys_linear():
    rng = np.random.default_rng(0)
    for n in (1, 2, 7, 200):
        v = rng.random(n).tolist()
        for q in (0.0, 0.5, 0.95, 1.0):
            assert harness.quantile(v, q) == pytest.approx(
                float(np.quantile(v, q)), rel=1e-12)


def _loaded_top_names(code: str):
    out = subprocess.run(
        [sys.executable, "-c", f"import sys, json; sys.path.insert(0, "
                               f"{str(ROOT)!r}); {code}; print(json.dumps("
                               "sorted({m.split('.')[0] for m in "
                               "sys.modules})))"],
        capture_output=True, text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_the_command_loads_no_jax_and_the_reference_none_of_the_program():
    names = _loaded_top_names(
        "import portbench.run, portbench.harness, portbench.control; "
        "from portbench import harness; "
        "[harness.find_cell(w) for w in ('attaspp-cascade-case840', "
        "'nnunet2d-sweep140')]; "
        "import att_aspp_unet_tpu_torch.infer.engine, "
        "att_aspp_unet_tpu_torch.infer.container, "
        "att_aspp_unet_tpu_torch.models")
    assert not names & set(harness.FORBIDDEN), names & set(harness.FORBIDDEN)
    assert "att_aspp_unet_tpu_torch" in names
    ref = _loaded_top_names(
        "import portbench.reference.attaspp, portbench.reference.nnunet, "
        "portbench.reference.ops, portbench.reference.post")
    assert not ref & (set(harness.FORBIDDEN) | {"att_aspp_unet_tpu_torch"})


def test_the_reference_sources_import_nothing_of_the_program():
    for path in (ROOT / "portbench" / "reference").glob("*.py"):
        text = path.read_text()
        assert "att_aspp_unet_tpu" not in text.replace(
            "att_aspp_unet_tpu_torch/", ""), path
        assert "import jax" not in text and "from jax" not in text, path


def test_benchmark_json_keeps_to_the_contract():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    names += [c["name"] for c in bench["configs"]]
    names += [w["name"] for w in bench["workloads"]]
    assert len(names) == len(set(names))
    for n in names:
        assert n[0].isalnum() or n[0] == "_"
        assert len(n) <= 64 and all(c.isalnum() or c in "_.-" for c in n)
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    layers = {m["layer"] for m in bench["per_layer"]}
    perf = (ROOT / "PERF.md").read_text()
    for layer in layers:
        assert f"| {layer} |" in perf, layer
    for c in bench["configs"]:
        assert (ROOT / c["file"]).exists()
    assert not any(math.isnan(float(m.get("bound", 0)))
                   for m in bench["end_to_end"])
