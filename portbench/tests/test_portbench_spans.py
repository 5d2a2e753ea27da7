"""CPU tests of the program-span summary (``spans.py``): its arithmetic on
synthetic (name, start, end) triples, its readers on hand-built contexts,
the triples of a real ``torch.profiler`` trace of the harness's loop, the
copy-in-upload check of ``span_probe.py``, and the counter metric
``fixed_point_reads.baseline``."""

import sys
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import harness, spans, trace  # noqa: E402
from portbench.span_probe import uploads_holding_their_copies  # noqa: E402

KERNELS = [("fused_double_cbr_wgmma_kernel", 0.10, 0.40),
           ("clahe_interp_kernel", 0.60, 0.65),
           ("other", 0.90, 1.00)]
COPIES = [("Memcpy HtoD (Pageable -> Device)", 0.02, 0.09)]
HOST = [("portbench.submit", 0.0, 0.55), ("portbench.collect", 0.55, 1.2)]
# two requests' worth of program spans: request 4's upload and launches,
# request 3's collect with its transfer and finish
SPANS = [("att.submit#4", 0.0, 0.55), ("att.upload", 0.01, 0.10),
         ("att.scout_forward", 0.12, 0.50), ("att.fixed_point", 0.20, 0.30),
         ("att.collect#3", 0.56, 1.19), ("att.transfer", 0.57, 0.80),
         ("att.finish", 0.80, 1.10)]
WINDOW = (0.0, 1.2)


def _summary(spans_=SPANS):
    return spans.summarize(KERNELS, COPIES, HOST, spans_, WINDOW)


def test_gap_inside_upload_is_labelled_submit_upload():
    s = _summary()
    # holes in the kernel union, by the harness's range and the innermost
    # program span at the middle: (0, .1) in the upload; (.4, .6) just after
    # scout_forward, in the submit; (.65, .9) in the transfer; (1.0, 1.2)
    # after the finish, in the collect
    assert [(n, round(d, 9)) for n, d in s["idle_gaps"]] == [
        ("collect/transfer", 0.25), ("submit/submit", 0.2),
        ("collect/collect", 0.2), ("submit/upload", 0.1)]


def test_idle_split_sums_to_the_window_idle_time():
    s = _summary()
    parts = s["idle_s_by_span"]
    assert sum(parts.values()) == pytest.approx(
        s["window_s"] - s["busy_s"], abs=1e-12)
    expect = {"upload": 0.09, "submit": 0.01 + 0.05, "scout_forward": 0.10,
              "none": 0.01 + 0.01, "collect": 0.01 + 0.09,
              "transfer": 0.03 + 0.15, "finish": 0.10 + 0.10}
    assert parts.keys() == expect.keys()
    for k, v in expect.items():
        assert parts[k] == pytest.approx(v, abs=1e-12), k


def test_span_seconds_and_counts():
    s = _summary()["span_s"]
    assert s["submit"] == [pytest.approx(0.55), 1]
    assert s["fixed_point"] == [pytest.approx(0.10), 1]
    assert set(s) == {"submit", "upload", "scout_forward", "fixed_point",
                      "collect", "transfer", "finish"}


def test_old_keys_equal_trace_summarize():
    want = trace.summarize(KERNELS, COPIES, HOST, WINDOW)
    bare = _summary([])
    assert {k: bare[k] for k in want} == want
    assert bare["span_s"] == {}
    assert bare["idle_s_by_span"] == {
        "none": pytest.approx(want["window_s"] - want["busy_s"])}
    full = _summary()
    for k in want:
        if k != "idle_gaps":
            assert full[k] == want[k], k
    assert [d for _, d in full["idle_gaps"]] == \
        [d for _, d in want["idle_gaps"]]
    assert [n.split("/")[0] for n, _ in full["idle_gaps"]] == \
        [n for n, _ in want["idle_gaps"]]


def test_innermost_picks_the_last_opened_span():
    pieces = spans.innermost([("att.a", 0.0, 1.0), ("att.b", 0.2, 0.5),
                              ("att.c#1", 0.3, 0.4)], -1.0, 2.0)
    assert pieces == [(-1.0, 0.0, None), (0.0, 0.2, "a"), (0.2, 0.3, "b"),
                      (0.3, 0.4, "c"), (0.4, 0.5, "b"), (0.5, 1.0, "a"),
                      (1.0, 2.0, None)]


def test_readers_on_a_hand_built_ctx():
    s = _summary()
    ctx = {"trace": s}
    assert spans.upload_ms(ctx) == pytest.approx(90.0)
    assert spans.launch_ms(ctx) == pytest.approx(550.0 - 90.0)
    assert spans.idle_in_upload(ctx) == pytest.approx(100 * 0.09 / 1.2)
    assert spans.collect_wait_ms(ctx) == pytest.approx(230.0)
    assert spans.finish_ms(ctx) == pytest.approx(300.0)
    assert spans.postprocess_ms(ctx) is None
    base = _summary([("att.predict", 0.0, 0.5), ("att.postprocess", 0.5, 1.1),
                     ("att.postprocess", 1.1, 1.2)])
    assert spans.postprocess_ms({"trace": base}) == pytest.approx(350.0)
    # a program without spans, or a run without a trace: nothing to read
    bare = {"trace": _summary([])}
    for f in (spans.upload_ms, spans.launch_ms, spans.idle_in_upload,
              spans.collect_wait_ms, spans.finish_ms, spans.postprocess_ms):
        assert f(bare) is None and f({"trace": None}) is None, f.__name__


class _Spanned:
    """A system whose submit and collect open program spans."""

    def __init__(self):
        from att_aspp_unet_tpu_torch.utils.profiling import span

        self.span, self.k = span, 0

    def submit(self, x):
        with self.span("submit", self.k):
            with self.span("upload"):
                y = torch.as_tensor(x) + 1
        self.k += 1
        return self.k - 1, y

    def collect(self, handle, keep):
        with self.span("collect", handle[0]):
            with self.span("transfer"):
                return float(handle[1].sum())


def test_collect_reads_a_real_profile_of_the_loop():
    system = _Spanned()
    inputs = [torch.ones(4, 8, 8).numpy() for _ in range(3)]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(trace.WINDOW):
            _, records = harness.serve(system, inputs, 2, count=3,
                                       ranges=True)
    raw = spans.collect(prof)
    assert len(records) == 3 and raw["kernels"] == []
    assert sorted(n for n, _, _ in raw["host"]) == \
        ["portbench.collect"] * 3 + ["portbench.submit"] * 3
    assert sorted(n for n, _, _ in raw["spans"]) == sorted(
        [f"att.submit#{k}" for k in range(3)]
        + [f"att.collect#{k}" for k in range(3)]
        + ["att.upload"] * 3 + ["att.transfer"] * 3)
    s = spans.summarize(**raw)
    assert s["span_s"]["submit"][1] == 3 and s["busy_s"] == 0.0
    assert sum(s["idle_s_by_span"].values()) == pytest.approx(
        s["window_s"], abs=1e-9)
    assert s["idle_gaps"][0][0].startswith(("between", "submit", "collect"))


def test_copies_held_by_their_upload_spans():
    ups = [("att.upload", 1.0, 1.1), ("att.upload", 2.0, 2.1),
           ("att.upload", 3.0, 3.1)]
    copies = [("Memcpy HtoD (Pageable -> Device)", 1.00005, 1.1),
              ("Memcpy HtoD (Pageable -> Device)", 2.01, 2.05),
              ("Memcpy HtoD (Pageable -> Device)", 2.06, 2.1001),
              ("Memcpy HtoD (Pageable -> Device)", 3.05, 3.2),   # past it
              ("Memcpy DtoH (Device -> Pageable)", 0.5, 0.6),
              ("Memcpy HtoD (Pageable -> Device)", 0.1, 0.2)]    # before
    held, n, before, offsets = uploads_holding_their_copies(copies, ups)
    assert (held, n, before) == (2, 3, 1)
    assert offsets == [pytest.approx([0.05, 0.0]), pytest.approx([10.0, 0.1]),
                       pytest.approx([50.0, 100.0])]
    # a copy that starts just before its span (within the tolerance) is its
    early = [("Memcpy HtoD (Pageable -> Device)", 0.99995, 1.05)]
    assert uploads_holding_their_copies(early, ups[:1])[:3] == (1, 1, 0)
    assert uploads_holding_their_copies([], ups[:1])[3] == [None]


def test_fixed_point_reads_metric_reads_the_program_counters(monkeypatch):
    from att_aspp_unet_tpu_torch.utils import profiling

    metric = harness.load_module(harness.PKG / "metrics"
                                 / "fixed_point_reads.baseline.py")
    monkeypatch.setattr(profiling, "_counts", {})
    assert metric.read({}) is None
    monkeypatch.setattr(profiling, "_counts", {"postprocess_calls": 8,
                                               "fixed_point_reads": 100})
    assert metric.read({}) == pytest.approx(12.5)
