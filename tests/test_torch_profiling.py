"""The port's spans and counters (``utils/profiling.py``) on the CPU: the
no-op outside a profiler session, the span tree each serving path leaves in
a ``torch.profiler`` trace, outputs bit-equal with the profiler on and off,
and ``fixed_point_reads`` against a count of the exact loop's iterations.
Tiny engines as in ``test_torch_serving.py``."""

from collections import Counter

import jax
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from att_aspp_unet_tpu_torch.config import (Config, ModelConfig,
                                            PlainUNetConfig, PredictConfig,
                                            PreprocessConfig)
from att_aspp_unet_tpu_torch.infer import engine as tengine
from att_aspp_unet_tpu_torch.models import PlainConvUNet
from att_aspp_unet_tpu_torch.postprocess import cc
from att_aspp_unet_tpu_torch.utils import profiling

from .test_torch_model import random_variables
from .test_torch_serving import (CASCADE, IMG, SPACING, _data_threshold,
                                 _sweep, _with)
from .test_torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def setup():
    cfg = Config(preprocess=PreprocessConfig(img_size=IMG),
                 model=ModelConfig(base_c=4, compute_dtype="float32"),
                 predict=PredictConfig(frame_batch=4, tta_hflip=True))
    vnp = jax.tree_util.tree_map(np.asarray, random_variables(4, seed=3))
    return cfg, vnp


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def _tree(prof):
    """(name, request or None, name of the nearest enclosing program span or
    None) of every program span in the trace, in start order."""
    def split(ev):
        req = ev.name.partition("#")[2]
        return profiling.name_of(ev.name), int(req) if req else None

    rows = []
    for ev in sorted(prof.events(), key=lambda e: e.time_range.start):
        if profiling.name_of(ev.name) is None:
            continue
        up = ev.cpu_parent
        while up is not None and profiling.name_of(up.name) is None:
            up = up.cpu_parent
        rows.append((*split(ev), None if up is None else split(up)[0]))
    return rows


def _equal(a, b):
    assert (a[0], a[2]) == (b[0], b[2])
    np.testing.assert_array_equal(a[1], b[1])


def test_span_without_profiler_is_the_shared_noop():
    assert profiling.span("submit") is profiling.NOOP
    assert profiling.span("collect", 3) is profiling.NOOP
    before = profiling.counts()
    profiling.count("test_counter")
    profiling.count("test_counter", 4)
    after = profiling.counts()
    assert after["test_counter"] - before.get("test_counter", 0) == 5
    after["test_counter"] = -1                      # counts() is a copy
    assert profiling.counts()["test_counter"] != -1


@pytest.mark.parametrize("name,request_", [("submit", 12), ("upload", None)])
def test_label_and_name_of(name, request_):
    label = profiling.label(name, request_)
    assert label == ("att." + name if request_ is None
                     else f"att.{name}#{request_}")
    assert profiling.name_of(label) == name
    assert profiling.name_of("portbench.submit") is None
    assert profiling.name_of("aten::copy_") is None


def test_span_under_profiler_is_a_named_range():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("outer", 7):
            with profiling.span("inner"):
                torch.ones(2).add_(1)
    assert _tree(prof) == [("outer", 7, None), ("inner", None, "outer")]
    # host ranges of function scope: a user-scope range would be copied onto
    # the device's row over the kernels launched inside it
    assert not any(e.is_user_annotation for e in prof.events()
                   if e.name.startswith(profiling.PREFIX))


SUBMIT = {"direct": ["upload", "preprocess", "forward", "select"],
          "cascade": ["upload", "scout_preprocess", "scout_forward",
                      "scout_rank", "preprocess", "forward", "select"]}


@pytest.mark.parametrize("path", ["direct", "cascade"])
def test_case_spans_per_request_and_outputs_unchanged(setup, path):
    """Two requests in flight, as the harness serves them: each leaves one
    submit and one collect carrying its number, with the path's steps under
    the submit (fixed points under the ranking steps) and the transfer and
    the finish under the collect; frame, mask and AC bit-equal to an
    unprofiled run."""
    cfg, vnp = setup
    if path == "cascade":
        cfg = _with(cfg, **dict(CASCADE, cascade_scouts=4))
    sweeps = [_sweep(7), _sweep(2)]
    thr = _data_threshold(cfg, vnp, sweeps[0])
    eng = tengine.AttAsppEngine(cfg, vnp, device="cpu")
    want = [eng.predict_case(s, SPACING, thr) for s in sweeps]

    def serve():
        handles = [eng.predict_case_submit(s, thr) for s in sweeps]
        return [eng.predict_case_collect(h, SPACING) for h in handles]

    got, prof = _profiled(serve)
    for g, w in zip(got, want):
        _equal(g, w)
    rows = _tree(prof)
    top = [(n, r) for n, r, up in rows if up is None]
    assert top == [("submit", 2), ("submit", 3), ("collect", 2),
                   ("collect", 3)]
    under = Counter((n, up) for n, _, up in rows if n != "fixed_point")
    assert under == Counter(
        {**{(n, "submit"): 2 for n in SUBMIT[path]},
         ("transfer", "collect"): 2, ("finish", "collect"): 2,
         ("submit", None): 2, ("collect", None): 2})
    fixed = {up for n, _, up in rows if n == "fixed_point"}
    assert fixed == ({"select", "scout_rank"} if path == "cascade"
                     else {"select"})


def test_repeat_span_under_collect(setup, monkeypatch):
    """A collect that finds an unsettled record repeats the steps from there
    under ``repeat``: here the cascade's select, with its fixed points."""
    cfg, vnp = setup
    cfg = _with(cfg, **dict(CASCADE, cascade_scouts=4))
    sweep = _sweep(7)
    thr = _data_threshold(cfg, vnp, sweep)
    eng = tengine.AttAsppEngine(cfg, vnp, device="cpu")
    want = eng.predict_case(sweep, SPACING, thr)
    monkeypatch.setattr(tengine.cc, "SPECULATIVE_ITERS", 16)
    eng.speculate = True
    handle = eng.predict_case_submit(sweep, thr)
    handle[0][..., -1] = 2              # the select step's record set
    got, prof = _profiled(lambda: eng.predict_case_collect(handle, SPACING))
    _equal(got, want)
    assert eng.exact_repeats == 1
    rows = [(n, up) for n, _, up in _tree(prof)]
    assert rows[:3] == [("collect", None), ("transfer", "collect"),
                        ("repeat", "collect")]
    assert ("select", "repeat") in rows and ("fixed_point", "select") in rows
    assert rows[-1] == ("finish", "collect")


def test_baseline_spans_and_outputs_unchanged():
    cfg = Config(plain_unet=PlainUNetConfig(
        base_c=4, max_c=16, n_stages=3, patch_size=(32, 32),
        compute_dtype="float32"))
    rng = np.random.default_rng(4)
    sweep = rng.integers(0, 256, (5, 40, 56)).astype(np.uint8)
    sweep[:, 10:30, 12:44] = 240
    eng = tengine.BaselineEngine(
        cfg, PlainConvUNet.from_config(cfg.plain_unet, seed=2), device="cpu")
    want = eng.postprocess(eng.predict(sweep))
    before = profiling.counts().get("postprocess_calls", 0)
    got, prof = _profiled(lambda: eng.postprocess(eng.predict(sweep)))
    assert torch.equal(got, want)
    assert profiling.counts()["postprocess_calls"] == before + 1
    assert [(n, up) for n, _, up in _tree(prof)] == [
        ("predict", None), ("preprocess", "predict"), ("forward", "predict"),
        ("postprocess", None), ("fixed_point", "postprocess"),
        ("fixed_point", "postprocess")]


def _serpentine(rows: int, width: int) -> torch.Tensor:
    """One 4-connected path through ``rows`` horizontal runs joined at
    alternating ends: labels have to travel the whole path."""
    m = torch.zeros((2 * rows - 1, width), dtype=torch.bool)
    m[::2] = True
    for r in range(rows - 1):
        m[2 * r + 1, width - 1 if r % 2 == 0 else 0] = True
    return m


def _exact_iterations(propagate, labels, max_iters):
    """Iterations of the exact loop, counted here: each one reads a check."""
    for k in range(1, max_iters + 1):
        new = propagate(labels)
        if torch.equal(new, labels):
            return k
        labels = new
    return max_iters


@pytest.mark.parametrize("rows,max_iters", [(1, 128), (6, 128), (6, 3)])
def test_fixed_point_reads_count_the_exact_loop(rows, max_iters):
    fg = _serpentine(rows, 9)[None]
    flat = torch.arange(1, fg[0].numel() + 1).reshape(fg.shape[1:])
    labels = torch.where(fg, flat, torch.full((), cc.INF))
    propagate = cc.make_propagate(fg, 4)
    want = _exact_iterations(propagate, labels, max_iters)
    assert (want > 2) == (rows > 1)
    before = profiling.counts().get("fixed_point_reads", 0)
    out = cc.fixed_point(propagate, labels, max_iters)
    assert profiling.counts()["fixed_point_reads"] - before == want
    if max_iters == 128:
        assert int(out[fg].max()) == int(out[fg].min())   # one component
        with cc.speculative():                 # reads nothing on the host
            cc.fixed_point(propagate, labels, max_iters)
        assert profiling.counts()["fixed_point_reads"] - before == want
