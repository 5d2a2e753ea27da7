"""The program's own spans in a ``torch.profiler`` trace of the card.

The port opens a range at each layer boundary of its engines, named
``att.<name>`` (``att.<name>#<request>`` on a request's submit and collect;
``att_aspp_unet_tpu_torch/utils/profiling.py``).  Being ranges of the same
profiler session as the harness's ``portbench.<name>`` ranges, they lie on the
clock of the device's activity.  :func:`summarize` is ``trace.summarize``
with them:

- every key of ``trace.summarize``, with its value, except that each label of
  ``idle_gaps`` (same gaps, same durations, same order) is followed by
  ``/<span>``, the innermost program span open at the gap's middle, where
  one is open (``submit/upload``);
- ``span_s``: per span name, [host seconds, count] over the window;
- ``idle_s_by_span``: the window's idle time (no kernel running) split,
  instant by instant, over the innermost program span open at that instant,
  ``"none"`` where none is: the parts sum to ``window_s - busy_s``.

The readers below take a ``ctx`` (``harness.execute``'s) whose ``trace`` is
such a summary, and return None where the trace holds no such span (a
program without them).  The harness does not compute this summary yet:
``trace.from_profile`` keeps only the harness's own ranges.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from portbench import trace

PREFIX = "att."

Triple = Tuple[str, float, float]


def span_name(name: str) -> str:
    """``att.submit#12`` -> ``submit``."""
    return name[len(PREFIX):].split("#")[0]


def innermost(spans: List[Triple], w0: float, w1: float
              ) -> List[Tuple[float, float, Optional[str]]]:
    """``[w0, w1]`` cut at every span boundary, each piece with the name of
    the innermost span open over it (the one opened last; None where none
    is)."""
    edges = sorted({w0, w1} | {t for _, a, b in spans for t in (a, b)
                               if w0 < t < w1})
    starts = sorted(range(len(spans)), key=lambda i: spans[i][1])
    ends = sorted(range(len(spans)), key=lambda i: spans[i][2])
    open_, si, ei, out = set(), 0, 0, []
    for a, b in zip(edges, edges[1:]):
        # the spans open over (a, b): started at or before a, ended after
        while si < len(starts) and spans[starts[si]][1] <= a:
            open_.add(starts[si])
            si += 1
        while ei < len(ends) and spans[ends[ei]][2] <= a:
            open_.discard(ends[ei])
            ei += 1
        inner = max(open_, key=lambda i: (spans[i][1], -spans[i][2]),
                    default=None)
        out.append((a, b, None if inner is None
                    else span_name(spans[inner][0])))
    return out


def _gaps(kernels: List[Triple], w0: float, w1: float):
    """The holes in the kernels' union inside the window, in time order (as
    ``trace.summarize`` finds them)."""
    busy = trace.union([(max(a, w0), min(b, w1)) for _, a, b in kernels
                        if b > w0 and a < w1])
    gaps, t = [], w0
    for a, b in busy + [(w1, w1)]:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    return gaps


def summarize(kernels: List[Triple], copies: List[Triple],
              host: List[Triple], spans: List[Triple],
              window: Tuple[float, float]) -> Dict:
    """``trace.summarize`` of the triples, with the program's ``spans``
    (``att.`` names; see the module's docstring)."""
    w0, w1 = window
    out = trace.summarize(kernels, copies, host, window)
    spans = [s for s in spans if s[2] > w0 and s[1] < w1]
    pieces = innermost(spans, w0, w1)
    gaps = _gaps(kernels, w0, w1)

    span_s: Dict[str, List] = {}
    for name, a, b in spans:
        s = span_s.setdefault(span_name(name), [0.0, 0])
        s[0] += min(b, w1) - max(a, w0)
        s[1] += 1
    idle: Dict[str, float] = defaultdict(float)
    k = 0
    for a, b in gaps:
        while pieces[k][1] <= a:
            k += 1
        j = k
        while j < len(pieces) and pieces[j][0] < b:
            pa, pb, name = pieces[j]
            idle[name or "none"] += min(b, pb) - max(a, pa)
            j += 1

    # the ten longest gaps in trace.summarize's order (a stable sort of the
    # same list by length)
    longest = sorted(gaps, key=lambda g: -(g[1] - g[0]))
    starts = [p[0] for p in pieces]
    labels = []
    for (label, d), (a, b) in zip(out["idle_gaps"], longest):
        mid = (a + b) / 2
        name = pieces[bisect.bisect_right(starts, mid) - 1][2]
        labels.append([f"{label}/{name}" if name else label, d])
    out.update(idle_gaps=labels, span_s=span_s, idle_s_by_span=dict(idle))
    return out


def collect(prof) -> Dict:
    """The triples of a finished ``torch.profiler.profile`` whose window is
    the host range ``portbench.window``: ``kernels``, ``copies``, ``host``
    (the harness's ranges), ``spans`` (the program's) and ``window``, in
    seconds; the arguments of :func:`summarize`."""
    out = {"kernels": [], "copies": [], "host": [], "spans": [],
           "window": None}
    for ev in prof.events():
        tr = ev.time_range
        item = (ev.name, tr.start * 1e-6, tr.end * 1e-6)
        device = trace._is_device(ev)
        if device and ev.name.startswith((trace.HOST_PREFIX, PREFIX)):
            continue                 # the ranges' copies on the device row
        if device:
            out["copies" if ev.name.startswith(trace.COPY_PREFIXES)
                else "kernels"].append(item)
        elif ev.name == trace.WINDOW:
            out["window"] = item[1:]
        elif ev.name.startswith(trace.HOST_PREFIX):
            out["host"].append(item)
        elif ev.name.startswith(PREFIX):
            out["spans"].append(item)
    if out["window"] is None:
        raise RuntimeError(f"the trace holds no {trace.WINDOW} range")
    return out


# ----------------------------------------------------------------- readers


def _per(ctx, name: str, per: str) -> Optional[float]:
    """Host milliseconds of span ``name`` in the traced window per span
    ``per`` (one a request)."""
    s = (ctx.get("trace") or {}).get("span_s", {})
    if name not in s or not s.get(per, [0, 0])[1]:
        return None
    return 1e3 * s[name][0] / s[per][1]


def upload_ms(ctx):
    """Mean host ms of a request's ``upload`` spans (its pageable input
    copied to the card)."""
    return _per(ctx, "upload", "submit")


def launch_ms(ctx):
    """Mean host ms of a request's ``submit`` less its ``upload``: building
    and launching the device half."""
    sub, up = _per(ctx, "submit", "submit"), upload_ms(ctx)
    return None if sub is None or up is None else sub - up


def idle_in_upload(ctx):
    """% of the traced window in which no kernel ran while an ``upload`` was
    the innermost program span."""
    t = ctx.get("trace") or {}
    if "upload" not in t.get("span_s", {}) or not t.get("window_s"):
        return None
    return 100.0 * t["idle_s_by_span"].get("upload", 0.0) / t["window_s"]


def collect_wait_ms(ctx):
    """Mean host ms of a collect's ``transfer``: the wait for the device and
    the one copy of its result."""
    return _per(ctx, "transfer", "collect")


def finish_ms(ctx):
    """Mean host ms of a collect's ``finish`` spans: the exact re-rank and
    the ellipse AC."""
    return _per(ctx, "finish", "collect")


def postprocess_ms(ctx):
    """Mean host ms of the baseline's ``postprocess`` (its 3-D components,
    whose fixed points read the device back)."""
    return _per(ctx, "postprocess", "postprocess")
