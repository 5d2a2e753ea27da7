"""Reduction of a ``torch.profiler`` trace of the card to what the
per-layer metrics and the result's ``breakdown`` read.

Device activity is every event that the profiler puts on the card.  Kernels
are the events whose names do not start with ``Memcpy`` or ``Memset``;
copies are reported apart.  Busy time is the union of the kernel intervals;
idle gaps are the holes in that union inside the traced window, each named
by the host range (``portbench.<name>``, set by the harness around its calls
into the program) that was open at the gap's middle.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Tuple

COPY_PREFIXES = ("Memcpy", "Memset")
HOST_PREFIX = "portbench."


def _is_device(ev) -> bool:
    return getattr(ev.device_type, "name", str(ev.device_type)) == "CUDA"


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Disjoint sorted cover of the intervals."""
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def summarize(kernels: List[Tuple[str, float, float]],
              copies: List[Tuple[str, float, float]],
              host: List[Tuple[str, float, float]],
              window: Tuple[float, float]) -> Dict:
    """Summary of one traced window from (name, start, end) triples in
    seconds: ``window_s``, ``busy_s`` (kernel union), ``kernel_s`` (device
    seconds by kernel name), ``copy_s``, ``device_ops`` (the ten names with
    the most device time, copies included) and ``idle_gaps`` (the ten
    longest gaps, by host range)."""
    w0, w1 = window
    busy = union([(max(a, w0), min(b, w1)) for _, a, b in kernels
                  if b > w0 and a < w1])
    busy_s = sum(b - a for a, b in busy)
    by_name: Dict[str, float] = defaultdict(float)
    for name, a, b in kernels + copies:
        by_name[name] += b - a
    gaps, t = [], w0
    for a, b in busy + [(w1, w1)]:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    named = []
    for a, b in gaps:
        mid = (a + b) / 2
        label = next((n[len(HOST_PREFIX):] for n, s, e in host
                      if s <= mid <= e), "between")
        named.append((label, b - a))
    named.sort(key=lambda g: -g[1])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])
    return {"window_s": w1 - w0, "busy_s": busy_s,
            "kernel_s": {n: s for n, s in by_name.items()
                         if not n.startswith(COPY_PREFIXES)},
            "copy_s": sum(b - a for _, a, b in copies),
            "device_ops": [[n[:160], s] for n, s in ops[:10]],
            "idle_gaps": [[n, s] for n, s in named[:10]]}


WINDOW = HOST_PREFIX + "window"


def from_profile(prof) -> Dict:
    """:func:`summarize` of a finished ``torch.profiler.profile`` whose
    traced window is the host range ``portbench.window``."""
    kernels, copies, host, window = [], [], [], None
    for ev in prof.events():
        tr = ev.time_range
        item = (ev.name, tr.start * 1e-6, tr.end * 1e-6)
        if _is_device(ev) and ev.name.startswith(HOST_PREFIX):
            continue                 # the ranges' copies on the device row
        if _is_device(ev):
            (copies if ev.name.startswith(COPY_PREFIXES) else kernels) \
                .append(item)
        elif ev.name == WINDOW:
            window = item[1:]
        elif ev.name.startswith(HOST_PREFIX):
            host.append(item)
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW} range")
    return summarize(kernels, copies, host, window)


def kernel_seconds(summary: Dict, needle: str) -> float:
    """Device seconds of the kernels whose names contain ``needle``."""
    return sum(s for n, s in summary["kernel_s"].items() if needle in n)
