"""The benchmark's driver: finds a cell by its name in ``BENCHMARK.json``,
builds the program's system under test from the cell's configuration, makes
the cell's inputs on the device, warms up, serves the traffic for the
measured window, optionally traces a second window, judges what the timed
path returned against the plain reference, and prints the result line.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by name:

- ``BENCHMARK.json``'s ``configs[].file`` (``configs/<name>.json``) and the
  module beside it (``configs/<name>.py``): ``build(cfg, traffic, device,
  control=False)`` -> a system with ``submit(host_input)``,
  ``collect(handle, keep)``, ``counters()`` and ``close()``;
  ``request_work(cfg, traffic)`` -> the work one request needs, whatever
  computes it (``flops`` of its convs, ``k1_batches`` and ``k2_stacks``:
  the shapes the kernels' roofline readers count); ``judge(cfg, traffic,
  inputs, judged, device)`` -> the compared numbers;
- ``traffic/<name>.json``: the request shape (sweeps per request, frames per
  sweep, frame size), the distinct inputs cycled (made from the run's seed,
  or, where ``content_seed`` is given, the same pool for every seed served
  in an order drawn from the run's seed), the loop (``in_flight``:
  request i + in_flight is submitted before request i is collected), the
  program path's settings, the warm-up and traced request counts, how
  many requests are judged, and how the window closes (``window``:
  ``"drain"`` counts every request submitted before the deadline, over the
  time until the last of them is collected; otherwise only the requests
  completed inside the deadline count);
- ``limits/<cell>.json``: the limit of each compared number;
- ``metrics/<name>.py``: ``read(ctx)`` -> the metric's value, or None where
  the run gives it nothing to read.
"""

from __future__ import annotations

import importlib.util
import json
import math
import random
import subprocess
import sys
import time
import traceback
from collections import deque
from contextlib import nullcontext
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
# top-level module names that no run may load (the JAX package, by its whole
# name: the port's name begins with it)
FORBIDDEN = ("jax", "jaxlib", "flax", "att_aspp_unet_tpu")


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def load_module(path: Path):
    """The module in ``path``, imported under a name of its own."""
    name = "portbench_file_" + "".join(c if c.isalnum() else "_"
                                       for c in str(path.resolve()))
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    base: Path                   # the benchmark's folder
    chips: int
    config: Dict[str, Any]
    config_mod: Any
    traffic: Dict[str, Any]
    limits: Dict[str, float]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]


def _reports(metric: Dict[str, Any], cell: str, reported) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return reported is None or metric["moves"] in reported


def find_cell(workload: str, root: Path = ROOT) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json`` with its files."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    base = root / bench["paths"][0]
    try:
        w = next(w for w in bench["workloads"] if w["name"] == workload)
    except StopIteration:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json") \
            from None
    entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    cfg_path = root / entry["file"]
    e2e = [m for m in bench["end_to_end"] if _reports(m, workload, None)]
    names = {m["name"] for m in e2e}
    return Cell(
        name=workload, base=base, chips=int(w["chips"]),
        config=json.loads(cfg_path.read_text()),
        config_mod=load_module(cfg_path.with_suffix(".py")),
        traffic=json.loads((base / "traffic" / f"{w['traffic']}.json")
                           .read_text()),
        limits=json.loads((base / "limits" / f"{workload}.json").read_text()),
        end_to_end=e2e,
        per_layer=[m for m in bench["per_layer"]
                   if _reports(m, workload, names)])


# ------------------------------------------------------------------ inputs


def make_inputs(traffic: Dict[str, Any], seed: int, device) -> List:
    """The cell's distinct requests as pageable host arrays (a served
    request arrives from the host), made on ``device`` from ``seed``.

    Where the traffic gives ``content_seed``, the inputs are made from it,
    and ``seed`` only draws the order they are served in: every seed then
    serves the same work, for a path whose time follows the content."""
    from .inputs.sweeps import make_sweep, sub_seed
    import torch

    pool = traffic.get("content_seed")
    base = seed if pool is None else int(pool)
    per = int(traffic["sweeps_per_request"])
    n, H, W = (int(traffic[k]) for k in ("frames_per_sweep", "height",
                                         "width"))
    out = []
    for d in range(int(traffic["distinct"])):
        parts = [make_sweep(n, H, W, sub_seed(base, d * per + s), device)[0]
                 for s in range(per)]
        out.append(torch.cat(parts).cpu().numpy())
    if pool is not None:
        random.Random(f"order {seed}").shuffle(out)
    return out


def judged_inputs(traffic: Dict[str, Any], seed: int) -> frozenset:
    """The distinct inputs whose requests are judged: ``judge_inputs`` of
    them drawn from the seed, or all."""
    n = int(traffic["distinct"])
    k = int(traffic.get("judge_inputs") or n)
    return frozenset(random.Random(seed).sample(range(n), min(k, n)))


# -------------------------------------------------------------------- loop


@dataclass
class Record:
    k: int                      # request number in its phase
    input: int                  # which distinct input it served
    frames: int
    t_submit: float = 0.0
    t_submitted: float = 0.0
    t_collect: float = 0.0
    t_done: float = 0.0
    ok: bool = True
    out: Any = None

    @property
    def latency(self) -> float:
        return self.t_done - self.t_submit


def _range(name: str, on: bool):
    if not on:
        return nullcontext()
    import torch

    return torch.profiler.record_function(f"portbench.{name}")


def serve(system, inputs: List, in_flight: int, seconds: float = math.inf,
          count: Optional[int] = None, keep=frozenset(),
          ranges: bool = False):
    """Closed loop: ``in_flight`` requests submitted ahead, then per step
    submit one more and collect the oldest, until ``seconds`` have passed or
    ``count`` requests were submitted; then collect what is left.  The
    system keeps everything it returns for requests of the inputs in
    ``keep``.  Returns (t0, records in completion order)."""
    frames = int(inputs[0].shape[0])
    pending: deque = deque()
    records: List[Record] = []
    t0 = time.perf_counter()
    deadline = t0 + seconds
    k = 0

    def more() -> bool:
        return (count is None or k < count) and \
            time.perf_counter() < deadline

    def submit():
        nonlocal k
        rec = Record(k, k % len(inputs), frames)
        rec.t_submit = time.perf_counter()
        with _range("submit", ranges):
            handle = system.submit(inputs[rec.input])
        rec.t_submitted = time.perf_counter()
        pending.append((rec, handle))
        k += 1

    for _ in range(in_flight):
        if more():
            submit()
    while pending:
        if more():
            submit()
        rec, handle = pending.popleft()
        rec.t_collect = time.perf_counter()
        try:
            with _range("collect", ranges):
                rec.out = system.collect(handle, rec.input in keep)
        except Exception:                # a request that fails is counted
            traceback.print_exc()
            rec.ok = False
        rec.t_done = time.perf_counter()
        records.append(rec)
    return t0, records


def window(records: List[Record], t0: float, seconds: float,
           drain: bool = False):
    """The requests that the window's metrics count, and its span.

    By default those completed inside the deadline, over the seconds from
    the first submit to the last of those completions: a request still in
    flight at the deadline adds neither its frames nor its time.  With
    ``drain``, every request submitted before the deadline, over the
    seconds until the last of them was collected: the loop sends nothing
    after the deadline and waits for what it sent, so no request is cut at
    the deadline and a stall at the end still counts as time."""
    deadline = t0 + seconds
    served = [r for r in records if r.ok and (drain or r.t_done <= deadline)]
    span = max((r.t_done for r in served), default=deadline) - t0
    return served, span


def quantile(values: List[float], q: float) -> float:
    """Linear interpolation between the order statistics around
    q * (n - 1) (numpy's default)."""
    v = sorted(values)
    pos = (len(v) - 1) * q
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


# ----------------------------------------------------------------- running


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30).stdout.splitlines()
        return out[0].strip() if out else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def execute(cell: Cell, seed: int, seconds: float, trace: bool, device,
            t_start: float, wrap=None, control: bool = False,
            notes: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """One run of ``cell``; returns the result line as a dict.  ``wrap``
    (tests) wraps the built system; ``control`` serves the cell's
    lower-precision control in the program's place; ``notes``, where given,
    receives every number the judge gave."""
    import torch

    dev = torch.device(device)
    cfg, traffic, mod = cell.config, cell.traffic, cell.config_mod
    stamps = [("imports", time.perf_counter())]
    system = mod.build(cfg, traffic, dev, control=control)
    if wrap is not None:
        system = wrap(system)
    stamps.append(("build", time.perf_counter()))
    inputs = make_inputs(traffic, seed, dev)
    stamps.append(("inputs", time.perf_counter()))
    depth = int(traffic["in_flight"])
    serve(system, inputs, depth, count=int(traffic["warmup_requests"]))
    stamps.append(("warm-up", time.perf_counter()))
    keep = judged_inputs(traffic, seed)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    before = system.counters()
    setup_s = time.perf_counter() - t_start
    log("set-up: " + ", ".join(
        f"{name} {b - a:.2f} s" for (name, b), (_, a)
        in zip(stamps, [("start", t_start)] + stamps)))
    t0, records = serve(system, inputs, depth, seconds=seconds, keep=keep)
    after = system.counters()
    summary, traced = None, []
    if trace:
        summary, traced = _traced(system, inputs, depth,
                                  int(traffic["trace_requests"]))
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    served, span = window(records, t0, seconds,
                          traffic.get("window") == "drain")
    judged = [(r.input, r.out) for r in records if r.ok and r.input in keep]
    system.close()
    del system
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    forbidden = forbidden_modules()
    if forbidden:
        raise SystemExit(f"forbidden modules loaded: {forbidden}")

    work = mod.request_work(cfg, traffic)
    ctx = dict(setup_s=setup_s, span=span, records=records,
               served=served, work=work, counters=(before, after),
               trace=summary, traced=traced)
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in getattr(cell, kind):
        value = load_module(cell.base / "metrics" / f"{m['name']}.py") \
            .read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    if records:
        n = len(records)
        submit = sum(r.t_submitted - r.t_submit for r in records) / n
        collect = sum(r.t_done - r.t_collect for r in records) / n
        log(f"window: {n} requests, {len(served)} counted, span "
            f"{span:.3f} s; mean submit {1e3 * submit:.1f} ms, collect "
            f"{1e3 * collect:.1f} ms")
    t_judge = time.perf_counter()
    numbers = mod.judge(cfg, traffic, inputs, judged, dev) if judged else {}
    log(f"judged {len(judged)} requests in "
        f"{time.perf_counter() - t_judge:.1f} s: {json.dumps(numbers)}")
    if notes is not None:
        notes.update(numbers=numbers, judged=len(judged))
    failed = sum(not r.ok for r in records)
    # a number the judge could not give (or an infinite one) is null in the
    # line and fails
    checks = {n: {"value": v if math.isfinite(v) else None, "limit": lim}
              for n, lim in cell.limits.items()
              for v in [float(numbers.get(n, math.inf))]}
    correct = (failed == 0 and bool(judged) and all(
        c["value"] is not None and c["value"] <= c["limit"]
        for c in checks.values()))
    line = {"correct": correct, "attempted": len(records), "failed": failed,
            "metrics": metrics,
            "device": _device(dev, peak, summary)}
    if summary is not None:
        line["breakdown"] = {"device_ops": summary["device_ops"],
                             "idle_gaps": summary["idle_gaps"]}
    line["checks"] = checks
    return line


def _traced(system, inputs, depth: int, count: int):
    """A second window of ``count`` requests under ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from .trace import WINDOW, from_profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(WINDOW):
            _, records = serve(system, inputs, depth, count=count,
                               ranges=True)
            torch.cuda.synchronize()
    t = time.perf_counter()
    summary = from_profile(prof)
    log(f"trace of {len(records)} requests read in "
        f"{time.perf_counter() - t:.1f} s")
    return summary, records


def _device(dev, peak: int, summary) -> Dict[str, Any]:
    import torch

    if dev.type == "cuda":
        d = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
             "count": 1, "memory_peak_bytes": int(peak)}
    else:
        d = {"platform": "cpu", "kind": "cpu", "count": 1,
             "memory_peak_bytes": 0}
    if summary is not None:
        d["busy_s"] = summary["busy_s"]
        d["window_s"] = summary["window_s"]
    return d


def report(line: Dict[str, Any]) -> None:
    """The compared numbers beside their limits as the last lines on
    stderr, then the result as the last line on stdout."""
    for name, c in line["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(f"correct {line['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
