"""Readings of the program's spans and counters in traced windows of a cell,
one window per seed, in one process (the system built once):

    python3 portbench/span_probe.py --workload <name> --seeds 11,12,13
        [--requests N]

Per seed: the cell's inputs, its warm-up, then ``--requests`` requests (the
traffic's ``trace_requests`` by default) served by ``harness.serve`` with its
ranges under ``torch.profiler``, as ``--trace 1`` traces them.  Prints one
JSON line per seed: the traced window's mean submit and collect on the host
clock, ``trace.summarize``'s idle share, the readers of ``spans.py``
(``upload_ms``, ``launch_ms``, ``idle_in_upload``, ``collect_wait_ms``,
``finish_ms``, ``postprocess_ms``), ``span_s``, ``idle_s_by_span``, the
labelled ``idle_gaps``, the program's counters, and two checks of the shared
clock: ``idle_s_by_span`` against ``window_s - busy_s``, and the share of
requests whose pageable host-to-device copies all lie inside the request's
``upload`` span on the host, within 0.1 ms, with each span's offsets.  Not run by the benchmark's
runs; on a program without spans the span readings are null.
"""

import argparse
import bisect
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

PAGEABLE_HTOD = "Memcpy HtoD (Pageable"
TOLERANCE_S = 1e-4


def uploads_holding_their_copies(copies, spans):
    """(requests whose pageable host-to-device copies, each given to the
    last ``upload`` span opened by its start, all lie inside that span
    within ``TOLERANCE_S``, requests with an ``upload`` span, copies that
    start before every ``upload`` span, and per ``upload`` span the ms from
    its start to its first copy's start and from its end to its last copy's
    end, or None without a copy)."""
    from portbench.spans import span_name

    ups = sorted((a, b) for n, a, b in spans if span_name(n) == "upload")
    starts = [a for a, _ in ups]
    given = [[] for _ in ups]
    before = 0
    for name, a, b in copies:
        if not name.startswith(PAGEABLE_HTOD):
            continue
        k = bisect.bisect_right(starts, a + TOLERANCE_S) - 1
        if k < 0:
            before += 1
        else:
            given[k].append((a, b))
    held = sum(bool(g) and all(a >= s - TOLERANCE_S and b <= e + TOLERANCE_S
                               for a, b in g)
               for g, (s, e) in zip(given, ups))
    offsets = [[1e3 * (min(a for a, _ in g) - s),
                1e3 * (max(b for _, b in g) - e)] if g else None
               for g, (s, e) in zip(given, ups)]
    return held, len(ups), before, offsets


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--requests", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    from torch.profiler import ProfilerActivity, profile

    from portbench import harness, readers, spans, trace

    if not torch.cuda.is_available():
        harness.log("no card")
        return 2
    torch.set_num_threads(4)
    cell = harness.find_cell(args.workload)
    harness.log(f"card {harness.power_limit()}, torch {torch.__version__}")
    dev = torch.device("cuda:0")
    traffic = cell.traffic
    system = cell.config_mod.build(cell.config, traffic, dev)
    depth = int(traffic["in_flight"])
    count = args.requests or int(traffic["trace_requests"])
    try:
        from att_aspp_unet_tpu_torch.utils.profiling import counts
    except ImportError:
        counts = dict
    for seed in (int(s) for s in args.seeds.split(",")):
        inputs = harness.make_inputs(traffic, seed, dev)
        harness.serve(system, inputs, depth,
                      count=int(traffic["warmup_requests"]))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with torch.profiler.record_function(trace.WINDOW):
                _, records = harness.serve(system, inputs, depth, count=count,
                                           ranges=True)
                torch.cuda.synchronize()
        t = time.perf_counter()
        raw = spans.collect(prof)
        s = spans.summarize(**raw)
        harness.log(f"seed {seed}: trace of {len(records)} requests read in "
                    f"{time.perf_counter() - t:.1f} s")
        ctx = {"trace": s, "traced": records, "records": records}
        idle = s["window_s"] - s["busy_s"]
        held, ups, early, offsets = uploads_holding_their_copies(
            raw["copies"], raw["spans"])
        print(json.dumps({
            "workload": args.workload, "seed": seed,
            "requests": len(records),
            "traced_host_submit_ms": readers.host_submit_ms(ctx),
            "traced_host_collect_ms": readers.host_collect_ms(ctx),
            "device_idle": readers.device_idle(ctx),
            **{f.__name__: f(ctx) for f in (
                spans.upload_ms, spans.launch_ms, spans.idle_in_upload,
                spans.collect_wait_ms, spans.finish_ms,
                spans.postprocess_ms)},
            "window_s": s["window_s"], "busy_s": s["busy_s"],
            "idle_split_error_s": sum(s["idle_s_by_span"].values()) - idle,
            "uploads_holding_their_copies": [held, ups],
            "copies_before_any_upload": early,
            "upload_copy_offsets_ms": offsets,
            "span_s": s["span_s"], "idle_s_by_span": s["idle_s_by_span"],
            "idle_gaps": s["idle_gaps"], "counters": counts()}), flush=True)
    system.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
