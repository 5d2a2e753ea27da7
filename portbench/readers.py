"""The arithmetic of the metric readers in ``metrics/``: each metric file
names one of these as its ``read``, so that one quantity measured in cells
that report different end-to-end metrics (``mfu.serve`` and ``mfu.case``)
is computed once.  ``ctx`` is what ``harness.execute`` gathers: the
window's records and the requests served inside it (``served``), its
``span``, the engine's counters before and after, the work one request
needs, and the trace summary of the traced window with its requests."""

import math

from portbench.harness import quantile
from portbench.peaks import PEAK_BF16_FLOPS, PEAK_F32_FLOPS, bound_s
from portbench.trace import kernel_seconds


def frames_per_s(ctx):
    """Frames of the requests completed inside the window, over the seconds
    from its first submit to the last of those completions."""
    if not ctx["served"]:
        return None
    return sum(r.frames for r in ctx["served"]) / ctx["span"]


def latency_p95_s(ctx):
    """The 95th percentile of submit-to-collect seconds over every request
    completed inside the window."""
    lat = [r.latency for r in ctx["served"]]
    return quantile(lat, 0.95) if lat else None


def host_submit_ms(ctx):
    """Mean host milliseconds of a submit over the window's requests."""
    recs = ctx["records"]
    if not recs:
        return None
    return 1e3 * sum(r.t_submitted - r.t_submit for r in recs) / len(recs)


def host_collect_ms(ctx):
    """Mean host milliseconds of a collect over the window's requests."""
    recs = ctx["records"]
    if not recs:
        return None
    return 1e3 * sum(r.t_done - r.t_collect for r in recs) / len(recs)


def mfu(ctx):
    """Conv FLOPs the requests completed inside the window need, over the
    window's span, in % of the dense bf16 peak."""
    if not ctx["served"]:
        return None
    flops = ctx["work"]["flops"] * len(ctx["served"])
    return 100.0 * flops / ctx["span"] / PEAK_BF16_FLOPS


def device_idle(ctx):
    """% of the traced window in which no kernel ran (copies apart)."""
    t = ctx["trace"]
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def model_pairs(base_c: int, size: int):
    """The eight conv pairs the Attention-ASPP-UNet gives K1 on a ``size``
    input: (Cin, Cmid, Cout, H = W).  A copy of
    ``fused_conv.model_pairs``."""
    c = base_c
    return [(1, c, c, size), (c, 2 * c, 2 * c, size // 2),
            (2 * c, 4 * c, 4 * c, size // 4), (4 * c, 8 * c, 8 * c, size // 8),
            (16 * c, 8 * c, 8 * c, size // 8), (8 * c, 4 * c, 4 * c, size // 4),
            (4 * c, 2 * c, 2 * c, size // 2), (2 * c, c, c, size)]


def k1_bound_s(base_c: int, size: int, n: int) -> float:
    """Roofline-bound seconds of K1's eight pairs on a micro-batch of n
    frames: max(operations / bf16 peak, bytes / HBM bandwidth) per pair,
    with both convs' multiply-adds, the bf16 input, weights and output read
    or written once and the folded BatchNorm's f32 scale and bias."""
    total = 0.0
    for cin, cmid, cout, hw in model_pairs(base_c, size):
        flops = 2.0 * n * hw * hw * 9 * (cin * cmid + cmid * cout)
        nbytes = (2 * (n * cin * hw * hw + 9 * cin * cmid + 9 * cmid * cout
                       + n * cout * hw * hw) + 4 * (2 * cmid + 2 * cout))
        total += bound_s(flops, nbytes, PEAK_BF16_FLOPS)
    return total


def k2_bound_s(n: int, H: int, W: int, grid=(8, 8)) -> float:
    """Roofline-bound seconds of K2 on a stack of n frames: max(7 f32
    operations per pixel / f32 peak, bytes / HBM bandwidth) with its int32
    block pixels, f32 corner LUTs and weights read once and its f32 blend
    written once."""
    ty, tx = int(grid[1]), int(grid[0])
    B = (ty + 1) * (tx + 1)
    P = math.ceil(H / ty) * math.ceil(W / tx)
    nbytes = 4 * (n * B * P + n * B * 256 * 4 + P * 4 + n * B * P)
    return bound_s(7.0 * n * B * P, nbytes, PEAK_F32_FLOPS)


def k1_roofline(ctx):
    """K1's bound for the traced requests' work over the device seconds of
    its kernels (``fused_double_cbr``), in %."""
    s = ctx["trace"] and kernel_seconds(ctx["trace"], "fused_double_cbr")
    if not s:
        return None
    need = sum(k1_bound_s(*b) for b in ctx["work"]["k1_batches"])
    return 100.0 * need * len(ctx["traced"]) / s


def k2_roofline(ctx):
    """K2's bound for the enhancements the traced requests need over the
    device seconds of its kernel (``clahe_interp``), in %."""
    s = ctx["trace"] and kernel_seconds(ctx["trace"], "clahe_interp")
    if not s:
        return None
    need = sum(k2_bound_s(*st) for st in ctx["work"]["k2_stacks"])
    return 100.0 * need * len(ctx["traced"]) / s


def setup_s_(ctx):
    """Seconds from the process's start to the first timed request."""
    return ctx["setup_s"]


def exact_repeat_share(ctx):
    """% of the window's collects that repeated steps exactly."""
    before, after = ctx["counters"]
    if "exact_repeats" not in after or not ctx["records"]:
        return None
    return 100.0 * (after["exact_repeats"] - before["exact_repeats"]) \
        / len(ctx["records"])
