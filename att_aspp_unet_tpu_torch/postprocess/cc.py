"""Connected-component labeling by fixed-point min-label propagation.

Counterpart of ``att_aspp_unet_tpu/postprocess/cc.py`` (2-D, the encoded
segmented-scan lowering), with the same iteration structure and cap so the
labels are identical:

- every foreground pixel starts with its flat index + 1;
- one iteration takes the min over the diagonal neighbours (8-connectivity;
  out-of-image = +inf), then a segmented min along every foreground run of
  each axis, forward and backward.  A segmented min-scan is a cumulative max
  of ``run_index * L - value`` (the run index is non-decreasing along the
  scan, so the max stays in the current run);
- iterations stop when nothing changes or at ``max_iters``.

Deciding that nothing changed needs a flag from the device in every
iteration, and the host waits for each.  Inside :func:`speculative` the loops
run a fixed number of iterations instead and only record, on the device,
whether the last one still changed anything; the caller reads that record
together with its results and repeats the work with the exact loops if it is
set.  Extra iterations at a fixed point change nothing, so an unset record
means the exact loops' result.
"""

from __future__ import annotations

import contextlib
import itertools
import math
from typing import List, Optional

import torch

from ..ops.image import bin_counts

INF = 2 ** 30
# iterations a speculative loop runs; the masks of this pipeline (blobs,
# rings, speckle) settle in one or two
SPECULATIVE_ITERS = 4
_unsettled: Optional[List[torch.Tensor]] = None


@contextlib.contextmanager
def speculative():
    """Run every :func:`fixed_point` of the block without reading the device.
    Yields the list that collects one 0-d bool tensor per loop: true where
    the loop had not settled after ``SPECULATIVE_ITERS`` iterations.  Not
    re-entrant, and meant for one thread."""
    global _unsettled
    if _unsettled is not None:
        raise RuntimeError("speculative() is already active")
    _unsettled = []
    try:
        yield _unsettled
    finally:
        _unsettled = None


def _run_bases(reset: torch.Tensor, axis: int):
    fwd = torch.cumsum(reset.long(), dim=axis)
    rev = torch.flip(torch.cumsum(torch.flip(reset, (axis,)).long(), dim=axis),
                     (axis,))
    return fwd, rev


def _cummax(x: torch.Tensor, axis: int, reverse: bool) -> torch.Tensor:
    if reverse:
        return torch.flip(torch.cummax(torch.flip(x, (axis,)), dim=axis)[0],
                          (axis,))
    return torch.cummax(x, dim=axis)[0]


def _diag_offsets(connectivity: int):
    """Neighbour offsets not covered by the axis scans (2-D)."""
    if connectivity == 4:
        return []
    return [d for d in itertools.product((-1, 0, 1), repeat=2)
            if sum(v != 0 for v in d) == 2]


def _neighbor_min(labels: torch.Tensor, offsets) -> torch.Tensor:
    if not offsets:
        return labels
    H, W = labels.shape[-2], labels.shape[-1]
    lp = torch.nn.functional.pad(labels, (1, 1, 1, 1), value=INF)
    m = labels
    for dy, dx in offsets:
        # the neighbour at p + delta contributes to p
        m = torch.minimum(m, lp[..., 1 + dy:1 + dy + H, 1 + dx:1 + dx + W])
    return m


def make_propagate(fg: torch.Tensor, connectivity: int):
    """One propagation step over the foreground ``fg`` (..., H, W)."""
    offsets = _diag_offsets(connectivity)
    reset = ~fg
    n_vals = math.prod(fg.shape[-2:]) + 2
    L = 1 << max(1, (n_vals - 1).bit_length())
    bases = {axis: _run_bases(reset, axis) for axis in (-2, -1)}
    inf = torch.full((), INF, dtype=torch.long, device=fg.device)

    def propagate(labels):
        m = torch.where(fg, _neighbor_min(labels, offsets), inf)
        for axis in (-2, -1):
            bf, br = bases[axis]
            m = bf * L - _cummax(bf * L - m, axis, reverse=False)
            m = br * L - _cummax(br * L - m, axis, reverse=True)
        return torch.where(fg, m, inf)

    return propagate


def fixed_point(propagate, labels: torch.Tensor, max_iters: int):
    if _unsettled is not None and max_iters > SPECULATIVE_ITERS:
        for _ in range(SPECULATIVE_ITERS):
            prev, labels = labels, propagate(labels)
        _unsettled.append(torch.any(labels != prev))
        return labels
    for _ in range(max_iters):
        new = propagate(labels)
        changed = bool(torch.any(new != labels))
        labels = new
        if not changed:
            break
    return labels


def label_components(mask: torch.Tensor, connectivity: int = 8,
                     max_iters: int = 128) -> torch.Tensor:
    """Components within each (H, W) plane; int64 labels, 0 = background,
    each component carries the flat index + 1 of its first pixel."""
    fg = mask.bool()
    H, W = fg.shape[-2], fg.shape[-1]
    flat = torch.arange(1, H * W + 1, device=fg.device).reshape(H, W)
    labels = torch.where(fg, flat.expand(fg.shape),
                         torch.full((), INF, device=fg.device))
    labels = fixed_point(make_propagate(fg, connectivity), labels, max_iters)
    return torch.where(fg, labels, torch.zeros((), dtype=labels.dtype,
                                               device=fg.device))


def component_sizes(labels: torch.Tensor):
    """(label, size) of the largest component of each (H, W) plane; ties go
    to the smaller label, as the JAX package's sort-and-run count does."""
    lead = labels.shape[:-2]
    HW = labels.shape[-2] * labels.shape[-1]
    flat = labels.reshape(-1, HW)
    B = flat.shape[0]
    offs = torch.arange(B, device=labels.device)[:, None] * (HW + 1)
    counts = bin_counts(flat + offs, B * (HW + 1)).reshape(B, HW + 1)
    best = torch.argmax(counts[:, 1:], dim=1) + 1
    size = counts.gather(1, best[:, None])[:, 0]
    return best.reshape(lead), size.reshape(lead)


def largest_component(mask: torch.Tensor, connectivity: int = 8,
                      min_area=0) -> torch.Tensor:
    """Keep only the largest component of each mask; all-zero if it has
    fewer than ``min_area`` pixels."""
    labels = label_components(mask, connectivity)
    best, size = component_sizes(labels)
    keep = (labels == best[..., None, None]) & (labels > 0)
    ok = (size >= max(int(min_area), 1))[..., None, None]
    return (keep & ok).to(torch.uint8)
