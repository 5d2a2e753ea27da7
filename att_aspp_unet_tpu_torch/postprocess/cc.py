"""Connected-component labeling by fixed-point min-label propagation.

Counterpart of ``att_aspp_unet_tpu/postprocess/cc.py``, with the same
iteration structure and cap so the labels are identical:

- ``ndim=2`` labels each (H, W) plane of a batch, ``ndim=3`` the whole
  (N, H, W) stack as one volume (the baseline's 6-connected 3-D components);
- every foreground pixel starts with its flat index + 1 (over the plane, or
  over the whole stack);
- one iteration takes the min over the diagonal neighbours (8- or
  26-connectivity; none for 4 and 6; out-of-image = +inf), then, axis by
  axis, the min over every foreground run along the axis.  The JAX package
  computes that min as a forward and a backward segmented min-scan (after
  the forward scan each pixel holds the min of its run's prefix, after the
  backward one the min of the whole run); here the runs are numbered once
  per labelling, and each axis of an iteration is one scatter-min of the
  labels into a table indexed by run and one gather back: the same labels
  after every iteration, without the scans;
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
from ..utils.profiling import count, span

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


def _run_ids(fg: torch.Tensor, axis: int) -> torch.Tensor:
    """The run of each pixel along ``axis``, numbered 0, 1, ... over the
    whole tensor: the pixels of a foreground run share one number, every
    background pixel has one of its own (no entry of the run table is then
    hit by all the background).  int64, as scatter indices."""
    x = fg.movedim(axis, -1)
    joined = torch.zeros(x.shape, dtype=torch.bool, device=fg.device)
    joined[..., 1:] = x[..., 1:] & x[..., :-1]     # continues the run before
    ids = torch.cumsum(~joined.reshape(-1), 0).sub_(1).reshape(x.shape)
    return ids.movedim(-1, axis).contiguous()


def _diag_offsets(ndim: int, connectivity: int):
    """Neighbour offsets not covered by the runs along the axes: none for
    4- (2-D) and 6-connectivity (3-D), else those with two or more non-zero
    deltas."""
    if (ndim, connectivity) in ((2, 4), (3, 6)):
        return []
    return [d for d in itertools.product((-1, 0, 1), repeat=ndim)
            if sum(v != 0 for v in d) >= 2]


def _neighbor_min(labels: torch.Tensor, offsets, ndim: int) -> torch.Tensor:
    if not offsets:
        return labels
    spatial = labels.shape[-ndim:]
    lp = torch.nn.functional.pad(labels, (1, 1) * ndim, value=INF)
    m = labels
    for d in offsets:
        # the neighbour at p + delta contributes to p
        m = torch.minimum(m, lp[(...,) + tuple(
            slice(1 + v, 1 + v + n) for v, n in zip(d, spatial))])
    return m


def make_propagate(fg: torch.Tensor, connectivity: int, ndim: int = 2):
    """One propagation step over the foreground ``fg`` (..., *spatial) with
    ``ndim`` spatial axes.  Background labels come out +inf."""
    offsets = _diag_offsets(ndim, connectivity)
    runs = [_run_ids(fg, axis) for axis in range(-ndim, 0)]
    table = torch.empty(fg.numel(), dtype=torch.long, device=fg.device)
    inf = torch.full((), INF, dtype=torch.long, device=fg.device)

    def propagate(labels):
        m = torch.where(fg, _neighbor_min(labels, offsets, ndim), inf)
        for ids in runs:
            table.fill_(INF).scatter_reduce_(0, ids.reshape(-1),
                                             m.reshape(-1), reduce="amin")
            m = table.take(ids)
        return m

    return propagate


def fixed_point(propagate, labels: torch.Tensor, max_iters: int):
    """``propagate`` applied until nothing changes, at most ``max_iters``
    times (speculatively: see :func:`speculative`).  The exact loop counts
    each check it reads on the host as ``fixed_point_reads``."""
    with span("fixed_point"):
        if _unsettled is not None and max_iters > SPECULATIVE_ITERS:
            for _ in range(SPECULATIVE_ITERS):
                prev, labels = labels, propagate(labels)
            _unsettled.append(torch.any(labels != prev))
            return labels
        for _ in range(max_iters):
            new = propagate(labels)
            changed = bool(torch.any(new != labels))
            count("fixed_point_reads")
            labels = new
            if not changed:
                break
        return labels


def label_components(mask: torch.Tensor, connectivity: int = 8,
                     max_iters: int = 128, ndim: int = 2) -> torch.Tensor:
    """Components over the last ``ndim`` axes (2: each (H, W) plane, leading
    axes batched; 3: the (N, H, W) volume); int64 labels, 0 = background,
    each component carries the flat index + 1 of its first pixel."""
    fg = mask.bool()
    spatial = fg.shape[-ndim:]
    flat = torch.arange(1, math.prod(spatial) + 1,
                        device=fg.device).reshape(spatial)
    labels = torch.where(fg, flat.expand(fg.shape),
                         torch.full((), INF, device=fg.device))
    del flat
    labels = fixed_point(make_propagate(fg, connectivity, ndim), labels,
                         max_iters)
    return torch.where(fg, labels, torch.zeros((), dtype=labels.dtype,
                                               device=fg.device))


def component_sizes(labels: torch.Tensor, ndim: int = 2):
    """(label, size) of the largest component of each labelled plane
    (``ndim=2``) or volume (``ndim=3``); ties go to the smaller label, as the
    JAX package's sort-and-run count does."""
    lead = labels.shape[:-ndim]
    S = math.prod(labels.shape[-ndim:])
    flat = labels.reshape(-1, S)
    B = flat.shape[0]
    offs = torch.arange(B, device=labels.device)[:, None] * (S + 1)
    # the background is not counted (-1 lies outside the bins): every
    # background pixel would hit the one bin of its plane
    idx = torch.where(flat > 0, flat + offs, -1)
    counts = bin_counts(idx, B * (S + 1)).reshape(B, S + 1)
    best = torch.argmax(counts[:, 1:], dim=1) + 1
    size = counts.gather(1, best[:, None])[:, 0]
    return best.reshape(lead), size.reshape(lead)


def largest_component(mask: torch.Tensor, connectivity: int = 8,
                      min_area=0, ndim: int = 2) -> torch.Tensor:
    """Keep only the largest component of each mask (each plane for
    ``ndim=2``, the volume for ``ndim=3``); all-zero if it has fewer than
    ``min_area`` pixels."""
    labels = label_components(mask, connectivity, ndim=ndim)
    best, size = component_sizes(labels, ndim)
    expand = (...,) + (None,) * ndim
    keep = (labels == best[expand]) & (labels > 0)
    ok = (size >= max(int(min_area), 1))[expand]
    return (keep & ok).to(torch.uint8)
