"""Published peaks of one NVIDIA H100 SXM (dense, no sparsity, at its 700 W
limit) and the roofline bound: the least time the card could take for a
piece of work, the larger of its operations over the peak rate and its
bytes over the memory bandwidth.  A copy of ``chip_smoke.py``'s ``PEAK_*``
and ``bound()``, kept here so that a change to the program cannot move
them."""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12     # bf16 tensor-core rate
PEAK_F32_FLOPS = 67e12       # f32 outside the tensor cores
PEAK_BYTES = 3.35e12         # HBM3 bytes/s


def bound_s(flops: float, nbytes: float, peak_flops: float) -> float:
    """Seconds: max(flops / peak_flops, nbytes / PEAK_BYTES)."""
    return max(flops / peak_flops, nbytes / PEAK_BYTES)
