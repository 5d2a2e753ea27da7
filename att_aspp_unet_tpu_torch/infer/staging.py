"""Host-to-card uploads through pinned staging slots and a side copy stream.

A pageable host array cannot be copied to the card asynchronously: CUDA
copies it through a pinned bounce buffer of its own while the host waits, and
the copy runs on the compute stream, which idles the card meanwhile (a
351 MB case took 50-69 ms a request so).  :class:`Staging` instead:

1. picks the next of :data:`SLOTS` pinned host buffers, waiting only if
   that slot's previous copy has not finished (counted as
   ``upload_slot_waits``); a slot grows to the largest request it has seen
   and is kept for smaller ones;
2. copies the caller's array into the slot on the host (``Tensor.copy_``,
   which runs on PyTorch's intra-op threads and releases the interpreter
   lock), so the caller may reuse its array as soon as the call returns;
3. on the side copy stream, allocates the device tensor and copies each
   staged chunk to it with ``non_blocking=True`` as soon as the chunk is
   staged, then records the slot's event;
4. makes the current (compute) stream wait on that event, not the host.

The device tensor is allocated on the copy stream and marked as used by the
compute stream, so that the caching allocator does not hand its block back
before the compute stream has read it.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..utils.profiling import count

SLOTS = 2                 # requests whose copies may be in flight at once
CHUNK_BYTES = 64 << 20    # staged and copied at a time along the first axis


class Staging:
    """The staged uploads of one device.  ``cuda`` is the module whose
    ``Stream``, ``Event``, ``stream`` and ``current_stream`` are used
    (``torch.cuda``; tests pass a stand-in)."""

    def __init__(self, device, cuda=torch.cuda):
        self.device = torch.device(device)
        self._cuda = cuda
        self.stream = cuda.Stream(self.device)
        self._slots: List[torch.Tensor] = [
            torch.empty(0, dtype=torch.uint8) for _ in range(SLOTS)]
        self._events = [cuda.Event() for _ in range(SLOTS)]
        self._next = 0

    def _slot(self, k: int, nbytes: int) -> torch.Tensor:
        """Slot ``k``'s buffer of at least ``nbytes``, once its last copy
        has finished."""
        event = self._events[k]
        if not event.query():
            count("upload_slot_waits")
            event.synchronize()
        if self._slots[k].numel() < nbytes:
            self._slots[k] = torch.empty(
                nbytes, dtype=torch.uint8,
                pin_memory=self.device.type == "cuda")
        return self._slots[k]

    def upload(self, data) -> torch.Tensor:
        """``data`` (a NumPy array or a CPU tensor) as a tensor on the
        device, ordered before whatever the current stream runs next."""
        src = data if isinstance(data, torch.Tensor) else \
            torch.as_tensor(np.asarray(data))
        k = self._next
        self._next = (k + 1) % SLOTS
        nbytes = src.numel() * src.element_size()
        staged = self._slot(k, nbytes)[:nbytes].view(src.dtype) \
            .view(src.shape)
        compute = self._cuda.current_stream(self.device)
        event = self._events[k]
        with self._cuda.stream(self.stream):
            dst = torch.empty(src.shape, dtype=src.dtype, device=self.device)
            for part in _chunks(src):
                staged[part].copy_(src[part])
                dst[part].copy_(staged[part], non_blocking=True)
            event.record(self.stream)
        if dst.is_cuda:
            dst.record_stream(compute)
        compute.wait_event(event)
        count("staged_uploads")
        return dst


def _chunks(src: torch.Tensor) -> list:
    """Index of each run of whole rows (along the first axis) of about
    :data:`CHUNK_BYTES`; the whole tensor where it has no rows."""
    if src.dim() == 0 or src.shape[0] == 0:
        return [...]
    row = src[0].numel() * src.element_size()
    step = max(1, CHUNK_BYTES // max(1, row))
    return [slice(a, a + step) for a in range(0, src.shape[0], step)]
