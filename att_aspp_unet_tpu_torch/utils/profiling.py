"""Named spans and counters of the port's engines.

Counterpart of ``att_aspp_unet_tpu/utils/profiling.py::annotate``:

- ``span(name, request=None)``: inside a ``torch.profiler`` session, a host
  range named ``att.<name>`` (``att.<name>#<request>`` where a request's
  sequence number is given: a range's args string does not reach the
  trace), so the program's ranges lie on the session's clock beside the
  device's activity; outside one, a single flag check and one shared no-op
  context, with no dispatcher call.

  The range is a function-scope one (``_RecordFunctionFast``), not
  ``record_function``'s user scope: the profiler copies the innermost
  user-scope range onto the device's row, over the kernels launched inside
  it, where a reduction of the device's activity would count it as work
  (a traced cascade case read 10.6 % idle instead of ≈ 55 %), and where the
  caller's own user-scope ranges belong.
- ``label(name, request=None)`` / ``name_of(range_name)``: a span's range
  name, and the span's name back from a trace's range (None for a range that
  is not a span), for readers of a trace.
- ``count(name, k=1)`` / ``counts()``: process-wide integer counters, always
  on.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _profiler

PREFIX = "att."
NOOP = contextlib.nullcontext()
_counts: Dict[str, int] = {}


def label(name: str, request: Optional[int] = None) -> str:
    """The range's name: ``att.<name>``, or ``att.<name>#<request>``."""
    return PREFIX + (name if request is None else f"{name}#{request}")


def name_of(range_name: str) -> Optional[str]:
    """The span a range's name is :func:`label` of (``att.submit#12`` ->
    ``submit``); None for any other range."""
    if not range_name.startswith(PREFIX):
        return None
    return range_name[len(PREFIX):].split("#")[0]


def span(name: str, request: Optional[int] = None):
    """The range :func:`label` ``(name, request)`` while a profiler session
    is active, else :data:`NOOP`."""
    # torch's own flag for fast checks: set while any profiler session runs
    if not _profiler._is_profiler_enabled:
        return NOOP
    return _RecordFunctionFast(label(name, request))


def count(name: str, k: int = 1) -> None:
    _counts[name] = _counts.get(name, 0) + k


def counts() -> Dict[str, int]:
    """A copy of every counter."""
    return dict(_counts)
