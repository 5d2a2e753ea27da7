"""host_collect_ms.sweep: mean host milliseconds of a sweep's collect (the
wait for its result, the one transfer, the exact re-rank, the ellipse AC)."""

from portbench.readers import host_collect_ms as read  # noqa: F401
