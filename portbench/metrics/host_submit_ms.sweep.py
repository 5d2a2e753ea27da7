"""host_submit_ms.sweep: mean host milliseconds of a sweep's submit (its
pageable upload and the launches of its device half)."""

from portbench.readers import host_submit_ms as read  # noqa: F401
