"""host_submit_ms.case: mean host milliseconds of a case's submit (its pageable
upload and the launches of its device half)."""

from portbench.readers import host_submit_ms as read  # noqa: F401
