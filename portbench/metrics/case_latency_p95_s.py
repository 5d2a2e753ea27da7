"""case_latency_p95_s: the 95th percentile, over every case completed inside
the window, of the seconds from its submit to the return of its collect."""

from portbench.readers import latency_p95_s as read  # noqa: F401
