"""setup_s: seconds from the process's start to the first timed request
(importing torch, loading the kernel libraries, building the system, making
the inputs, the warm-up)."""

from portbench.readers import setup_s_ as read  # noqa: F401
