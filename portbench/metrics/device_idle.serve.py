"""device_idle.serve: % of the traced window of sweeps with no kernel
running."""

from portbench.readers import device_idle as read  # noqa: F401
