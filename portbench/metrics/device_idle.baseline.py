"""device_idle.baseline: % of the traced window of the baseline's sweeps
with no kernel running."""

from portbench.readers import device_idle as read  # noqa: F401
