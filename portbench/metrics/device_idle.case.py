"""device_idle.case: % of the traced window of cases with no kernel running."""

from portbench.readers import device_idle as read  # noqa: F401
