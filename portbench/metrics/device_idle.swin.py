"""device_idle.swin: % of the traced window of the Swin UNETR sweeps with no
kernel running."""

from portbench.readers import device_idle as read  # noqa: F401
