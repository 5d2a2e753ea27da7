"""baseline_frames_per_s: frames of the baseline's sweeps counted in the
window (its traffic drains: every sweep submitted before the deadline) over
the seconds from its first submit to the last collect."""

from portbench.readers import frames_per_s as read  # noqa: F401
