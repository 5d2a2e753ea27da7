"""case_frames_per_s: frames of the cases completed inside the window over the
seconds from its first submit to the last of those completions."""

from portbench.readers import frames_per_s as read  # noqa: F401
