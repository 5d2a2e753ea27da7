"""mfu.baseline: conv FLOPs of the baseline's sweeps counted in the window
(tiles x mirror views x the plan's conv FLOPs per patch) over its span, in %
of 989 TFLOP/s."""

from portbench.readers import mfu as read  # noqa: F401
