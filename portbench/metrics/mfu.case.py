"""mfu.case: conv FLOPs of the cases served in the window (the scout on every
frame, the main model on the promoted ones) over its span, in % of 989
TFLOP/s."""

from portbench.readers import mfu as read  # noqa: F401
