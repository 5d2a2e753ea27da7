"""mfu.serve: conv FLOPs of the sweeps served in the window over its span, in
% of 989 TFLOP/s."""

from portbench.readers import mfu as read  # noqa: F401
