"""mfu.swin: FLOPs of the Swin UNETR sweeps counted in the window (tiles x
mirror views x every conv, transposed conv, linear and window-attention
product of a tile's forward) over its span, in % of 989 TFLOP/s."""

from portbench.readers import mfu as read  # noqa: F401
