"""k2_roofline.baseline: K2's roofline share over the traced sweeps'
enhancements on the baseline path."""

from portbench.readers import k2_roofline as read  # noqa: F401
