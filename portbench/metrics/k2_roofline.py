"""k2_roofline: K2's roofline share over the traced sweeps' enhancements."""

from portbench.readers import k2_roofline as read  # noqa: F401
