"""k1_roofline: K1's roofline share over the traced sweeps' pair work."""

from portbench.readers import k1_roofline as read  # noqa: F401
