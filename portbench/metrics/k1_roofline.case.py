"""k1_roofline.case: K1's roofline share over the traced cases' pair work."""

from portbench.readers import k1_roofline as read  # noqa: F401
