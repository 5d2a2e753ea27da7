"""k2_roofline.case: K2's roofline share over the traced cases'
enhancements."""

from portbench.readers import k2_roofline as read  # noqa: F401
