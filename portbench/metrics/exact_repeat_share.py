"""exact_repeat_share: the share, in %, of the window's collects that found
a speculative fixed point unsettled and repeated steps exactly (the
engine's ``exact_repeats`` counter)."""

from portbench.readers import exact_repeat_share as read  # noqa: F401
