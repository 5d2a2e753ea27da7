"""wattn_pad_share.swin: % of the tokens the window attention computed in
the untraced window that are padding (a map padded right and bottom to
whole 7x7 windows): the program's counters ``window_attn_pad_tokens`` over
``window_attn_tokens`` (``att_aspp_unet_tpu_torch/utils/profiling.py``),
their deltas over the window.  None for a program without them."""


def read(ctx):
    before, after = ctx["counters"]
    tokens = after.get("window_attn_tokens", 0) \
        - before.get("window_attn_tokens", 0)
    if tokens <= 0:
        return None
    pad = after.get("window_attn_pad_tokens", 0) \
        - before.get("window_attn_pad_tokens", 0)
    return 100.0 * pad / tokens
