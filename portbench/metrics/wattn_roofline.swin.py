"""wattn_roofline.swin: the window attention's roofline share.  The least
time the card could take for the traced requests' window attention,
max(FLOPs / 989 TFLOP/s, bytes / 3.35 TB/s) per request with the FLOPs of
q k^T and (softmax) v and the bytes of q, k, v, the output and the additive
masks (``request_work``'s ``wattn_flops`` and ``wattn_bytes``), over the
device seconds of the kernels whose names hold one of ``NEEDLES``, in %.
None where no kernel matched."""

from portbench.peaks import PEAK_BF16_FLOPS, bound_s

# the kernels that compute the window attention, whatever implements it:
# the fused scaled_dot_product_attention kernel the card runs at these
# shapes (49 tokens, head dim 16, an additive bf16 mask: cuDNN's
# ``cudnn_generated_fort_native_sdpa_sm90_flash_fprop_wgmma_f16_...`` under
# torch 2.11 on the H100), and the name prefix of a hand-written kernel of
# the port
NEEDLES = ("fort_native_sdpa", "window_attn")


def read(ctx):
    t = ctx["trace"]
    if not t:
        return None
    s = sum(sec for name, sec in t["kernel_s"].items()
            if any(n in name for n in NEEDLES))
    if not s:
        return None
    w = ctx["work"]
    need = bound_s(w["wattn_flops"], w["wattn_bytes"], PEAK_BF16_FLOPS)
    return 100.0 * need * len(ctx["traced"]) / s
