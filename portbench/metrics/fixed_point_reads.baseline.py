"""fixed_point_reads.baseline: host reads of a fixed-point check per
postprocessed sweep of the baseline (its 3-D components read the device back
on every propagation iteration), as the mean over every sweep the run's
process postprocessed, warm-up sweeps and both windows included: the
program's process-wide counters ``fixed_point_reads`` and
``postprocess_calls`` (``att_aspp_unet_tpu_torch/utils/profiling.py``), not
a delta over a window.  None for a program without them."""


def read(ctx):
    try:
        from att_aspp_unet_tpu_torch.utils.profiling import counts
    except ImportError:
        return None
    c = counts()
    if not c.get("postprocess_calls"):
        return None
    return c.get("fixed_point_reads", 0) / c["postprocess_calls"]
