"""Data parallelism over devices: the data axis, frame shards for serving,
and the process group of data-parallel training."""

from .mesh import (  # noqa: F401
    all_reduce_grads,
    all_reduce_sum,
    gather,
    is_primary,
    make_mesh,
    make_mesh_for_batch,
    pad_to_multiple,
    run_ranks,
    shard_rows,
    split_frames,
)
