from .sharding import (
    RowDraws,
    active_mesh,
    all_reduce_mean,
    batch_draw,
    gather_batch,
    initialize_distributed,
    make_mesh,
    mesh_size,
    pad_to_multiple,
    replicate,
    shard_batch,
    shard_rows,
)

__all__ = [
    "RowDraws",
    "active_mesh",
    "all_reduce_mean",
    "batch_draw",
    "gather_batch",
    "initialize_distributed",
    "make_mesh",
    "mesh_size",
    "pad_to_multiple",
    "replicate",
    "shard_batch",
    "shard_rows",
]
