"""Distribution for the port: meshes of ranks, partition specs, sharded
tensors, the single-controller ``shard_map`` and the slot axis of pooled
serving (``dist/sharding.py``)."""
from repro_torch.dist.sharding import (
    Mesh,
    P,
    PartitionSpec,
    ShardedTensor,
    factor_slot_mesh,
    gather,
    read_row,
    reshard,
    shard_map,
    write_row,
)

__all__ = [
    "Mesh", "P", "PartitionSpec", "ShardedTensor", "factor_slot_mesh", "gather", "read_row",
    "reshard", "shard_map", "write_row",
]
