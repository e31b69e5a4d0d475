"""Distribution for the port: meshes of ranks, partition specs, sharded
tensors and the single-controller ``shard_map`` (``dist/sharding.py``)."""
from repro_torch.dist.sharding import (
    Mesh,
    P,
    PartitionSpec,
    ShardedTensor,
    gather,
    reshard,
    shard_map,
)

__all__ = ["Mesh", "P", "PartitionSpec", "ShardedTensor", "gather", "reshard", "shard_map"]
