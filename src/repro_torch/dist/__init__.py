"""Distribution for the port: meshes of ranks, partition specs, sharded
tensors, the single-controller ``shard_map`` and its collectives, the slot
axis of pooled serving, and the language-model half — sharding rules,
the mesh context, ``shard`` and the KV-cache layout policy
(``dist/sharding.py``); parameter specs (``dist/param_specs.py``) and
sequence-dimension context parallelism (``dist/context_parallel.py``)."""
from repro_torch.dist.sharding import (
    Mesh,
    P,
    PartitionSpec,
    ShardedTensor,
    ShardingRules,
    active_mesh,
    active_rules,
    default_rules,
    factor_slot_mesh,
    gather,
    kv_cache_layout,
    read_row,
    reshard,
    shard,
    shard_map,
    use_mesh,
    write_row,
)

__all__ = [
    "Mesh", "P", "PartitionSpec", "ShardedTensor", "ShardingRules", "active_mesh",
    "active_rules", "default_rules", "factor_slot_mesh", "gather", "kv_cache_layout",
    "read_row", "reshard", "shard", "shard_map", "use_mesh", "write_row",
]
