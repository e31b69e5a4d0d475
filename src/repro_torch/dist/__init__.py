"""Distribution for the port: meshes of ranks, partition specs, sharded
tensors, the single-controller ``shard_map`` and its collectives, the slot
axis of pooled serving, and the language-model half — sharding rules,
the mesh context, ``shard`` and the KV-cache layout policy, placed trees
(``place``/``gather_tree``: each process's blocks of the specs) and the
tensor-parallel body (``tensor_parallel``) (``dist/sharding.py``);
parameter specs and their placement (``dist/param_specs.py``),
sequence-dimension context parallelism (``dist/context_parallel.py``) and
one process per rank over ``torch.distributed`` (``dist/processes.py``:
``processes.init``, ``process_mesh``)."""
from repro_torch.dist import processes
from repro_torch.dist.processes import process_mesh
from repro_torch.dist.sharding import (
    Mesh,
    NamedSharding,
    P,
    PartitionSpec,
    ShardedTensor,
    ShardingRules,
    active_mesh,
    active_rules,
    default_rules,
    factor_slot_mesh,
    gather,
    gather_placed,
    gather_tree,
    kv_cache_layout,
    place,
    place_tree,
    read_row,
    reshard,
    shard,
    shard_map,
    tensor_parallel,
    use_mesh,
    write_row,
)

__all__ = [
    "Mesh", "NamedSharding", "P", "PartitionSpec", "ShardedTensor", "ShardingRules",
    "active_mesh", "active_rules", "default_rules", "factor_slot_mesh", "gather",
    "gather_placed", "gather_tree", "kv_cache_layout", "place", "place_tree", "read_row",
    "reshard", "shard", "shard_map", "tensor_parallel", "use_mesh", "write_row", "processes",
    "process_mesh",
]
