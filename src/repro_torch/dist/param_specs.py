"""PartitionSpec assignment for parameter / train-state trees (port of
``repro.dist.param_specs``).

Given the declarative mapping (``ShardingRules``) and the topology (a
mesh, or anything with the reference's ``.shape`` mapping of axis name to
size), walk a nested-dict tree (``repro_torch.models.lm``'s parameters, or
a train state) and emit a concrete layout per leaf.  Leaves are classified
by their path — the dict keys, as ``lm.leaves`` joins them — and unknown
leaves replicate.  Leaves stacked over supercells (``cells``) or encoder
layers (``layers``) get a leading ``None``.

All specs pass through ``_valid_spec``: an axis that does not divide a
dimension is dropped, never an error.  The trees may hold meta tensors
(``lm.init_params(cfg, device="meta")``): only shapes are read.
"""
from __future__ import annotations

from typing import Tuple

from repro_torch.dist.sharding import PartitionSpec as P
from repro_torch.dist.sharding import ShardingRules, _valid_spec


def _logical_axes(names: Tuple[str, ...], ndim: int) -> tuple:
    """Logical axis names (resolved through the rules table) per dim of
    the parameter leaf at tree path ``names`` (stack dim stripped)."""
    last = names[-1] if names else ""
    parent = names[-2] if len(names) > 1 else ""

    if ndim <= 1:
        return (None,) * ndim

    # embedding / unembedding: [Vpad, D] — vocab rows over "model"
    if last in ("embed", "unembed"):
        return ("vocab", None)

    if parent in ("attn", "cross"):
        table = {
            "wq": ("embed", "q_heads_p", None),
            "wk": ("embed", "kv_heads_p", None),
            "wv": ("embed", "kv_heads_p", None),
            "wo": ("q_heads_p", None, "embed"),
            "bq": ("q_heads_p", None),
            "bk": ("kv_heads_p", None),
            "bv": ("kv_heads_p", None),
        }
        if last in table:
            return table[last]

    if parent == "moe":
        # expert weights are EP-resident over the expert dim, as
        # moe_apply's shard_map takes them; "mlp" would collide with
        # "expert" (both "model") and _valid_spec keeps the first use
        table = {
            "router": (None, None),
            "wi": ("expert", None, "mlp"),
            "wu": ("expert", None, "mlp"),
            "wo": ("expert", "mlp", None),
        }
        if last in table:
            return table[last]

    if parent == "ffn":
        table = {
            "wi": ("embed", "mlp"),
            "wu": ("embed", "mlp"),
            "wo": ("mlp", "embed"),
        }
        if last in table:
            return table[last]

    if parent == "mamba":
        table = {
            "in_proj": ("embed", "mlp"),
            "out_proj": ("mlp", "embed"),
            "conv_w": (None, "mlp"),
            "dt_proj": ("embed", None),
            "B_proj": ("embed", None),
            "C_proj": ("embed", None),
        }
        if last in table:
            return table[last]

    if parent == "mlstm":
        # only hd_v is shardable: v/z projections on their last dim,
        # down_proj row-parallel, q/k/gates replicated
        table = {
            "up_x": ("embed", None),
            "up_z": ("embed", None, "mlp"),
            "wv": (None, None, "mlp"),
            "down_proj": (None, "mlp", "embed"),
        }
        if last in table:
            return table[last]
        return (None,) * ndim

    if parent == "slstm":
        table = {
            "w_gates": ("embed", None, "heads", None),
            "r_gates": (None, "heads", None, None),
            "b_gates": (None, "heads", None),
            "up1": ("embed", "mlp"),
            "up2": ("embed", "mlp"),
            "down": ("mlp", "embed"),
        }
        if last in table:
            return table[last]

    if parent == "projector":
        return ("embed", None) if ndim == 2 else (None,) * ndim

    return (None,) * ndim


# Leaves stacked over supercells / encoder layers carry one extra leading
# dim that the logical table does not know about.
_STACKED_ROOTS = ("cells", "layers")


def _leaf_spec(names: Tuple[str, ...], shape: tuple, rules: ShardingRules, mesh) -> P:
    stacked = any(r in names for r in _STACKED_ROOTS)
    ndim = len(shape) - (1 if stacked else 0)
    logical = _logical_axes(names, ndim)
    if stacked:
        logical = (None,) + tuple(logical)
    entries = tuple(rules.physical(a) if isinstance(a, str) else a for a in logical)
    return _valid_spec(mesh, P(*entries), tuple(shape))


def _map_with_path(fn, tree, prefix: tuple = ()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, prefix + (str(k),)) for k, v in tree.items()}
    return fn(prefix, tree)


def param_pspecs(shapes, rules: ShardingRules, mesh):
    """A spec tree matching a parameter tree (tensors, meta tensors, or
    anything with ``.shape``); every leaf gets a valid spec."""
    return _map_with_path(lambda names, leaf: _leaf_spec(names, tuple(leaf.shape), rules, mesh),
                          shapes)


# prefixes stripped so optimizer moments inherit their parameter's spec
_STATE_WRAPPERS = ("params", "opt_state", "m", "v", "mu", "nu")


def state_pspecs(state_shapes, rules: ShardingRules, mesh):
    """Specs for a full train state ``{params, opt_state{m,v,count}, step}``.

    AdamW moments mirror their parameter's layout; scalar counters
    replicate."""
    def one(names, leaf):
        while names and names[0] in _STATE_WRAPPERS:
            names = names[1:]
        if not names or len(leaf.shape) == 0:
            return P()
        return _leaf_spec(names, tuple(leaf.shape), rules, mesh)

    return _map_with_path(one, state_shapes)
