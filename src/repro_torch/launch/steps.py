"""Step builders + input specs for every (arch × shape) cell (port of
``repro.launch.steps``).

``input_specs(cfg, shape, mesh, rules)`` returns, for every input of a
cell's step, an :class:`Arg`: a meta tensor of the global shape and dtype
(nothing is allocated) and its spec on the mesh.  ``build_step`` returns
the step function (it enters ``use_mesh``), its meta example arguments and
the spec trees of its inputs and outputs; a caller with tensors of those
shapes (on CPU ranks or the card) calls the same function.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.dist import param_specs as pspecs
from repro_torch.dist.sharding import (
    PartitionSpec as P,
    ShardingRules,
    _valid_spec,
    default_rules,
    kv_cache_layout,
    use_mesh,
)
from repro_torch.models import lm
from repro_torch.models.lm import tree_map
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.train_step import TrainOptions, init_train_state, make_train_step

# Serving weight residency: deployments may keep bf16 weights resident
# (REPRO_SERVE_PARAMS_DTYPE=bfloat16); the default keeps the training
# dtype (float32), as the reference does.
SERVE_PARAMS_DTYPE = os.environ.get("REPRO_SERVE_PARAMS_DTYPE", "float32")


@dataclasses.dataclass(frozen=True)
class Arg:
    """One step input: a meta tensor of its global shape and dtype, and
    its spec on the mesh (the reference's sharded ``ShapeDtypeStruct``)."""

    meta: torch.Tensor
    spec: P


def args_of(tree):
    """The meta tensors of a tree of :class:`Arg` s."""
    return tree_map(lambda a: a.meta, tree)


def specs_of(tree):
    """The specs of a tree of :class:`Arg` s."""
    return tree_map(lambda a: a.spec, tree)


def _serving_param_shapes(params_shapes):
    if SERVE_PARAMS_DTYPE != "bfloat16":
        return params_shapes
    return tree_map(
        lambda t: t.to(torch.bfloat16) if t.dtype == torch.float32 else t, params_shapes
    )


def _batch_axes(rules: ShardingRules):
    return rules.physical("batch")


# --------------------------------------------------------------------------
# cache sharding policy
# --------------------------------------------------------------------------


def kv_cache_spec(shape: tuple, mesh, rules: ShardingRules) -> P:
    """[cells, B, T, KH, HD] cache sharding: batch over the batch axes when
    it divides; KV heads over "model" when they divide, else the
    *sequence* dim over "model"; tiny-batch long-context shards the
    sequence over everything available."""
    cells, B, T, KH, HD = shape
    batch_ax = _batch_axes(rules)
    layout = kv_cache_layout(B, T, KH, mesh, rules)
    if layout == "heads":
        return P(None, batch_ax, None, "model", None)
    if layout == "seq":
        return P(None, batch_ax, "model", None, None)
    if layout == "batch":
        return P(None, batch_ax, None, None, None)
    if layout == "seq_all":
        seq_axes = tuple(
            a for a in (batch_ax if isinstance(batch_ax, tuple) else (batch_ax,)) if a
        ) + ("model",)
        return P(None, None, seq_axes, None, None)
    return P()


def cache_pspecs(cfg: ModelConfig, cache_shapes, mesh, rules: ShardingRules):
    """A spec tree matching a cache tree (``lm.init_cache``)."""
    batch_ax = _batch_axes(rules)

    def one(names, leaf):
        last = names[-1]
        if last in ("k", "v", "ck", "cv"):
            return kv_cache_spec(tuple(leaf.shape), mesh, rules)
        # ssm/xlstm states: [cells, B, ...] — batch when divisible
        entries = [None] * len(leaf.shape)
        if len(leaf.shape) >= 2:
            entries[1] = batch_ax
        if last == "conv" and len(leaf.shape) == 4:
            entries[3] = "model"  # d_inner
        return _valid_spec(mesh, P(*entries), tuple(leaf.shape))

    return pspecs._map_with_path(one, cache_shapes)


# --------------------------------------------------------------------------
# input specs
# --------------------------------------------------------------------------


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig, mesh,
                rules: Optional[ShardingRules] = None) -> dict:
    """:class:`Arg` s for the step inputs of this cell (tokens int32, as
    the reference's)."""
    rules = rules or default_rules(multi_pod="pod" in mesh.axis_names)
    batch_ax = _batch_axes(rules)
    B, S = shape.global_batch, shape.seq_len

    def arg(shp, dtype, spec):
        return Arg(_meta(shp, dtype), _valid_spec(mesh, spec, tuple(shp)))

    if shape.kind in ("train", "prefill"):
        n_text = S - (cfg.num_modality_tokens if cfg.modality == "vision" else 0)
        batch = {"tokens": arg((B, n_text), torch.int32, P(batch_ax, None))}
        if cfg.modality == "vision":
            batch["modality"] = arg((B, cfg.num_modality_tokens, cfg.modality_dim),
                                    torch.float32, P(batch_ax, None, None))
        elif cfg.modality == "audio":
            batch["modality"] = arg((B, S, cfg.modality_dim), torch.float32,
                                    P(batch_ax, None, None))
        return batch

    # decode: one token against a seq_len cache
    cache_shapes = lm.init_cache(cfg, B, S, memory_len=S if cfg.is_encoder_decoder else 0,
                                 device="meta")
    cspecs = cache_pspecs(cfg, cache_shapes, mesh, rules)
    return {
        "token": arg((B,), torch.int32, P(batch_ax)),
        "pos": Arg(_meta((), torch.int32), P()),
        "cache": tree_map(Arg, cache_shapes, cspecs),
    }


# --------------------------------------------------------------------------
# step builders
# --------------------------------------------------------------------------


def _params_args(cfg: ModelConfig, mesh, rules: ShardingRules) -> dict:
    shapes = _serving_param_shapes(lm.init_params(cfg, device="meta"))
    return tree_map(Arg, shapes, pspecs.param_pspecs(shapes, rules, mesh))


def build_step(cfg: ModelConfig, shape: ShapeConfig, mesh,
               rules: Optional[ShardingRules] = None,
               train_options: Optional[TrainOptions] = None):
    """Returns ``(fn, example_args, in_specs, out_specs)``: the step
    function of this cell (it runs under ``use_mesh(mesh, rules)``), its
    arguments as meta tensors at the cell's global shapes, and the spec
    trees of its arguments and of its outputs (``None`` where the
    reference pins none)."""
    rules = rules or default_rules(multi_pod="pod" in mesh.axis_names)
    specs = input_specs(cfg, shape, mesh, rules)

    if shape.kind == "train":
        opt_cfg = opt_mod.OptimizerConfig()
        options = train_options or TrainOptions(q_chunk=min(1024, shape.seq_len))
        step = make_train_step(cfg, opt_cfg, options)

        def wrapped(state, batch):
            with use_mesh(mesh, rules):
                return step(state, batch)

        state_shapes = init_train_state(None, cfg, device="meta")
        st_specs = pspecs.state_pspecs(state_shapes, rules, mesh)
        state_in = tree_map(Arg, state_shapes, st_specs)
        return (wrapped, (args_of(state_in), args_of(specs)),
                (st_specs, specs_of(specs)), (st_specs, None))

    params_in = _params_args(cfg, mesh, rules)
    p_specs = specs_of(params_in)

    if shape.kind == "prefill":

        def prefill(params, batch):
            with use_mesh(mesh, rules):
                return lm.forward_prefill(params, cfg, batch["tokens"], batch.get("modality"),
                                          q_chunk=min(1024, shape.seq_len))

        return prefill, (args_of(params_in), args_of(specs)), (p_specs, specs_of(specs)), None

    def serve_step(params, batch):
        with use_mesh(mesh, rules):
            return lm.decode_step(params, cfg, batch["token"], batch["pos"], batch["cache"])

    # the outputs keep the inputs' layouts: logits batch-sharded, the new
    # cache in the input cache's layout
    batch_ax = _batch_axes(rules)
    logits_spec = _valid_spec(mesh, P(batch_ax), (shape.global_batch,))
    in_sp = specs_of(specs)
    return (serve_step, (args_of(params_in), args_of(specs)), (p_specs, in_sp),
            (logits_spec, in_sp["cache"]))
