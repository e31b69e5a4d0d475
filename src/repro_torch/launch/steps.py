"""Step builders + input specs for every (arch × shape) cell (port of
``repro.launch.steps``).

``input_specs(cfg, shape, mesh, rules)`` returns, for every input of a
cell's step, an :class:`Arg`: a meta tensor of the global shape and dtype
(nothing is allocated) and its spec on the mesh.  ``build_step`` returns
the step (it enters ``use_mesh``), its meta example arguments and the spec
trees of its inputs and outputs; a caller with tensors of those shapes (on
CPU ranks or the card) calls the same step, and ``step.placed`` runs it
tensor- and data-parallel on the arguments' placed blocks
(``step.place``): ``ShardedTrainStep``, :class:`ShardedPrefill` and
:class:`ShardedDecode`, each process holding its blocks of the
reference's specs.
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
from repro_torch.train.train_step import (
    ShardedTrainStep,
    TrainOptions,
    init_train_state,
    make_train_step,
)

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


class Step:
    """A cell's step (``build_step``): called with global tensors it runs
    the flat models under ``use_mesh(mesh, rules)`` (the weights whole,
    the mesh branches per rank); ``placed`` is the same step tensor- and
    data-parallel on placed blocks (``ShardedTrainStep``,
    :class:`ShardedPrefill`, :class:`ShardedDecode`), ``place`` lays the
    global arguments out for it by the input specs."""

    def __init__(self, fn, placed, in_specs, mesh, place=None):
        self.fn, self.placed, self.in_specs, self.mesh = fn, placed, in_specs, mesh
        self._place = place

    def __call__(self, *args):
        return self.fn(*args)

    def place(self, *args):
        """The global arguments as ``placed`` takes them: the placement the
        step was built with (a train step's: with microbatches its batch is
        ``[n, B/n, ...]``), else each leaf placed by its input spec."""
        from repro_torch.dist.sharding import place

        if self._place is not None:
            return self._place(*args)

        def one(x, s):
            if isinstance(x, dict):
                return {k: one(v, s[k]) for k, v in x.items()}
            return place(x, self.mesh, s)

        return tuple(one(a, s) for a, s in zip(args, self.in_specs))


def build_step(cfg: ModelConfig, shape: ShapeConfig, mesh,
               rules: Optional[ShardingRules] = None,
               train_options: Optional[TrainOptions] = None):
    """Returns ``(fn, example_args, in_specs, out_specs)``: the step of
    this cell (a :class:`Step`: on global tensors under ``use_mesh(mesh,
    rules)``; ``fn.placed`` on placed blocks, tensor- and data-parallel),
    its arguments as meta tensors at the cell's global shapes, and the
    spec trees of its arguments and of its outputs (``None`` where the
    reference pins none)."""
    rules = rules or default_rules(multi_pod="pod" in mesh.axis_names)
    specs = input_specs(cfg, shape, mesh, rules)
    B, S = shape.global_batch, shape.seq_len

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
        sharded = ShardedTrainStep(cfg, opt_cfg, options, mesh, B, rules)
        in_sp = (st_specs, specs_of(specs))
        return (Step(wrapped, sharded, in_sp, mesh, place=sharded.place),
                (args_of(state_in), args_of(specs)), in_sp, (st_specs, None))

    params_in = _params_args(cfg, mesh, rules)
    p_specs = specs_of(params_in)

    if shape.kind == "prefill":

        def prefill(params, batch):
            with use_mesh(mesh, rules):
                return lm.forward_prefill(params, cfg, batch["tokens"], batch.get("modality"),
                                          q_chunk=min(1024, shape.seq_len))

        sharded = ShardedPrefill(cfg, mesh, B, S, rules, q_chunk=min(1024, S))
        in_sp = (p_specs, specs_of(specs))
        return Step(prefill, sharded, in_sp, mesh), (args_of(params_in), args_of(specs)), in_sp, None

    def serve_step(params, batch):
        with use_mesh(mesh, rules):
            return lm.decode_step(params, cfg, batch["token"], batch["pos"], batch["cache"])

    # the outputs keep the inputs' layouts: logits batch-sharded, the new
    # cache in the input cache's layout
    batch_ax = _batch_axes(rules)
    logits_spec = _valid_spec(mesh, P(batch_ax), (shape.global_batch,))
    in_sp = specs_of(specs)
    decode = ShardedDecode(cfg, mesh, B, S, rules,
                           memory_len=S if cfg.is_encoder_decoder else 0)

    def placed(params, batch):
        return decode(params, batch["token"], batch["pos"], batch["cache"]), batch["cache"]

    return (Step(serve_step, placed, (p_specs, in_sp), mesh),
            (args_of(params_in), args_of(specs)), (p_specs, in_sp),
            (logits_spec, in_sp["cache"]))


# --------------------------------------------------------------------------
# the steps on placed blocks (tensor and data parallelism)
# --------------------------------------------------------------------------


def logits_spec(cfg: ModelConfig, B: int, mesh, rules: ShardingRules) -> P:
    """The layout of ``[B, Vpad]`` logits a sharded step returns: rows over
    the batch axes, the vocab over ``"vocab_act"``'s (the reference's
    ``shard(..., "vocab_act")``)."""
    from repro_torch.models.layers import padded_vocab

    return _valid_spec(mesh, P(_batch_axes(rules), rules.physical("vocab_act")),
                       (B, padded_vocab(cfg.vocab_size)))


class ShardedPrefill:
    """``lm.forward_prefill`` tensor- and data-parallel over ``mesh`` for a
    global batch of ``B`` prompts of ``S`` positions: placed parameters
    (``param_pspecs``) and a placed batch in; the placed logits of the
    last position (:func:`logits_spec`) and the placed cache
    (:func:`cache_pspecs`, ``self.cache_specs``) out."""

    def __init__(self, cfg: ModelConfig, mesh, B: int, S: int,
                 rules: Optional[ShardingRules] = None, q_chunk: int = 1024):
        self.cfg, self.mesh, self.B, self.q_chunk = cfg, mesh, B, q_chunk
        self.rules = rules or default_rules(multi_pod="pod" in mesh.axis_names)
        shape = ShapeConfig("prefill", S, B, "prefill")
        self.batch_specs = specs_of(input_specs(cfg, shape, mesh, self.rules))
        self.param_specs = pspecs.param_pspecs(lm.init_params(cfg, device="meta"), self.rules,
                                               mesh)
        # the cache holds every position of the prompt (vision: its patches too)
        mem = S if cfg.is_encoder_decoder else 0
        self.cache_specs = cache_pspecs(
            cfg, lm.init_cache(cfg, B, S, memory_len=mem, device="meta"), mesh, self.rules)
        self.logits_spec = logits_spec(cfg, B, mesh, self.rules)

    @torch.no_grad()
    def __call__(self, params, batch):
        from repro_torch.dist.sharding import _map_specs, enter, tensor_parallel, to_placed
        from repro_torch.models import tp

        mesh = self.mesh
        with tensor_parallel(mesh, self.rules):
            body = _map_specs(lambda x, s: enter(x, mesh, s), params, self.param_specs)
            tokens = enter(batch["tokens"], mesh, self.batch_specs["tokens"])
            modality = None
            if "modality" in batch:
                modality = enter(batch["modality"], mesh, self.batch_specs["modality"])
            logits, cache = tp.forward_prefill(body, self.cfg, tokens, modality, self.q_chunk,
                                               mesh, self.B)
            return (to_placed(logits, mesh, self.logits_spec),
                    _map_specs(lambda t, s: to_placed(t, mesh, s), cache, self.cache_specs))


class ShardedDecode:
    """``lm.decode_step`` tensor- and data-parallel over ``mesh`` for a
    global batch of ``B`` rows against a cache of ``T`` positions (and
    ``memory_len`` encoder positions): placed parameters, a placed
    ``[B]`` token, the positions and a placed cache (``self.cache_specs``,
    written in place) in; the placed logits out.  ``pos`` is one position
    for every row (an int or a 0-d tensor) or every row's own, a ``[B]``
    integer tensor the same on every process (as the serving engine's
    slots decode at different depths; placed by ``P()`` it may carry
    size-1 mesh dims in front): each rank takes its rows' positions."""

    def __init__(self, cfg: ModelConfig, mesh, B: int, T: int,
                 rules: Optional[ShardingRules] = None, memory_len: int = 0):
        self.cfg, self.mesh, self.B = cfg, mesh, B
        self.rules = rules or default_rules(multi_pod="pod" in mesh.axis_names)
        self.param_specs = pspecs.param_pspecs(lm.init_params(cfg, device="meta"), self.rules,
                                               mesh)
        self.token_spec = _valid_spec(mesh, P(_batch_axes(self.rules)), (B,))
        self.cache_specs = cache_pspecs(
            cfg, lm.init_cache(cfg, B, T, memory_len=memory_len, device="meta"), mesh,
            self.rules)
        self.logits_spec = logits_spec(cfg, B, mesh, self.rules)

    @torch.no_grad()
    def __call__(self, params, token, pos, cache):
        from repro_torch.dist.sharding import _map_specs, enter, tensor_parallel, to_placed
        from repro_torch.models import tp

        mesh = self.mesh
        with tensor_parallel(mesh, self.rules):
            body = _map_specs(lambda x, s: enter(x, mesh, s), params, self.param_specs)
            tok = enter(token, mesh, self.token_spec)
            logits = tp.decode_step(body, self.cfg, tok, pos, cache, self.cache_specs, mesh,
                                    self.B)
            return to_placed(logits, mesh, self.logits_spec)
