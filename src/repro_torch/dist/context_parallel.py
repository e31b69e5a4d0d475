"""Sequence-dimension context parallelism via the stencil halo stack (port
of ``repro.dist.context_parallel``).

A Mamba causal conv reads ``[t-(K-1), t]`` and sliding-window attention
reads ``[t-(W-1), t]``: both are stencils on the sequence axis, so under
sequence parallelism their shard-boundary reads are halo exchanges, and
this module expresses them through the machinery the stencil programs use:

1. declare the exchange as a ``dmp.swap`` over a 1-D ``GridAttr`` whose
   grid axis is the sequence dimension (:func:`_build_swap_func`, built by
   ``make_strategy_1d``);
2. lower it with the shared dmp → comm pipeline through
   ``repro_torch.api.lower_ir`` (the process-wide cache stencil compiles
   use), giving ``comm.halo_pad`` + ``comm.exchange_start`` + ``comm.wait``;
3. execute those ops with the shared comm-level executor: one rank with
   ``run_func_dataflow``, every rank of a mesh at once with
   ``run_func_dataflow_ranks`` (the interpreter's exchange, whose pairs come
   from ``comm.permute_pairs``), inside the single-controller
   ``shard_map``.

The port refuses a halo deeper than a shard.  The exchange reaches only
the immediate neighbour, so a window or conv whose halo (W-1 or K-1) is
longer than the shard length ``S // n_shards`` would read zeros where it
should read the shard before the neighbour; the reference computes that
silently wrong, the port raises ``ValueError`` (single-shard runs are not
checked).
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Callable, Optional

import torch

from repro_torch import api
from repro_torch.core import ir
from repro_torch.core.dialects import dmp, stencil
from repro_torch.core.lowering import run_func_dataflow, run_func_dataflow_ranks
from repro_torch.core.passes.decompose import make_strategy_1d
from repro_torch.dist.sharding import PartitionSpec as P
from repro_torch.dist.sharding import as_views, assemble, axis_index, shard_map


@dataclasses.dataclass(frozen=True)
class SeqHaloSpec:
    """Declarative description of one sequence-halo exchange.

    ``halo_lo`` elements arrive from the left (earlier-sequence)
    neighbour, ``halo_hi`` from the right; ``boundary`` fills physical
    sequence edges ("zero" = causal start-of-sequence state)."""

    axis: str
    n_shards: int
    halo_lo: int
    halo_hi: int = 0
    seq_dim: int = 1
    boundary: str = "zero"


def _build_swap_func(local_shape: tuple, spec: SeqHaloSpec) -> ir.FuncOp:
    """IR for the exchange: a temp of local core bounds flowing through a
    ``dmp.swap`` whose grid is 1-D over the sequence axis, built by the
    same strategy object (``make_strategy_1d``) a decomposed stencil
    program uses."""
    strategy = make_strategy_1d(spec.n_shards, axis=spec.axis, dim=spec.seq_dim)
    core = stencil.Bounds.from_shape(local_shape)
    lo = tuple(spec.halo_lo if d == spec.seq_dim else 0 for d in range(len(local_shape)))
    hi = tuple(spec.halo_hi if d == spec.seq_dim else 0 for d in range(len(local_shape)))
    decls, schedule = strategy.exchanges(core, lo, hi, corners=False)
    func = ir.FuncOp("seq_halo", [stencil.TempType(core)])
    swap = dmp.SwapOp(
        func.body.args[0],
        strategy.grid,
        decls,
        result_bounds=core.grow(lo, hi),
        boundary=spec.boundary,
        schedule=schedule,
    )
    func.body.add_op(swap)
    func.body.add_op(ir.ReturnOp([swap.results[0]]))
    return func


@lru_cache(maxsize=128)
def _comm_func(local_shape: tuple, spec: SeqHaloSpec) -> ir.FuncOp:
    """The exchange after the shared dmp→comm lowering: ``comm.halo_pad``
    + per-round ``comm.exchange_start``/``comm.wait``, through
    ``repro_torch.api``'s process-wide cache (visible in
    ``api.cache_stats()``), with a shape-keyed memo on top."""
    return api.lower_ir(_build_swap_func(local_shape, spec), "lower-comm", boundary=spec.boundary)


def comm_ir_text(local_shape: tuple, spec: SeqHaloSpec) -> str:
    """The op names of the exchange's comm-dialect IR, one per line."""
    func = _comm_func(tuple(local_shape), spec)
    return "\n".join(op.name for op in func.body.ops)


def seq_halo_exchange(x, spec: SeqHaloSpec, *, distributed: bool = True, mesh=None):
    """Halo-grow sequence shards by (halo_lo, halo_hi) along ``seq_dim``.

    With ``distributed=False``, ``x`` is one rank's tensor and the exchange
    runs in local emulation (zero halos stay zero, periodic halos wrap
    locally).  With ``distributed=True``, ``x`` is the list of every
    rank's shard, in the row-major rank order of ``mesh`` (default: a mesh
    of ``spec.axis`` alone, the list in its order); each rank exchanges
    with its neighbours along ``spec.axis`` at the same coordinate of every
    other axis, the boundary condition fills the physical edges, and the
    list of grown shards is returned."""
    if not distributed:
        func = _comm_func(tuple(x.shape), spec)
        (out,) = run_func_dataflow(func, [x], axis_sizes={spec.axis: spec.n_shards},
                                   distributed=False)
        return out
    xs = list(x)
    func = _comm_func(tuple(xs[0].shape), spec)
    if mesh is None:
        coords, sizes = [{spec.axis: r} for r in range(len(xs))], {spec.axis: spec.n_shards}
    else:
        coords, sizes = [mesh.coords(r) for r in range(mesh.size)], dict(mesh.shape)
    outs = run_func_dataflow_ranks(func, [[t] for t in xs], coords, axis_sizes=sizes)
    return [o[0] for o in outs]


def _check_halo(spec: SeqHaloSpec, S: int) -> None:
    """Refuse a halo deeper than a shard (see the module's docstring)."""
    n = spec.n_shards
    if n <= 1:
        return
    if S % n:
        raise ValueError(
            f"sequence axis {spec.axis!r}: length {S} does not split into {n} shards"
        )
    s_loc = S // n
    if spec.halo_lo > s_loc or spec.halo_hi > s_loc:
        raise ValueError(
            f"sequence axis {spec.axis!r}: a halo of (lo={spec.halo_lo}, "
            f"hi={spec.halo_hi}) is deeper than the shard length {s_loc} "
            f"({S} positions over {n} shards); the exchange reaches only the "
            "immediate neighbour: use fewer shards or a shorter window"
        )


def context_parallel(
    fn: Callable,
    mesh,
    spec: SeqHaloSpec,
    *,
    out_seq_dim: Optional[int] = None,
) -> Callable:
    """Lift a *local window function* to a sequence-parallel global one.

    ``fn(x_halo, shard_start, *rest)`` receives the halo-grown local
    shard plus the global sequence offset of its core's first element,
    and returns the core-shaped local output (a tensor or a tuple of
    them).  The wrapper runs it on every rank of ``spec.axis`` with the
    halo exchange prepended; ``rest`` operands are replicated (weights)."""
    out_dim = spec.seq_dim if out_seq_dim is None else out_seq_dim

    def global_fn(x, *rest):
        n = spec.n_shards
        S = x.shape[spec.seq_dim]
        if n <= 1:
            # single-rank path: the same code, the exchange emulated locally
            return fn(seq_halo_exchange(x, spec, distributed=False), 0, *rest)
        _check_halo(spec, S)
        x_entries = [None] * x.ndim
        x_entries[spec.seq_dim] = spec.axis
        in_specs = (P(*x_entries),) + tuple(P() for _ in rest)

        # the outputs' ranks (jax.eval_shape): the window function on meta
        grown = [s // n if d == spec.seq_dim else s for d, s in enumerate(x.shape)]
        grown[spec.seq_dim] += spec.halo_lo + spec.halo_hi
        probe = fn(torch.empty(grown, dtype=x.dtype, device="meta"), 0,
                   *(r.to("meta") for r in rest))
        is_tuple = isinstance(probe, tuple)
        out_specs = tuple(
            P(*(spec.axis if d == out_dim else None for d in range(t.ndim)))
            for t in (probe if is_tuple else (probe,))
        )

        def local(ranks):
            idx = [axis_index(mesh, spec.axis, r) for r in range(len(ranks))]
            xh = seq_halo_exchange([loc[0] for loc in ranks], spec, distributed=True, mesh=mesh)
            outs = [fn(h, i * (S // n), *loc[1:]) for h, i, loc in zip(xh, idx, ranks)]
            return [o if is_tuple else (o,) for o in outs]

        args = [as_views(a, mesh, s) for a, s in zip((x,) + rest, in_specs)]
        result = tuple(
            assemble(t)
            for t in shard_map(local, mesh=mesh, in_specs=in_specs, out_specs=out_specs)(*args)
        )
        return result if is_tuple else result[0]

    return global_fn


# --------------------------------------------------------------------------
# Concrete context-parallel layers
# --------------------------------------------------------------------------


def causal_conv_cp(x, w, b, mesh, axis: str):
    """Sequence-parallel Mamba causal conv (``models.mamba._causal_conv``
    distributed over ``axis``).

    The conv reads ``[t-(K-1), t]`` — halo K-1, one-sided — so the left
    halo is the conv's stitching state: the local kernel is the
    single-device ``_causal_conv`` with the exchanged halo passed as its
    ``state``.  x: [B, S, C] (global), w: [K, C], b: [C]."""
    from repro_torch.models.mamba import _causal_conv

    K = w.shape[0]
    spec = SeqHaloSpec(
        axis=axis, n_shards=int(mesh.shape.get(axis, 1)),
        halo_lo=K - 1, halo_hi=0, seq_dim=1, boundary="zero",
    )

    def local(xh, start, w_l, b_l):
        state, core = xh[:, : K - 1], xh[:, K - 1:]
        y, _ = _causal_conv(core, w_l, b_l, state)
        return y

    return context_parallel(local, mesh, spec)(x, w, b)


def window_attention_local(kv_h, start: int, q_l, window: int):
    """The local window function of :func:`sliding_window_attention_cp`:
    ``kv_h`` [2, B, W-1+S_loc, H, D] (K and V, halo-grown), ``q_l``
    [B, S_loc, H, D] whose first query is global position ``start``.  The
    windows are gathered explicitly ([B, S_loc, W, H, D]), so the
    arithmetic per query is independent of the decomposition."""
    W = int(window)
    k_h, v_h = kv_h[0], kv_h[1]
    S_loc = q_l.shape[1]
    D = q_l.shape[-1]
    dev = q_l.device
    # window gather: win[t, w] = halo-extended seq index t + w, i.e.
    # absolute position (start + t) - (W-1) + w
    idx = torch.arange(S_loc, device=dev)[:, None] + torch.arange(W, device=dev)[None, :]
    kw = k_h[:, idx]   # [B, S_loc, W, H, D]
    vw = v_h[:, idx]
    s = torch.einsum("bthd,btwhd->bthw", q_l, kw) / torch.sqrt(
        torch.tensor(float(D), dtype=torch.float32)).to(q_l.dtype)
    abs_kv = (start + torch.arange(S_loc, device=dev))[:, None] - (W - 1) + torch.arange(W, device=dev)
    s = torch.where(abs_kv[None, :, None, :] >= 0, s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bthw,btwhd->bthd", p, vw)


def sliding_window_attention_cp(q, k, v, window: int, mesh, axis: str):
    """Sequence-parallel sliding-window self-attention.

    q/k/v: [B, S, H, D] (MHA; global tensors).  Each query attends the
    causal window ``[t-W+1, t]`` — a radius-(W-1) one-sided sequence
    stencil — so K/V need a left halo of W-1, exchanged once for both
    (stacked on a leading dim), and the local function is
    :func:`window_attention_local`.  Over ``n`` shards the halo W-1 must
    not exceed the shard length ``S // n`` (else ``ValueError``)."""
    W = int(window)
    n = int(mesh.shape.get(axis, 1))
    kv = torch.stack([k, v], dim=0)
    kv_spec = SeqHaloSpec(axis=axis, n_shards=n, halo_lo=W - 1, halo_hi=0,
                          seq_dim=2, boundary="zero")
    if n <= 1:
        kv_h = seq_halo_exchange(kv, kv_spec, distributed=False)
        return window_attention_local(kv_h, 0, q, W)

    S = q.shape[1]
    _check_halo(kv_spec, S)
    in_specs = (P(None, None, axis), P(None, axis))

    def shard_local(ranks):
        idx = [axis_index(mesh, axis, r) for r in range(len(ranks))]
        kv_h = seq_halo_exchange([r[0] for r in ranks], kv_spec, distributed=True, mesh=mesh)
        return [(window_attention_local(h, i * (S // n), r[1], W),)
                for h, i, r in zip(kv_h, idx, ranks)]

    args = [as_views(a, mesh, s) for a, s in zip((kv, q), in_specs)]
    (out,) = shard_map(shard_local, mesh=mesh, in_specs=in_specs,
                       out_specs=(P(None, axis),))(*args)
    return assemble(out)


def mamba_conv_exchange_bytes(cfg, B: int, seq_shards: int) -> int:
    """Wire bytes per layer for the Mamba conv halo under sequence
    parallelism: (K-1) steps × d_inner channels × batch, once per
    direction boundary."""
    d_inner = cfg.ssm_expand * cfg.d_model
    return 4 * B * (cfg.ssm_conv_width - 1) * d_inner * max(seq_shards - 1, 0)
