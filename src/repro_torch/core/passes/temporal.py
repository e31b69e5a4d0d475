# Copied from src/repro/core/passes/temporal.py with repro. renamed to repro_torch.; keep its logic in step with that file.
"""Deep-halo temporal tiling — exchange once, step ``k`` times.

The paper's halo machinery (sec. 4.1/4.2) infers the *minimal* halo per
value, but one neighbor exchange per time step is still the dominant cost
at scale (the fig. 8 regime; Devito's haloupdate-placement analysis makes
the same observation).  Classic distributed-stencil practice amortizes it:
exchange a *depth-k* halo once, then run ``k`` steps of the stencil with
redundant boundary compute before the next exchange.

``temporal_tile(func, k)`` expresses that trade as a pure IR transform on
the rank-local decomposed function (after ``decompose``/``swap-elim``,
before ``overlap``/``lower-comm``):

- every per-step ``dmp.swap`` is deleted and replaced by **one deep swap
  per loaded field**, its halo extents scaled to the *accumulated* demand
  of the whole epoch (backward dataflow over the k-times-unrolled apply
  chain — chained applies compound, exactly like the per-step inference);
- the apply chain is cloned ``k`` times with time-buffer rotation at the
  value level (the IR analogue of ``repro_torch.api.time_loop``'s
  ``state' = state[q:] + outs``), each clone's result bounds grown by what
  the *remaining* steps still read — step j computes ``core`` plus a
  shrinking frame of redundant boundary points, step k computes exactly
  ``core``;
- programs whose state carries *more* inputs than outputs (``p > q``,
  e.g. ``time_order >= 2`` wave kernels reading ``u`` and ``u_prev``)
  rotate closed too: the epoch stores the ``p - q`` carried intermediate
  buffers (iterations ``k-q`` … ``k-1``) into the dead oldest input
  buffers and returns the FULL rotated state oldest → newest, so the
  caller's ``state' = state[len(outs):] + outs`` is exact for any depth;
- for ``zero`` (dirichlet) boundaries a ``comm.boundary_mask`` re-applies
  the boundary condition to redundantly-computed points that lie outside
  the *physical* domain (rank-position-aware, no communication), so the
  epoch is bitwise-equal to k single-exchange steps.  Periodic boundaries
  need no mask: deep wrap data makes the redundant points exact.

Corner note: even a *star* stencil composed with itself has a diamond
footprint, so any epoch with ``k >= 2`` over 2+ decomposed dims reads
corner halo data; the deep swap therefore uses the sequential
(corner-forwarding) schedule in that case, which the ``diagonal`` pass
can still rewrite into concurrent corner messages afterwards.

``epoch_halo(func, k)`` exposes the accumulated per-dim widths for
``repro_torch.api``'s Target validation (``Target(exchange_every=k)``) without
running the rewrite.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch.core import ir
from repro_torch.core.dialects import comm, dmp, stencil
from repro_torch.core.passes.halo import needs_corners


class TemporalTilingError(ValueError):
    """A program shape ``temporal_tile`` cannot epoch: state that does not
    rotate closed (more outputs than inputs), partial stores,
    index-dependent bodies, or unsupported function-level ops."""


# --------------------------------------------------------------------------
# Phase 1 — step-structure extraction (works on global *and* local IR)
# --------------------------------------------------------------------------


@dataclass
class _Step:
    """One time step as the IR states it: loads in, stores out, applies
    between, with any per-step swaps recorded (and looked *through*)."""

    loads: list          # LoadOp, body order
    load_of_field: dict  # field BlockArgument -> load result SSAValue
    swaps: dict          # swap result SSAValue -> dmp.SwapOp
    applies: list        # ApplyOp, body order
    stores: list         # StoreOp, body order
    ret: ir.Operation
    in_fields: list      # non-stored field args, arg order (rotation state)
    out_fields: list     # stored field args, first-store order
    stored_val: dict     # field arg -> stored temp (swap-resolved)


def _unswapped(v: ir.SSAValue, swaps: dict) -> ir.SSAValue:
    while v in swaps:
        v = swaps[v].temp
    return v


def _extract_step(func: ir.FuncOp) -> _Step:
    loads, applies, stores = [], [], []
    load_of_field: dict = {}
    swaps: dict = {}
    ret = None
    for op in func.body.ops:
        if isinstance(op, stencil.LoadOp):
            if op.field in load_of_field:
                raise TemporalTilingError(
                    f"field {op.field.name_hint!r} loaded twice (run swap-elim"
                    " first)"
                )
            if op.results[0].type.bounds != op.field.type.bounds:
                raise TemporalTilingError("partial stencil.load not supported")
            load_of_field[op.field] = op.results[0]
            loads.append(op)
        elif isinstance(op, dmp.SwapOp):
            swaps[op.results[0]] = op
        elif isinstance(op, stencil.ApplyOp):
            for body_op in op.body.ops:
                if isinstance(body_op, (stencil.IndexOp, stencil.DynAccessOp)):
                    raise TemporalTilingError(
                        f"apply body op {body_op.name} is position-dependent; "
                        "redundant boundary compute would change its value"
                    )
            applies.append(op)
        elif isinstance(op, stencil.StoreOp):
            stores.append(op)
        elif isinstance(op, ir.ReturnOp):
            ret = op
        else:
            raise TemporalTilingError(
                f"function-level op {op.name} not supported in an epoch"
            )
    if ret is None:
        raise TemporalTilingError("missing func.return")

    field_args = [
        a for a in func.body.args if isinstance(a.type, stencil.FieldType)
    ]
    stored_val: dict = {}
    out_fields: list = []
    for st_op in stores:
        if st_op.field in stored_val:
            raise TemporalTilingError(
                f"field {st_op.field.name_hint!r} stored twice per step"
            )
        if st_op.bounds != st_op.field.type.bounds:
            raise TemporalTilingError(
                "partial stencil.store not supported: the next step would "
                "read stale points of the output buffer"
            )
        stored_val[st_op.field] = _unswapped(st_op.temp, swaps)
        out_fields.append(st_op.field)
    in_fields = [a for a in field_args if a not in stored_val]
    if len(out_fields) > len(in_fields) or not out_fields:
        raise TemporalTilingError(
            f"state does not rotate closed: {len(in_fields)} input field(s) "
            f"vs {len(out_fields)} output field(s); temporal tiling needs at "
            "least one input buffer per output so the rotation "
            "state' = state[q:] + outs is well-defined"
        )
    for f in in_fields:
        if f not in load_of_field:
            raise TemporalTilingError(
                f"input field {f.name_hint!r} is never loaded"
            )
    for f in out_fields:
        if f in load_of_field:
            raise TemporalTilingError(
                f"field {f.name_hint!r} is both loaded and stored "
                "(read-modify-write steps cannot be epoch-unrolled)"
            )
    # output i rotates into input slot p-q+i (the rotation drops the q
    # oldest buffers): bounds must line up slot-wise, including for
    # time_order >= 2 wave programs where p > q
    shift = len(in_fields) - len(out_fields)
    for i, f in enumerate(out_fields):
        want = load_of_field[in_fields[shift + i]].type.bounds
        have = stored_val[f].type.bounds
        if want != have:
            raise TemporalTilingError(
                f"stored value bounds {have} cannot rotate into input slot "
                f"{shift + i} with bounds {want}"
            )
    return _Step(
        loads=loads,
        load_of_field=load_of_field,
        swaps=swaps,
        applies=applies,
        stores=stores,
        ret=ret,
        in_fields=in_fields,
        out_fields=out_fields,
        stored_val=stored_val,
    )


# --------------------------------------------------------------------------
# Phase 2 — accumulated halo demand over the unrolled epoch
# --------------------------------------------------------------------------


@dataclass
class _Plan:
    step: _Step
    k: int
    growth: dict   # (iteration, ApplyOp) -> (lo widths, hi widths)
    deep: dict     # load result SSAValue -> (lo widths, hi widths)

    def producer(self, j: int, v: ir.SSAValue) -> tuple:
        """Canonical (iteration, value) id of iteration ``j``'s version of
        original value ``v``, resolving time-buffer rotation: a load result
        read in iteration j > 1 is the value rotated in from iteration
        j - 1 (iteration 1 reads the real — deep-swapped — load, id 0)."""
        s = self.step
        slot = self._slot_of_load().get(v)
        if slot is None:
            return (j, v)
        if j == 1:
            return (0, v)
        p, q = len(s.in_fields), len(s.out_fields)
        if slot < p - q:  # carried state (p > q, e.g. wave): rotate through
            return self.producer(j - 1, s.load_of_field[s.in_fields[slot + q]])
        return (j - 1, s.stored_val[s.out_fields[slot - (p - q)]])

    def _slot_of_load(self) -> dict:
        if not hasattr(self, "_slots"):
            self._slots = {
                self.step.load_of_field[f]: i
                for i, f in enumerate(self.step.in_fields)
            }
        return self._slots


def _wmax(a: tuple, b: tuple) -> tuple:
    return (
        tuple(max(x, y) for x, y in zip(a[0], b[0])),
        tuple(max(x, y) for x, y in zip(a[1], b[1])),
    )


def _plan_epoch(func: ir.FuncOp, k: int) -> _Plan:
    """Backward halo-demand accounting over the k-times-unrolled chain.

    Processing iterations k→1 and applies in reverse body order guarantees
    every consumer (later applies of the same iteration, the next
    iteration via rotation, the final stores) is accounted before a
    value's demand is read.
    """
    step = _extract_step(func)
    rank = func.body.args[0].type.bounds.rank if func.body.args else 0
    zero = (tuple([0] * rank), tuple([0] * rank))
    plan = _Plan(step=step, k=k, growth={}, deep={})
    need: dict = {}

    for j in range(k, 0, -1):
        for a in reversed(step.applies):
            g = zero
            for r in a.results:
                g = _wmax(g, need.get((j, r), zero))
            plan.growth[(j, a)] = g
            exts = a.access_extents()
            for idx, o in enumerate(a.operands):
                ov = _unswapped(o, step.swaps)
                lo, hi = exts.get(idx, (tuple([0] * rank), tuple([0] * rank)))
                req = (
                    tuple(gl - l for gl, l in zip(g[0], lo)),
                    tuple(gh + h for gh, h in zip(g[1], hi)),
                )
                cid = plan.producer(j, ov)
                need[cid] = _wmax(need.get(cid, zero), req)

    for load in step.loads:
        plan.deep[load.results[0]] = need.get((0, load.results[0]), zero)
    return plan


def epoch_halo(func: ir.FuncOp, k: int) -> tuple:
    """Per-dim (lo widths, hi widths) the deepest field needs for one
    k-step epoch — the union over loaded fields of the accumulated demand.
    Works on global (pre-decompose) IR; raises ``TemporalTilingError`` for
    shapes the pass cannot epoch.  The ``Target(exchange_every=k)``
    validation entry point."""
    plan = _plan_epoch(func, k)
    rank = func.body.args[0].type.bounds.rank if func.body.args else 0
    out = (tuple([0] * rank), tuple([0] * rank))
    for widths in plan.deep.values():
        out = _wmax(out, widths)
    return out


# --------------------------------------------------------------------------
# Phase 3 — the rewrite
# --------------------------------------------------------------------------


def _clone_apply(
    apply_op: stencil.ApplyOp, operands, bounds: stencil.Bounds, j: int
) -> stencil.ApplyOp:
    new = stencil.ApplyOp(
        operands,
        bounds,
        n_results=len(apply_op.results),
        element_type=apply_op.results[0].type.element_type,
    )
    new.attributes["epoch_step"] = ir.IntAttr(j)
    body_map: dict[ir.SSAValue, ir.SSAValue] = {}
    for oa, na in zip(apply_op.body.args, new.body.args):
        body_map[oa] = na
    for body_op in apply_op.body.ops:
        new.body.add_op(body_op.clone_into(body_map))
    return new


def temporal_tile(func: ir.FuncOp, k: int) -> ir.FuncOp:
    """Rewrite a rank-local decomposed function (dmp.swap level) into one
    k-step exchange epoch; ``k == 1`` is the identity.  Preserves
    ``sym_name`` like the other canonical-path passes."""
    if k <= 1:
        return func
    plan = _plan_epoch(func, k)
    step = plan.step

    grid = boundary = None
    for swap in step.swaps.values():
        grid, boundary = swap.grid, swap.boundary
        break

    new_func = ir.FuncOp(func.sym_name, [a.type for a in func.body.args])
    block = new_func.body
    vmap: dict[ir.SSAValue, ir.SSAValue] = {}
    for oa, na in zip(func.body.args, new_func.body.args):
        vmap[oa] = na
    emitted: dict[tuple, ir.SSAValue] = {}

    # union deep widths decide the corner regime: S∘S of a star is a
    # diamond, so k >= 2 over 2+ decomposed dims reads corner halo data
    rank = func.body.args[0].type.bounds.rank if func.body.args else 0
    union = (tuple([0] * rank), tuple([0] * rank))
    for widths in plan.deep.values():
        union = _wmax(union, widths)
    deep_dims = [d for d in range(len(union[0])) if union[0][d] or union[1][d]]
    if grid is not None:
        decomposed_deep = [d for d in deep_dims if grid.axis_of_dim(d) is not None]
        corners = needs_corners(func, grid.dims) or len(decomposed_deep) >= 2
    else:
        corners = False

    # loads + one deep swap per field that the epoch reads beyond its core
    for load in step.loads:
        new_load = stencil.LoadOp(vmap[load.field])
        block.add_op(new_load)
        cur = new_load.results[0]
        lo, hi = plan.deep[load.results[0]]
        if any(lo) or any(hi):
            if grid is None:
                raise TemporalTilingError(
                    "epoch needs a halo exchange but the function carries no "
                    "dmp.swap to take the grid/boundary from — run decompose "
                    "before temporal-tile"
                )
            from repro_torch.core.passes.decompose import SlicingStrategy

            strat = SlicingStrategy(grid.shape, grid.axis_names, grid.dims)
            decls, schedule = strat.exchanges(cur.type.bounds, lo, hi, corners)
            swap = dmp.SwapOp(
                cur,
                grid,
                decls,
                result_bounds=cur.type.bounds.grow(lo, hi),
                boundary=boundary,
                schedule=schedule,
            )
            block.add_op(swap)
            cur = swap.results[0]
        emitted[(0, load.results[0])] = cur

    shard_core = (
        step.loads[0].results[0].type.bounds if step.loads else None
    )

    # the unrolled chain: k clones with value-level time-buffer rotation
    for j in range(1, k + 1):
        for a in step.applies:
            g_lo, g_hi = plan.growth[(j, a)]
            rb = a.result_bounds.grow(g_lo, g_hi)
            operands = [
                emitted[plan.producer(j, _unswapped(o, step.swaps))]
                for o in a.operands
            ]
            new_apply = _clone_apply(a, operands, rb, j)
            block.add_op(new_apply)
            for r, nr in zip(a.results, new_apply.results):
                val = nr
                if (
                    boundary == "zero"
                    and grid is not None
                    and shard_core is not None
                    and not shard_core.contains(rb)
                ):
                    mask = comm.BoundaryMaskOp(nr, shard_core, grid)
                    block.add_op(mask)
                    val = mask.results[0]
                emitted[(j, r)] = val

    # carried state (p > q, e.g. time_order-2 wave): a k-step epoch must
    # hand back the FULL rotated state, not just iteration k's outputs —
    # the caller's rotation state' = state[len(outs):] + outs then yields
    # (u_{t+k-1}, u_{t+k}) instead of the stale (u_t, u_{t+k}).  The p-q
    # intermediate values are stored into the (dead after the epoch)
    # oldest input buffers, *before* the original stores so first-store
    # order stays oldest → newest.
    p_in, q_out = len(step.in_fields), len(step.out_fields)
    for i in range(p_in - q_out):
        v = emitted[
            plan.producer(k + 1, step.load_of_field[step.in_fields[i]])
        ]
        carry_field = vmap[step.in_fields[i]]
        block.add_op(stencil.StoreOp(v, carry_field, carry_field.type.bounds))
    for st_op in step.stores:
        v = emitted[plan.producer(k, _unswapped(st_op.temp, step.swaps))]
        block.add_op(stencil.StoreOp(v, vmap[st_op.field], st_op.bounds))
    block.add_op(
        ir.ReturnOp(
            [
                emitted[plan.producer(k, _unswapped(o, step.swaps))]
                for o in step.ret.operands
            ]
        )
    )
    return new_func
