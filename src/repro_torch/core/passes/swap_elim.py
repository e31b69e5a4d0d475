# Copied from src/repro/core/passes/swap_elim.py with repro. renamed to repro_torch.; keep its logic in step with that file.
"""Redundant-exchange elimination (paper sec. 4.2).

"While this may generate redundant data exchanges, a subsequent pass
eliminates them via a further pass analyzing the SSA data flow."

Because our IR is pure SSA (temps are immutable values), redundancy shows
up as *structurally identical* swaps of the same value, loads of the same
field with no intervening store, and identity swaps (no exchanges, no halo
growth).  All three fall to simple dataflow analysis over the single block.
"""
from __future__ import annotations

from repro_torch.core import ir
from repro_torch.core.dialects import dmp, stencil


def eliminate_redundant_swaps(func: ir.FuncOp) -> None:
    block = func.body

    # 1. CSE loads: same field, no store to that field in between.
    current_load: dict[ir.SSAValue, ir.SSAValue] = {}
    for op in list(block.ops):
        if isinstance(op, stencil.StoreOp):
            current_load.pop(op.field, None)
        elif isinstance(op, stencil.LoadOp):
            prev = current_load.get(op.field)
            if prev is not None and prev.type == op.results[0].type:
                op.results[0].replace_all_uses_with(prev)
            else:
                current_load[op.field] = op.results[0]

    # 2. Dedupe structurally identical swaps of the same value.
    seen: dict[tuple, ir.SSAValue] = {}
    for op in list(block.ops):
        if isinstance(op, dmp.SwapOp):
            key = (
                id(op.temp),
                op.grid,
                op.exchanges,
                op.boundary,
                op.schedule,
                op.result_bounds,
            )
            prev = seen.get(key)
            if prev is not None:
                op.results[0].replace_all_uses_with(prev)
            else:
                seen[key] = op.results[0]

    # 3. Identity swaps: no exchanges and no halo growth.
    for op in list(block.ops):
        if isinstance(op, dmp.SwapOp):
            lo, hi = op.halo_widths()
            if not op.exchanges and all(w == 0 for w in lo + hi):
                op.results[0].replace_all_uses_with(op.temp)

    # 4. DCE of dead loads/swaps (and anything else without effects).
    _dce_block(block)


def _has_side_effects(op: ir.Operation) -> bool:
    return isinstance(op, (stencil.StoreOp, ir.ReturnOp, ir.FuncOp))


def _dce_block(block: ir.Block) -> None:
    changed = True
    while changed:
        changed = False
        for op in list(reversed(block.ops)):
            if _has_side_effects(op):
                continue
            if all(not r.uses for r in op.results):
                op.erase()
                changed = True


def shrink_swaps_to_consumers(func: ir.FuncOp) -> None:
    """Trim each swap's halo to what its consumers actually access.

    Decomposition sizes halos from the *pre-fusion* union of consumer
    extents; after fusion or DCE some consumers disappear, leaving swaps
    wider than needed.  Rebuilding the swap (and its consumer applies,
    whose region argument types embed the operand bounds) recovers the
    minimal exchange volume.
    """
    block = func.body
    for op in list(block.ops):
        if not isinstance(op, dmp.SwapOp):
            continue
        res = op.results[0]
        rank = res.type.bounds.rank
        lo = [0] * rank
        hi = [0] * rank
        shrinkable = True
        for use in res.uses:
            user = use.operation
            if isinstance(user, stencil.ApplyOp):
                ext = user.access_extents().get(use.index)
                if ext is None:
                    continue
                lo = [min(l, e) for l, e in zip(lo, ext[0])]
                hi = [max(h, e) for h, e in zip(hi, ext[1])]
            else:
                shrinkable = False  # stores/returns want the value as-is
                break
        if not shrinkable:
            continue
        cur_lo, cur_hi = op.halo_widths()
        want_lo = tuple(-l for l in lo)
        want_hi = tuple(hi)
        if want_lo == cur_lo and want_hi == cur_hi:
            continue
        core: stencil.Bounds = op.temp.type.bounds
        corners = op.schedule == "sequential"  # preserve the corner regime
        # re-derive exchanges with the shrunk widths via the same strategy math
        from repro_torch.core.passes.decompose import SlicingStrategy

        strat = SlicingStrategy(op.grid.shape, op.grid.axis_names, op.grid.dims)
        decls, schedule = strat.exchanges(core, want_lo, want_hi, corners)
        new_swap = dmp.SwapOp(
            op.temp,
            op.grid,
            decls,
            result_bounds=core.grow(want_lo, want_hi),
            boundary=op.boundary,
            schedule=schedule,
        )
        block.insert_op_after(new_swap, op)
        _rebuild_consumers_with(res, new_swap.results[0], block)
        if not res.uses:
            op.erase()


def _rebuild_consumers_with(
    old: ir.SSAValue, new: ir.SSAValue, block: ir.Block
) -> None:
    """Replace ``old`` with ``new`` in consumer applies, rebuilding their
    region argument types (which embed operand bounds)."""
    for use in list(old.uses):
        user = use.operation
        assert isinstance(user, stencil.ApplyOp)
        new_operands = [new if o is old else o for o in user.operands]
        rebuilt = stencil.ApplyOp(
            new_operands,
            user.result_bounds,
            n_results=len(user.results),
            element_type=user.results[0].type.element_type,
        )
        vmap: dict[ir.SSAValue, ir.SSAValue] = {}
        for ob, nb in zip(user.body.args, rebuilt.body.args):
            vmap[ob] = nb
        for body_op in user.body.ops:
            rebuilt.body.add_op(body_op.clone_into(vmap))
        block.insert_op_after(rebuilt, user)
        for old_res, new_res in zip(user.results, rebuilt.results):
            old_res.replace_all_uses_with(new_res)
        user.erase()
