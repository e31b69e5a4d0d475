# Copied from src/repro/core/passes/diagonal.py with repro. renamed to repro_torch.; keep its logic in step with that file.
"""Diagonal (corner) exchanges — **beyond-paper**.

The paper's standard strategy fills corner halos by *sequential* axis
sweeps (later axes forward earlier axes' halos), which serializes the
exchange rounds; it notes Devito's "3D diagonal exchanges leading to more
robust and efficient scaling" as the technique its dmp dialect cannot yet
express (sec. 6.1 / sec. 8 future work).

This pass rewrites a sequential box-stencil swap into a *concurrent* one:
face exchanges are trimmed to core width, and explicit edge/corner
exchanges are added for every combination of decomposed-dim directions.
All messages are then independent (one ppermute round), removing the
round-to-round latency chain at the cost of (tiny) extra messages.
"""
from __future__ import annotations

from itertools import product

from repro_torch.core import ir
from repro_torch.core.dialects import dmp, stencil


def use_diagonal_exchanges(func: ir.FuncOp) -> int:
    """Rewrite sequential swaps to concurrent face+corner swaps.

    Returns the number of swaps rewritten.
    """
    n = 0
    for op in list(func.body.ops):
        if not isinstance(op, dmp.SwapOp):
            continue
        if op.schedule != "sequential" or not op.exchanges:
            continue
        lo, hi = op.halo_widths()
        core: stencil.Bounds = op.temp.type.bounds
        decls = _all_direction_exchanges(op.grid, core, lo, hi)
        new_swap = dmp.SwapOp(
            op.temp,
            op.grid,
            decls,
            result_bounds=op.result_bounds,
            boundary=op.boundary,
            schedule="concurrent",
        )
        if "overlap" in op.attributes:
            new_swap.attributes["overlap"] = op.attributes["overlap"]
        func.body.insert_op_after(new_swap, op)
        op.results[0].replace_all_uses_with(new_swap.results[0])
        op.erase()
        n += 1
    return n


def _all_direction_exchanges(
    grid: dmp.GridAttr, core: stencil.Bounds, lo: tuple, hi: tuple
) -> tuple:
    """One exchange per nonzero direction vector over the decomposed dims
    (3^k - 1 directions for k decomposed dims with nonzero halos)."""
    rank = core.rank
    n = core.shape
    active_axes = [
        g
        for g, d in enumerate(grid.dims)
        if d < rank and (lo[d] > 0 or hi[d] > 0)
    ]
    decls = []
    for direction in product((-1, 0, 1), repeat=len(active_axes)):
        if all(s == 0 for s in direction):
            continue
        nbr = [0] * grid.rank
        recv_off, size, send_off = [0] * rank, [0] * rank, [0] * rank
        # non-decomposed dims and inactive dims: span core + local halo
        for k in range(rank):
            gax = grid.axis_of_dim(k)
            if gax is None or gax not in active_axes:
                recv_off[k] = core.lb[k] - lo[k]
                send_off[k] = core.lb[k] - lo[k]
                size[k] = n[k] + lo[k] + hi[k]
        ok = True
        for step, gax in zip(direction, active_axes):
            d = grid.dims[gax]
            nbr[gax] = step
            if step == -1:
                if lo[d] == 0:
                    ok = False
                    break
                recv_off[d] = core.lb[d] - lo[d]
                send_off[d] = core.lb[d]
                size[d] = lo[d]
            elif step == +1:
                if hi[d] == 0:
                    ok = False
                    break
                recv_off[d] = core.ub[d]
                send_off[d] = core.ub[d] - hi[d]
                size[d] = hi[d]
            else:
                recv_off[d] = core.lb[d]
                send_off[d] = core.lb[d]
                size[d] = n[d]
        if not ok:
            continue
        decls.append(
            dmp.ExchangeDecl(
                tuple(nbr),
                tuple(recv_off),
                tuple(size),
                tuple(send_off),
                tuple(size),
            )
        )
    return tuple(decls)
