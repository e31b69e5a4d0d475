# Copied from src/repro/core/passes/lower_comm.py with repro. renamed to repro_torch.; keep its logic in step with that file.
"""dmp → comm lowering (the paper's dmp → mpi step, fig. 4).

This is the **canonical** lowering every distributed compile takes: each
``dmp.swap`` becomes ``comm.halo_pad`` + per-round ``comm.exchange_start``
ops + a ``comm.wait`` per round, with sequential rounds chained through
the waited value (corner forwarding).  It is the explicit IR-level
analogue of the paper's temporary buffers + MPI_Isend/Irecv + Waitall.

After this pass no ``dmp.swap`` remains; the interpreter
(``core/lowering.py``) executes comm ops only — there is exactly one
exchange execution path.  Overlapped swaps are consumed earlier by
``split_overlapped_applies`` (``core/passes/overlap.py``), which emits
the same comm ops with the consumer apply split around the wait.
"""
from __future__ import annotations

import warnings

from repro_torch.core import ir
from repro_torch.core.dialects import comm, dmp


def exchange_start_for(
    decl: dmp.ExchangeDecl, swap: dmp.SwapOp, cur: ir.SSAValue
) -> comm.ExchangeStartOp:
    """Build the comm.exchange_start for one ExchangeDecl of ``swap``,
    reading the (padded) value ``cur``."""
    core_shape = swap.temp.type.bounds.shape
    shifts = tuple(
        (swap.grid.axis_names[g], step)
        for g, step in enumerate(decl.neighbor)
        if step != 0
    )
    start = comm.ExchangeStartOp(
        cur,
        shifts,
        decl.extract_offset(swap.grid, core_shape),
        decl.recv_offset,
        decl.recv_size,
    )
    start.attributes["periodic"] = ir.IntAttr(int(swap.boundary == "periodic"))
    return start


def emit_exchange_rounds(
    block: ir.Block,
    swap: dmp.SwapOp,
    cur: ir.SSAValue,
    rounds: list,
) -> ir.SSAValue:
    """Emit start*/wait per round, chaining sequential rounds through the
    waited value; returns the fully exchanged value."""
    for rnd in rounds:
        starts = [block.add_op(exchange_start_for(e, swap, cur)) for e in rnd]
        wait = comm.WaitOp(cur, [s.results[0] for s in starts])
        block.add_op(wait)
        cur = wait.results[0]
    return cur


def lower_dmp_to_comm(func: ir.FuncOp) -> ir.FuncOp:
    """Replace every dmp.swap with halo_pad + exchange_start/wait rounds.

    Preserves ``sym_name`` — the canonical lowering must not rename the
    function, so dry-runs and tests keyed by name keep working.
    """
    new_func = ir.FuncOp(func.sym_name, [a.type for a in func.body.args])
    vmap: dict[ir.SSAValue, ir.SSAValue] = {}
    for oa, na in zip(func.body.args, new_func.body.args):
        vmap[oa] = na
    block = new_func.body
    for op in func.body.ops:
        if not isinstance(op, dmp.SwapOp):
            block.add_op(op.clone_into(vmap))
            continue
        a = op.attributes.get("overlap")
        if a is not None and a.value == 1:
            warnings.warn(
                f"{func.sym_name}: overlap-tagged dmp.swap lowered as a "
                "blocking exchange — run split-overlap (or the combined "
                "'overlap' stage) before lower-comm to keep the overlap",
                stacklevel=2,
            )
        pad = comm.HaloPadOp(
            vmap[op.temp], op.result_bounds, op.boundary, op.grid
        )
        block.add_op(pad)
        vmap[op.results[0]] = emit_exchange_rounds(
            block, op, pad.results[0], op.rounds()
        )
    return new_func
