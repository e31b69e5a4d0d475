# Copied from src/repro/core/passes/fuse_epoch.py with repro. renamed to repro_torch.; keep its logic in step with that file.
"""Fuse a deep-halo epoch's apply chain into one kernel op.

``temporal-tile{k}`` unrolls an epoch into k grown ``stencil.apply``
clones (interleaved with ``comm.boundary_mask`` re-zeroing for the zero
boundary condition) — but each apply still lowers to its own kernel
dispatch.  This pass packages every **maximal contiguous run** of
apply/boundary-mask ops into a single :class:`stencil.FusedEpochOp`:

    loads … exchange … [apply, mask, apply, mask, …]  store …
                        └───── one fused_epoch ─────┘

The region holds clones of the run's ops in program order; values the
run reads from outside become block arguments, values read after the
run become results (carried through a ``stencil.fused_yield``).  The
kernel backend (``kernels/epoch_kernel.py``) then code-generates ONE
``pl.pallas_call`` for the whole region, carrying the k sub-steps'
intermediates in fast memory; interpreter backends evaluate the region
inline.

The pass is k-agnostic: it reads the ``epoch_step`` tags temporal-tile
leaves on its clones only to record the epoch depth ``k`` on the fused
op, and fusing an untiled (k=1) apply chain is legal and still collapses
n applies into one dispatch.
"""
from __future__ import annotations

from repro_torch.core import ir
from repro_torch.core.dialects import comm, stencil

_FUSABLE = (stencil.ApplyOp, comm.BoundaryMaskOp)


def _epoch_depth(run: list) -> int:
    """Epoch depth of a run: the max ``epoch_step`` tag (temporal-tile
    numbers its clones 1..k), or 1 for an untagged (untiled) chain."""
    steps = [
        op.attributes["epoch_step"].value
        for op in run
        if "epoch_step" in op.attributes
    ]
    return max(steps) if steps else 1


def fuse_epoch_kernels(func: ir.FuncOp) -> ir.FuncOp:
    """Rewrite every maximal contiguous apply/boundary-mask run into one
    :class:`stencil.FusedEpochOp`.  Pure: returns a new FuncOp."""
    ops = list(func.body.ops)

    runs: list[list] = []
    current: list = []
    for op in ops:
        if isinstance(op, _FUSABLE):
            current.append(op)
        elif current:
            runs.append(current)
            current = []
    if current:
        runs.append(current)
    if not runs:
        return func

    run_start = {id(r[0]): r for r in runs}
    in_run = {id(op) for r in runs for op in r}

    new_func = ir.FuncOp(func.sym_name, [a.type for a in func.body.args])
    value_map: dict = {
        old: new for old, new in zip(func.body.args, new_func.body.args)
    }
    for op in ops:
        run = run_start.get(id(op))
        if run is not None:
            _emit_fused(new_func.body, run, value_map)
        elif id(op) in in_run:
            continue  # non-leading member of an already-emitted run
        else:
            new_func.body.add_op(op.clone_into(value_map))
    return new_func


def _emit_fused(block: ir.Block, run: list, value_map: dict) -> None:
    member_results = {id(r) for op in run for r in op.results}
    run_ids = {id(op) for op in run}

    # Externals: values the run reads that are defined outside it
    # (loaded/exchanged temps, fields).  Order = first-read order.
    externals: list = []
    seen = set()
    for op in run:
        for operand in op.operands:
            if id(operand) in member_results or id(operand) in seen:
                continue
            seen.add(id(operand))
            externals.append(operand)

    # Escapes: run-produced values still read after the run ends.
    escapes: list = []
    for op in run:
        for res in op.results:
            if any(id(u.operation) not in run_ids for u in res.uses):
                escapes.append(res)

    fused = stencil.FusedEpochOp(
        [value_map.get(e, e) for e in externals],
        [e.type for e in escapes],
        k=_epoch_depth(run),
    )
    inner: dict = dict(zip(externals, fused.body.args))
    for op in run:
        fused.body.add_op(op.clone_into(inner))
    fused.body.add_op(stencil.FusedYieldOp([inner[e] for e in escapes]))
    block.add_op(fused)
    for old, new in zip(escapes, fused.results):
        value_map[old] = new
