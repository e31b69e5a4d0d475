# Copied from src/repro/core/passes/cse.py with repro. renamed to repro_torch.; keep its logic in step with that file.
"""Common-subexpression elimination and dead-code elimination for apply
bodies — the paper reuses MLIR's ``cse`` out of the box; this is the same
value-numbering scheme restricted to the pure ops stencil bodies contain."""
from __future__ import annotations

from repro_torch.core import ir
from repro_torch.core.dialects import stencil


_PURE = (
    ir.ConstantOp,
    ir.AddOp,
    ir.SubOp,
    ir.MulOp,
    ir.DivOp,
    ir.NegOp,
    ir.AbsOp,
    ir.SqrtOp,
    ir.ExpOp,
    stencil.AccessOp,
    stencil.IndexOp,
)

_COMMUTATIVE = (ir.AddOp, ir.MulOp)


def _key(op: ir.Operation) -> tuple:
    operand_ids = tuple(id(o) for o in op.operands)
    if isinstance(op, _COMMUTATIVE):
        operand_ids = tuple(sorted(operand_ids))
    attrs = tuple(sorted(op.attributes.items(), key=lambda kv: kv[0]))
    return (op.name, operand_ids, attrs)


def cse_apply_bodies(func: ir.FuncOp) -> None:
    for op in func.walk():
        if isinstance(op, stencil.ApplyOp):
            _cse_block(op.body)


def _cse_block(block: ir.Block) -> None:
    seen: dict[tuple, ir.Operation] = {}
    for op in list(block.ops):
        if not isinstance(op, _PURE):
            continue
        k = _key(op)
        prev = seen.get(k)
        if prev is not None:
            for old_r, new_r in zip(op.results, prev.results):
                old_r.replace_all_uses_with(new_r)
            op.erase()
        else:
            seen[k] = op


def dce(func: ir.FuncOp) -> None:
    from repro_torch.core.passes.swap_elim import _dce_block

    for op in func.walk():
        if isinstance(op, stencil.ApplyOp):
            _dce_pure_block(op.body)
    _dce_block(func.body)


def _dce_pure_block(block: ir.Block) -> None:
    changed = True
    while changed:
        changed = False
        for op in list(reversed(block.ops)):
            if isinstance(op, stencil.StencilReturnOp):
                continue
            if all(not r.uses for r in op.results):
                op.erase()
                changed = True
