# Copied from src/repro/core/passes/halo.py with repro. renamed to repro_torch.; keep its logic in step with that file.
"""Halo inference (paper sec. 4.1/4.2).

"It is possible for subsequent transforms to determine the minimal halo
shape and size that is required for distributed memory by scanning the
stencil.access offsets which are used on inputs of a stencil.apply."

``infer_apply_halo`` gives per-operand (lo, hi) extents of one apply;
``infer_field_halos`` propagates those requirements backwards through the
dataflow of a whole function, so chained applies (e.g. tracer advection's
24 dependent stencils) accumulate the halo each *value* must provide.
"""
from __future__ import annotations

from repro_torch.core import ir
from repro_torch.core.dialects import stencil


def infer_apply_halo(apply_op: stencil.ApplyOp) -> dict[int, tuple]:
    """Per-operand-index minimal halo: ``{idx: (lo, hi)}`` with lo <= 0 <= hi."""
    return apply_op.access_extents()


def _max_extent(a: tuple, b: tuple) -> tuple:
    lo = tuple(min(x, y) for x, y in zip(a[0], b[0]))
    hi = tuple(max(x, y) for x, y in zip(a[1], b[1]))
    return (lo, hi)


def infer_value_halos(func: ir.FuncOp) -> dict[ir.SSAValue, tuple]:
    """For every stencil temp/field *value* in ``func``, the halo (lo, hi)
    that its consumers read beyond the point they compute.

    This is a backward dataflow over the SSA graph: an apply that reads
    operand k with extent (lo, hi) imposes that halo on the operand value;
    a value consumed by several applies gets the union.  Store/loads
    propagate between temps and fields.
    """
    halos: dict[ir.SSAValue, tuple] = {}

    def rank_of(v: ir.SSAValue) -> int:
        return v.type.bounds.rank  # type: ignore[attr-defined]

    def zero(v: ir.SSAValue) -> tuple:
        r = rank_of(v)
        return (tuple([0] * r), tuple([0] * r))

    ops = list(func.body.ops)
    # reverse pass: consumers before producers
    for op in reversed(ops):
        if isinstance(op, stencil.ApplyOp):
            extents = infer_apply_halo(op)
            for idx, operand in enumerate(op.operands):
                ext = extents.get(idx, zero(operand))
                cur = halos.get(operand, zero(operand))
                halos[operand] = _max_extent(cur, ext)
        elif isinstance(op, stencil.LoadOp):
            # what the load's temp needs, its field must hold
            need = halos.get(op.results[0])
            if need is not None:
                cur = halos.get(op.field, zero(op.field))
                halos[op.field] = _max_extent(cur, need)
    return halos


def infer_field_halos(func: ir.FuncOp) -> dict[ir.SSAValue, tuple]:
    """Halo required per *field argument* of ``func`` (function inputs)."""
    value_halos = infer_value_halos(func)
    out: dict[ir.SSAValue, tuple] = {}
    for arg in func.body.args:
        if isinstance(arg.type, stencil.FieldType):
            r = arg.type.bounds.rank
            out[arg] = value_halos.get(arg, (tuple([0] * r), tuple([0] * r)))
    return out


def halo_widths(extent: tuple) -> tuple:
    """(lo, hi) signed extents -> (lo_width, hi_width) nonnegative widths."""
    lo, hi = extent
    return tuple(-l for l in lo), tuple(h for h in hi)


def needs_corners(func: ir.FuncOp, decomposed_dims: tuple) -> bool:
    """True when any access has nonzero offsets in 2+ decomposed dims
    (a *box* stencil) — then corner halo regions are read and the exchange
    schedule must fill them (sequential axis sweeps or diagonal sends)."""
    for op in func.walk():
        if isinstance(op, stencil.AccessOp):
            nz = sum(1 for d in decomposed_dims if d < len(op.offset) and op.offset[d] != 0)
            if nz >= 2:
                return True
    return False
