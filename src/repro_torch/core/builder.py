# Copied from src/repro/core/builder.py with repro. renamed to repro_torch.; keep its logic in step with that file.
"""IR construction helpers.

``IRBuilder`` manages an insertion point; ``Expr`` gives stencil point
functions a natural arithmetic syntax (the frontends and tests build apply
bodies with it).
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Union

from repro_torch.core import ir
from repro_torch.core.dialects import stencil


class IRBuilder:
    def __init__(self, block: ir.Block) -> None:
        self.block = block

    def insert(self, op: ir.Operation) -> ir.Operation:
        return self.block.add_op(op)

    # -- arith conveniences -------------------------------------------------
    def const(self, v: float, type=ir.f32) -> ir.SSAValue:
        return self.insert(ir.ConstantOp(v, type)).results[0]

    def add(self, a, b):
        return self.insert(ir.AddOp(a, b)).results[0]

    def sub(self, a, b):
        return self.insert(ir.SubOp(a, b)).results[0]

    def mul(self, a, b):
        return self.insert(ir.MulOp(a, b)).results[0]

    def div(self, a, b):
        return self.insert(ir.DivOp(a, b)).results[0]


Number = Union[int, float]


class Expr:
    """Arithmetic wrapper over SSA values for building apply bodies."""

    def __init__(self, builder: IRBuilder, value: ir.SSAValue) -> None:
        self.b = builder
        self.value = value

    def _coerce(self, other) -> "Expr":
        if isinstance(other, Expr):
            return other
        return Expr(self.b, self.b.const(float(other), self.value.type))

    def __add__(self, other):
        o = self._coerce(other)
        return Expr(self.b, self.b.add(self.value, o.value))

    __radd__ = __add__

    def __sub__(self, other):
        o = self._coerce(other)
        return Expr(self.b, self.b.sub(self.value, o.value))

    def __rsub__(self, other):
        o = self._coerce(other)
        return Expr(self.b, self.b.sub(o.value, self.value))

    def __mul__(self, other):
        o = self._coerce(other)
        return Expr(self.b, self.b.mul(self.value, o.value))

    __rmul__ = __mul__

    def __truediv__(self, other):
        o = self._coerce(other)
        return Expr(self.b, self.b.div(self.value, o.value))

    def __rtruediv__(self, other):
        o = self._coerce(other)
        return Expr(self.b, self.b.div(o.value, self.value))

    def __neg__(self):
        return Expr(self.b, self.b.insert(ir.NegOp(self.value)).results[0])


class ApplyArgHandle:
    """Handle to a stencil.apply operand inside the point function: ``u.at(±k)``."""

    def __init__(self, builder: IRBuilder, block_arg: ir.BlockArgument) -> None:
        self.b = builder
        self.arg = block_arg

    def at(self, *offset: int) -> Expr:
        assert isinstance(self.arg.type, stencil.TempType)
        rank = self.arg.type.rank
        if len(offset) == 1 and rank != 1 and isinstance(offset[0], (tuple, list)):
            offset = tuple(offset[0])
        assert len(offset) == rank, f"offset rank {len(offset)} != temp rank {rank}"
        acc = self.b.insert(stencil.AccessOp(self.arg, offset))
        return Expr(self.b, acc.results[0])

    def center(self) -> Expr:
        return self.at(*([0] * self.arg.type.rank))


def build_apply(
    parent: ir.Block,
    args: Sequence[ir.SSAValue],
    result_bounds: stencil.Bounds,
    point_fn: Callable[..., Union[Expr, Sequence[Expr]]],
    n_results: Optional[int] = None,
) -> ir.Operation:
    """Create a stencil.apply whose body is built by ``point_fn``.

    ``point_fn(builder, *handles)`` returns one Expr (or a sequence) — the
    value(s) of the stencil at the current point.
    """
    elem = args[0].type.element_type if args else ir.f32
    apply_op = stencil.ApplyOp(
        args, result_bounds, n_results=n_results or 1, element_type=elem
    )
    b = IRBuilder(apply_op.body)
    handles = [ApplyArgHandle(b, a) for a in apply_op.body.args]
    out = point_fn(b, *handles)
    outs = out if isinstance(out, (tuple, list)) else [out]
    if n_results is None and len(outs) != 1:
        # rebuild with correct arity
        apply_op2 = stencil.ApplyOp(
            args, result_bounds, n_results=len(outs), element_type=elem
        )
        b2 = IRBuilder(apply_op2.body)
        handles2 = [ApplyArgHandle(b2, a) for a in apply_op2.body.args]
        out2 = point_fn(b2, *handles2)
        outs2 = list(out2) if isinstance(out2, (tuple, list)) else [out2]
        b2.insert(stencil.StencilReturnOp([e.value for e in outs2]))
        parent.add_op(apply_op2)
        return apply_op2
    b.insert(stencil.StencilReturnOp([e.value for e in outs]))
    parent.add_op(apply_op)
    return apply_op
