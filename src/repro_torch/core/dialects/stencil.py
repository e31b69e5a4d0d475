# Copied from src/repro/core/dialects/stencil.py with repro. renamed to repro_torch.; keep its logic in step with that file.
"""The ``stencil`` dialect (paper sec. 4.1).

Mirrors the Open Earth Compiler's stencil dialect with the paper's
enhancements:

- **bounds live in the types** (``FieldType``/``TempType`` carry lower/upper
  bounds), so "any operation using stencil-related types can access this
  information directly through their operands";
- **N-dimensional** (the original dialect was 3-D only);
- value semantics: ``stencil.load`` reads a field into a temp,
  ``stencil.apply`` maps a point function over temps, ``stencil.store``
  writes a temp back to a field over a user-defined range.

Coordinates are *logical*: a field allocated for a ``[0, N)`` domain with
halo ``h`` has bounds ``[-h, N+h)``.  Lowering to memory (JAX arrays) is a
simple shift by ``-lb`` — the paper's motivation for bounds-in-types.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

from repro_torch.core.ir import (
    Attribute,
    Operation,
    Region,
    ScalarType,
    SSAValue,
    TypeAttribute,
    VerificationError,
    f32,
)


@dataclass(frozen=True)
class Bounds(Attribute):
    """Logical hyper-rectangle ``[lb, ub)`` per dimension."""

    lb: tuple
    ub: tuple

    def __post_init__(self) -> None:
        assert len(self.lb) == len(self.ub)
        assert all(u >= l for l, u in zip(self.lb, self.ub)), (self.lb, self.ub)

    def __hash__(self) -> int:
        return hash((Bounds, self.lb, self.ub))

    @property
    def rank(self) -> int:
        return len(self.lb)

    @property
    def shape(self) -> tuple:
        return tuple(u - l for l, u in zip(self.lb, self.ub))

    def grow(self, lo: Sequence[int], hi: Sequence[int]) -> "Bounds":
        return Bounds(
            tuple(l - g for l, g in zip(self.lb, lo)),
            tuple(u + g for u, g in zip(self.ub, hi)),
        )

    def contains(self, other: "Bounds") -> bool:
        return all(sl <= ol for sl, ol in zip(self.lb, other.lb)) and all(
            su >= ou for su, ou in zip(self.ub, other.ub)
        )

    @staticmethod
    def from_shape(shape: Sequence[int]) -> "Bounds":
        return Bounds(tuple(0 for _ in shape), tuple(shape))


@dataclass(frozen=True)
class FieldType(TypeAttribute):
    """A memory buffer holding stencil data (``stencil.field`` in the paper)."""

    bounds: Bounds
    element_type: ScalarType = f32

    def __hash__(self) -> int:
        return hash((FieldType, self.bounds, self.element_type))

    @property
    def rank(self) -> int:
        return self.bounds.rank

    @property
    def shape(self) -> tuple:
        return self.bounds.shape


@dataclass(frozen=True)
class TempType(TypeAttribute):
    """Stencil values flowing between loads/applies/stores (value semantics)."""

    bounds: Bounds
    element_type: ScalarType = f32

    def __hash__(self) -> int:
        return hash((TempType, self.bounds, self.element_type))

    @property
    def rank(self) -> int:
        return self.bounds.rank

    @property
    def shape(self) -> tuple:
        return self.bounds.shape


class LoadOp(Operation):
    """``%t = stencil.load %field`` — read a field's values into a temp."""

    name = "stencil.load"

    def __init__(self, field: SSAValue, bounds: Optional[Bounds] = None) -> None:
        ftype = field.type
        assert isinstance(ftype, FieldType), f"stencil.load needs a field, got {ftype}"
        bounds = bounds or ftype.bounds
        super().__init__(
            operands=[field],
            result_types=[TempType(bounds, ftype.element_type)],
        )

    @property
    def field(self) -> SSAValue:
        return self.operands[0]

    def verify_(self) -> None:
        if not self.field.type.bounds.contains(self.results[0].type.bounds):
            raise VerificationError(
                f"stencil.load reads {self.results[0].type.bounds} outside "
                f"field bounds {self.field.type.bounds}"
            )


class StoreOp(Operation):
    """``stencil.store %t to %field over bounds`` — write back to memory."""

    name = "stencil.store"

    def __init__(self, temp: SSAValue, field: SSAValue, bounds: Bounds) -> None:
        assert isinstance(temp.type, TempType)
        assert isinstance(field.type, FieldType)
        super().__init__(operands=[temp, field], attributes={"bounds": bounds})

    @property
    def temp(self) -> SSAValue:
        return self.operands[0]

    @property
    def field(self) -> SSAValue:
        return self.operands[1]

    @property
    def bounds(self) -> Bounds:
        return self.attributes["bounds"]  # type: ignore[return-value]

    def verify_(self) -> None:
        if not self.field.type.bounds.contains(self.bounds):
            raise VerificationError(
                f"stencil.store range {self.bounds} outside field bounds "
                f"{self.field.type.bounds}"
            )
        if not self.temp.type.bounds.contains(self.bounds):
            raise VerificationError(
                f"stencil.store range {self.bounds} outside temp bounds "
                f"{self.temp.type.bounds}"
            )


class ApplyOp(Operation):
    """``%out… = stencil.apply(%in…) ({ point function })``.

    The region's block arguments correspond 1:1 to the operands; the point
    function is evaluated at every point of the result bounds, with
    ``stencil.access`` reading operands at relative offsets.
    """

    name = "stencil.apply"

    def __init__(
        self,
        args: Sequence[SSAValue],
        result_bounds: Bounds,
        n_results: int = 1,
        element_type: ScalarType = f32,
    ) -> None:
        region = Region.empty([a.type for a in args])
        super().__init__(
            operands=list(args),
            result_types=[TempType(result_bounds, element_type)] * n_results,
            regions=[region],
        )

    @property
    def body(self):
        return self.regions[0].block

    @property
    def result_bounds(self) -> Bounds:
        return self.results[0].type.bounds

    def accesses(self) -> list["AccessOp"]:
        return [op for op in self.body.ops if isinstance(op, AccessOp)]

    def access_extents(self) -> dict[int, tuple]:
        """Per-operand-index (lo, hi) access extents — the *halo inference*
        primitive the paper builds dmp on: "determine the minimal halo shape
        and size ... by scanning the stencil.access offsets"."""
        rank = self.result_bounds.rank
        extents: dict[int, tuple] = {}
        for acc in self.accesses():
            arg = acc.temp
            assert isinstance(arg, type(self.body.args[0])), "access of non-block-arg"
            idx = arg.index
            lo, hi = extents.get(
                idx, (tuple([0] * rank), tuple([0] * rank))
            )
            off = acc.offset
            lo = tuple(min(l, o) for l, o in zip(lo, off))
            hi = tuple(max(h, o) for h, o in zip(hi, off))
            extents[idx] = (lo, hi)
        return extents

    def verify_(self) -> None:
        if len(self.body.args) != len(self.operands):
            raise VerificationError(
                "stencil.apply region arg count != operand count"
            )
        for arg, operand in zip(self.body.args, self.operands):
            if arg.type != operand.type:
                raise VerificationError(
                    f"stencil.apply region arg type {arg.type} != operand type "
                    f"{operand.type}"
                )
        if not self.body.ops or not isinstance(self.body.ops[-1], StencilReturnOp):
            raise VerificationError("stencil.apply must end in stencil.return")
        ret = self.body.ops[-1]
        if len(ret.operands) != len(self.results):
            raise VerificationError(
                "stencil.return arity != stencil.apply result arity"
            )
        # Accessed extents must be available in operand bounds.  When the
        # operand bounds equal the result bounds (a *core* value, no explicit
        # halo), out-of-core accesses are boundary-condition reads — legal at
        # the global level; the decomposition pass materializes them via
        # dmp.swap, after which this check is enforced.
        for idx, (lo, hi) in self.access_extents().items():
            operand_bounds = self.operands[idx].type.bounds
            if operand_bounds == self.result_bounds:
                continue
            needed = Bounds(
                tuple(b + l for b, l in zip(self.result_bounds.lb, lo)),
                tuple(b + h for b, h in zip(self.result_bounds.ub, hi)),
            )
            if not operand_bounds.contains(needed):
                raise VerificationError(
                    f"stencil.apply accesses {needed} of operand {idx} with "
                    f"bounds {operand_bounds} (halo missing?)"
                )


class CombineOp(Operation):
    """``%out = stencil.combine %part…`` — assemble disjoint sub-domain
    temps into one temp covering ``result_bounds``.

    Emitted by ``split_overlapped_applies``: the interior apply and the
    boundary-frame applies each produce a rectangle of the original apply's
    domain; combine reassembles them (MLIR's ``stencil.combine``, N-ary).
    Points not covered by any part are zero.
    """

    name = "stencil.combine"

    def __init__(
        self,
        parts: Sequence[SSAValue],
        result_bounds: Bounds,
        element_type: ScalarType = f32,
    ) -> None:
        assert parts, "stencil.combine needs at least one part"
        for p in parts:
            assert isinstance(p.type, TempType)
        super().__init__(
            operands=list(parts),
            result_types=[TempType(result_bounds, element_type)],
        )

    @property
    def result_bounds(self) -> Bounds:
        return self.results[0].type.bounds

    def verify_(self) -> None:
        rb = self.result_bounds
        for p in self.operands:
            if not rb.contains(p.type.bounds):
                raise VerificationError(
                    f"stencil.combine part {p.type.bounds} outside result "
                    f"bounds {rb}"
                )


class FusedEpochOp(Operation):
    """``%out… = stencil.fused_epoch(%in…) ({ epoch body })`` — one deep-halo
    epoch's apply chain packaged for single-kernel code generation.

    Produced by the ``fuse-epoch-kernel`` pass from the k-times-unrolled
    chain that ``temporal-tile{k}`` emits: the region holds the grown
    ``stencil.apply`` clones (plus any ``comm.boundary_mask`` re-zeroing)
    in program order, with block arguments mirroring the operands (the
    values the chain reads from outside) and a ``stencil.fused_yield``
    terminator carrying the values that escape the chain.  The kernel
    backend lowers the whole region to ONE ``pl.pallas_call`` so the k
    sub-steps stay in fast memory; the interpreter backends evaluate the
    region inline.

    ``k`` records the epoch depth (1 for an untiled program — fusing a
    plain apply chain is legal and still saves dispatches).
    """

    name = "stencil.fused_epoch"

    #: region op names a fused epoch may contain (terminator last).
    FUSABLE_NAMES = ("stencil.apply", "comm.boundary_mask")

    def __init__(
        self,
        args: Sequence[SSAValue],
        result_types: Sequence[TypeAttribute],
        k: int = 1,
    ) -> None:
        from repro_torch.core.ir import IntAttr

        region = Region.empty([a.type for a in args])
        super().__init__(
            operands=list(args),
            result_types=list(result_types),
            regions=[region],
            attributes={"k": IntAttr(int(k))},
        )

    @property
    def body(self):
        return self.regions[0].block

    @property
    def k(self) -> int:
        return self.attributes["k"].value  # type: ignore[attr-defined]

    def verify_(self) -> None:
        if len(self.body.args) != len(self.operands):
            raise VerificationError(
                "stencil.fused_epoch region arg count != operand count"
            )
        for arg, operand in zip(self.body.args, self.operands):
            if arg.type != operand.type:
                raise VerificationError(
                    f"stencil.fused_epoch region arg type {arg.type} != "
                    f"operand type {operand.type}"
                )
        ops = self.body.ops
        if not ops or not isinstance(ops[-1], FusedYieldOp):
            raise VerificationError(
                "stencil.fused_epoch must end in stencil.fused_yield"
            )
        for op in ops[:-1]:
            if op.name not in self.FUSABLE_NAMES:
                raise VerificationError(
                    f"stencil.fused_epoch region holds non-fusable op "
                    f"{op.name!r}"
                )
        yielded = ops[-1].operands
        if len(yielded) != len(self.results):
            raise VerificationError(
                "stencil.fused_yield arity != stencil.fused_epoch result arity"
            )
        for y, r in zip(yielded, self.results):
            if y.type != r.type:
                raise VerificationError(
                    f"stencil.fused_yield type {y.type} != result type {r.type}"
                )


class FusedYieldOp(Operation):
    """Terminates a stencil.fused_epoch region with the escaping values."""

    name = "stencil.fused_yield"

    def __init__(self, values: Sequence[SSAValue]) -> None:
        super().__init__(operands=list(values))


class AccessOp(Operation):
    """``%v = stencil.access %t [offset]`` — read a temp at a relative offset."""

    name = "stencil.access"

    def __init__(self, temp: SSAValue, offset: Sequence[int]) -> None:
        ttype = temp.type
        assert isinstance(ttype, TempType), f"stencil.access needs a temp, got {ttype}"
        from repro_torch.core.ir import TupleAttr, IntAttr

        super().__init__(
            operands=[temp],
            result_types=[ttype.element_type],
            attributes={
                "offset": TupleAttr(tuple(IntAttr(int(o)) for o in offset))
            },
        )

    @property
    def temp(self) -> SSAValue:
        return self.operands[0]

    @property
    def offset(self) -> tuple:
        return tuple(a.value for a in self.attributes["offset"])  # type: ignore


class DynAccessOp(Operation):
    """Access at the current point plus a *runtime* index — used only by the
    frontends for boundary-condition encodings; not decomposable."""

    name = "stencil.dyn_access"

    def __init__(self, temp: SSAValue, indices: Sequence[SSAValue]) -> None:
        ttype = temp.type
        assert isinstance(ttype, TempType)
        super().__init__(
            operands=[temp, *indices], result_types=[ttype.element_type]
        )


class IndexOp(Operation):
    """``%i = stencil.index {dim}`` — the current logical index along dim."""

    name = "stencil.index"

    def __init__(self, dim: int) -> None:
        from repro_torch.core.ir import IntAttr, index

        super().__init__(result_types=[f32], attributes={"dim": IntAttr(dim)})

    @property
    def dim(self) -> int:
        return self.attributes["dim"].value  # type: ignore[attr-defined]


class StencilReturnOp(Operation):
    """Terminates a stencil.apply point function."""

    name = "stencil.return"

    def __init__(self, values: Sequence[SSAValue]) -> None:
        super().__init__(operands=list(values))
