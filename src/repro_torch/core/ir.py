# Copied from src/repro/core/ir.py with repro. renamed to repro_torch.; keep its logic in step with that file.
"""Minimal SSA+Regions IR infrastructure (an xDSL-in-miniature).

This module provides the foundational compiler-IR concepts the paper builds
on (sec. 3 "Sharing Abstractions through IRs"): *operations* chained by the
SSA *values* they define and use, *attributes* carrying static information,
*types* attached to every value, and *regions* nesting control flow under
operations.  The three dialects of the paper (``stencil``, ``dmp`` and the
message-passing dialect — here ``comm``) are defined on top of this in
``repro_torch.core.dialects``.

Design notes
------------
- Single-block regions only, matching the paper ("the abstractions we
  introduce in this paper only use regions with a single block").
- Attributes are immutable values; types are attributes.
- Operations are mutable (operands can be replaced during rewrites); the
  use-lists on values are maintained eagerly so passes can do SSA dataflow
  without separate analyses — the paper's core argument for SSA IRs.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Iterator, Optional, Sequence

# --------------------------------------------------------------------------
# Attributes & types
# --------------------------------------------------------------------------


class Attribute:
    """Base class for immutable static program information."""

    def __eq__(self, other: object) -> bool:
        return type(self) is type(other) and self.__dict__ == other.__dict__

    def __hash__(self) -> int:
        return hash((type(self), tuple(sorted(self.__dict__.items(), key=lambda kv: kv[0]))))

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        inner = ", ".join(f"{k}={v!r}" for k, v in self.__dict__.items())
        return f"{type(self).__name__}({inner})"


class TypeAttribute(Attribute):
    """Base class for value types."""


@dataclass(frozen=True, eq=True)
class IntAttr(Attribute):
    value: int

    def __hash__(self) -> int:
        return hash((IntAttr, self.value))


@dataclass(frozen=True, eq=True)
class FloatAttr(Attribute):
    value: float

    def __hash__(self) -> int:
        return hash((FloatAttr, self.value))


@dataclass(frozen=True, eq=True)
class StringAttr(Attribute):
    value: str

    def __hash__(self) -> int:
        return hash((StringAttr, self.value))


@dataclass(frozen=True, eq=True)
class TupleAttr(Attribute):
    """An ordered tuple of attributes (ArrayAttr in MLIR)."""

    values: tuple

    def __hash__(self) -> int:
        return hash((TupleAttr, self.values))

    def __iter__(self) -> Iterator:
        return iter(self.values)

    def __len__(self) -> int:
        return len(self.values)

    def __getitem__(self, i):
        return self.values[i]


class ScalarType(TypeAttribute):
    """Element types: f32/f64/bf16/i32/i64/i1/index."""

    _interned: dict = {}

    def __new__(cls, name: str):
        if name not in cls._interned:
            obj = super().__new__(cls)
            obj.name = name
            cls._interned[name] = obj
        return cls._interned[name]

    def __init__(self, name: str):
        self.name = name

    def __eq__(self, other: object) -> bool:
        return isinstance(other, ScalarType) and other.name == self.name

    def __hash__(self) -> int:
        return hash(("ScalarType", self.name))

    def __repr__(self) -> str:
        return self.name


f32 = ScalarType("f32")
f64 = ScalarType("f64")
bf16 = ScalarType("bf16")
i1 = ScalarType("i1")
i32 = ScalarType("i32")
i64 = ScalarType("i64")
index = ScalarType("index")


# --------------------------------------------------------------------------
# SSA values
# --------------------------------------------------------------------------


class SSAValue:
    """A value in SSA form: defined once, used by ``uses``."""

    _name_counter = itertools.count()

    def __init__(self, type: TypeAttribute, name_hint: str = "") -> None:
        self.type = type
        self.uses: list[Use] = []
        self.name_hint = name_hint or f"v{next(SSAValue._name_counter)}"

    def replace_all_uses_with(self, new: "SSAValue") -> None:
        for use in list(self.uses):
            use.operation.replace_operand(use.index, new)

    @property
    def num_uses(self) -> int:
        return len(self.uses)

    def __repr__(self) -> str:  # pragma: no cover
        return f"%{self.name_hint}: {self.type!r}"


class OpResult(SSAValue):
    def __init__(self, type: TypeAttribute, op: "Operation", idx: int) -> None:
        super().__init__(type)
        self.op = op
        self.index = idx


class BlockArgument(SSAValue):
    def __init__(self, type: TypeAttribute, block: "Block", idx: int) -> None:
        super().__init__(type)
        self.block = block
        self.index = idx


@dataclass
class Use:
    operation: "Operation"
    index: int


# --------------------------------------------------------------------------
# Operations, blocks, regions
# --------------------------------------------------------------------------


class Operation:
    """An SSA operation: name, operands, results, attributes, regions."""

    name: str = "builtin.unregistered"

    def __init__(
        self,
        operands: Sequence[SSAValue] = (),
        result_types: Sequence[TypeAttribute] = (),
        attributes: Optional[dict[str, Attribute]] = None,
        regions: Sequence["Region"] = (),
    ) -> None:
        self._operands: list[SSAValue] = []
        self.results: list[OpResult] = [
            OpResult(t, self, i) for i, t in enumerate(result_types)
        ]
        self.attributes: dict[str, Attribute] = dict(attributes or {})
        self.regions: list[Region] = list(regions)
        for r in self.regions:
            r.parent_op = self
        self.parent_block: Optional[Block] = None
        for v in operands:
            self._append_operand(v)

    # -- operand management (keeps use-lists consistent) --
    def _append_operand(self, v: SSAValue) -> None:
        idx = len(self._operands)
        self._operands.append(v)
        v.uses.append(Use(self, idx))

    def replace_operand(self, index: int, new: SSAValue) -> None:
        old = self._operands[index]
        old.uses = [u for u in old.uses if not (u.operation is self and u.index == index)]
        self._operands[index] = new
        new.uses.append(Use(self, index))

    def set_operands(self, new_operands: Sequence[SSAValue]) -> None:
        for i, old in enumerate(self._operands):
            old.uses = [u for u in old.uses if u.operation is not self]
        self._operands = []
        for v in new_operands:
            self._append_operand(v)

    @property
    def operands(self) -> tuple[SSAValue, ...]:
        return tuple(self._operands)

    # -- structural helpers --
    def drop_all_references(self) -> None:
        for i, old in enumerate(self._operands):
            old.uses = [u for u in old.uses if u.operation is not self]
        self._operands = []

    def erase(self) -> None:
        assert all(not r.uses for r in self.results), (
            f"erasing {self.name} whose results still have uses"
        )
        self.drop_all_references()
        if self.parent_block is not None:
            self.parent_block.ops.remove(self)
            self.parent_block = None

    def verify(self) -> None:
        """Dialect ops override ``verify_`` for op-specific invariants."""
        for region in self.regions:
            for op in region.block.ops:
                op.verify()
        self.verify_()

    def verify_(self) -> None:  # pragma: no cover - default no-op
        pass

    def walk(self) -> Iterator["Operation"]:
        yield self
        for region in self.regions:
            for op in list(region.block.ops):
                yield from op.walk()

    def clone_into(self, value_map: dict[SSAValue, SSAValue]) -> "Operation":
        """Deep-clone this op, remapping operands through ``value_map``."""
        new_regions = []
        cloned = type(self).__new__(type(self))
        Operation.__init__(
            cloned,
            operands=[value_map.get(o, o) for o in self._operands],
            result_types=[r.type for r in self.results],
            attributes=dict(self.attributes),
        )
        cloned.name = self.name
        for region in self.regions:
            new_region = Region.empty([a.type for a in region.block.args])
            for old_arg, new_arg in zip(region.block.args, new_region.block.args):
                value_map[old_arg] = new_arg
            for op in region.block.ops:
                new_region.block.add_op(op.clone_into(value_map))
            new_regions.append(new_region)
        cloned.regions = new_regions
        for r in cloned.regions:
            r.parent_op = cloned
        for old_res, new_res in zip(self.results, cloned.results):
            value_map[old_res] = new_res
        return cloned

    def __repr__(self) -> str:  # pragma: no cover
        return f"<{self.name} @{id(self):x}>"


class Block:
    def __init__(self, arg_types: Sequence[TypeAttribute] = ()) -> None:
        self.args: list[BlockArgument] = [
            BlockArgument(t, self, i) for i, t in enumerate(arg_types)
        ]
        self.ops: list[Operation] = []
        self.parent_region: Optional[Region] = None

    def add_op(self, op: Operation) -> Operation:
        self.ops.append(op)
        op.parent_block = self
        return op

    def insert_op_before(self, op: Operation, anchor: Operation) -> Operation:
        idx = self.ops.index(anchor)
        self.ops.insert(idx, op)
        op.parent_block = self
        return op

    def insert_op_after(self, op: Operation, anchor: Operation) -> Operation:
        idx = self.ops.index(anchor)
        self.ops.insert(idx + 1, op)
        op.parent_block = self
        return op


class Region:
    def __init__(self, block: Block) -> None:
        self.block = block
        block.parent_region = self
        self.parent_op: Optional[Operation] = None

    @staticmethod
    def empty(arg_types: Sequence[TypeAttribute] = ()) -> "Region":
        return Region(Block(arg_types))


# --------------------------------------------------------------------------
# Builtin container ops
# --------------------------------------------------------------------------


class ModuleOp(Operation):
    name = "builtin.module"

    def __init__(self) -> None:
        super().__init__(regions=[Region.empty()])

    @property
    def body(self) -> Block:
        return self.regions[0].block


class FuncOp(Operation):
    """func.func — the container for a stencil program."""

    name = "func.func"

    def __init__(self, sym_name: str, arg_types: Sequence[TypeAttribute]) -> None:
        super().__init__(
            attributes={"sym_name": StringAttr(sym_name)},
            regions=[Region.empty(arg_types)],
        )

    @property
    def body(self) -> Block:
        return self.regions[0].block

    @property
    def sym_name(self) -> str:
        return self.attributes["sym_name"].value  # type: ignore[attr-defined]


class ReturnOp(Operation):
    name = "func.return"

    def __init__(self, operands: Sequence[SSAValue] = ()) -> None:
        super().__init__(operands=operands)


# --------------------------------------------------------------------------
# Arith dialect (the tiny subset stencil bodies need)
# --------------------------------------------------------------------------


class ConstantOp(Operation):
    name = "arith.constant"

    def __init__(self, value: float, type: TypeAttribute = f32) -> None:
        super().__init__(
            result_types=[type], attributes={"value": FloatAttr(float(value))}
        )

    @property
    def value(self) -> float:
        return self.attributes["value"].value  # type: ignore[attr-defined]


class _BinaryOp(Operation):
    def __init__(self, lhs: SSAValue, rhs: SSAValue) -> None:
        assert lhs.type == rhs.type, (
            f"{self.name}: operand types differ: {lhs.type} vs {rhs.type}"
        )
        super().__init__(operands=[lhs, rhs], result_types=[lhs.type])


class AddOp(_BinaryOp):
    name = "arith.addf"


class SubOp(_BinaryOp):
    name = "arith.subf"


class MulOp(_BinaryOp):
    name = "arith.mulf"


class DivOp(_BinaryOp):
    name = "arith.divf"


class _UnaryOp(Operation):
    def __init__(self, v: SSAValue) -> None:
        super().__init__(operands=[v], result_types=[v.type])


class NegOp(_UnaryOp):
    name = "arith.negf"


class AbsOp(_UnaryOp):
    name = "math.absf"


class SqrtOp(_UnaryOp):
    name = "math.sqrt"


class ExpOp(_UnaryOp):
    name = "math.exp"


class SelectGeZeroOp(Operation):
    """select(pred >= 0, a, b) — enough to encode upwind/boundary conditionals."""

    name = "arith.select_ge_zero"

    def __init__(self, pred: SSAValue, a: SSAValue, b: SSAValue) -> None:
        assert a.type == b.type
        super().__init__(operands=[pred, a, b], result_types=[a.type])


BINOP_REGISTRY: dict[str, Callable] = {}


# --------------------------------------------------------------------------
# Printing (for debugging, golden tests, and fingerprinting)
# --------------------------------------------------------------------------


def print_module(root: Operation) -> str:
    """Render an op tree in generic MLIR-ish syntax.

    The output is *stable*: value numbers are assigned in traversal order,
    attributes print sorted by key, and every attribute is an immutable
    dataclass with a deterministic repr — so two structurally identical op
    trees print identically, and any op/operand/attribute difference shows
    up in the text.  ``fingerprint`` builds content hashes on top of this;
    keep the printer deterministic when extending it.
    """
    lines: list[str] = []
    names: dict[SSAValue, str] = {}
    counter = itertools.count()

    def name_of(v: SSAValue) -> str:
        if v not in names:
            names[v] = f"%{next(counter)}"
        return names[v]

    def fmt_attr(a: Any) -> str:
        if isinstance(a, StringAttr):
            return f'"{a.value}"'
        if isinstance(a, (IntAttr, FloatAttr)):
            return str(a.value)
        if isinstance(a, TupleAttr):
            return "[" + ", ".join(fmt_attr(x) for x in a.values) + "]"
        return repr(a)

    def go(op: Operation, indent: int) -> None:
        pad = "  " * indent
        res = ", ".join(name_of(r) for r in op.results)
        res = res + " = " if res else ""
        operands = ", ".join(name_of(o) for o in op.operands)
        attrs = ""
        if op.attributes:
            attrs = " {" + ", ".join(
                f"{k} = {fmt_attr(v)}" for k, v in sorted(op.attributes.items())
            ) + "}"
        types = ""
        if op.results:
            types = " : " + ", ".join(repr(r.type) for r in op.results)
        lines.append(f"{pad}{res}{op.name}({operands}){attrs}{types}")
        for region in op.regions:
            args = ", ".join(
                f"{name_of(a)}: {a.type!r}" for a in region.block.args
            )
            lines.append(f"{pad}({args}) {{")
            for inner in region.block.ops:
                go(inner, indent + 1)
            lines.append(f"{pad}}}")

    go(root, 0)
    return "\n".join(lines)


def fingerprint(root: Operation, *salt: str) -> str:
    """Stable content hash of an op tree (plus optional salt strings).

    Derived from the stable textual printer, so two structurally identical
    trees hash equal and any op/operand/attribute change produces a
    different hash.  This is the key the process-wide compile cache uses
    (``repro_torch.api``).
    """
    import hashlib

    h = hashlib.sha256(print_module(root).encode())
    for s in salt:
        h.update(b"\x00")
        h.update(s.encode())
    return h.hexdigest()[:16]


def verify_module(root: Operation) -> None:
    root.verify()
    # SSA dominance within single-block regions: uses must come after defs.
    def check_block(block: Block, visible: set[SSAValue]) -> None:
        visible = set(visible) | set(block.args)
        for op in block.ops:
            for operand in op.operands:
                if operand not in visible:
                    raise VerificationError(
                        f"operand {operand!r} of {op.name} used before definition"
                    )
            for region in op.regions:
                check_block(region.block, visible)
            visible.update(op.results)

    for region in root.regions:
        check_block(region.block, set())


class VerificationError(Exception):
    pass
