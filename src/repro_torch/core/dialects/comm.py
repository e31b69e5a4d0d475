# Copied from src/repro/core/dialects/comm.py with repro. renamed to repro_torch.; keep its logic in step with that file.
"""The ``comm`` dialect — the paper's ``mpi`` dialect adapted to TPU/JAX.

The paper lowers ``dmp.swap`` to MPI_Isend/Irecv/Waitall.  TPU pods have no
MPI; the ICI-native primitive for a cartesian shift is
``jax.lax.ppermute`` inside ``shard_map``.  We keep the paper's
*non-blocking* structure at the IR level so the overlap pass (beyond-paper,
the paper's explicit future work) has something to schedule around:

- ``comm.exchange_start`` extracts the send rectangle and issues the
  permute; its result is the *in-flight* halo patch (the analogue of an
  MPI request + recv buffer).
- ``comm.wait`` consumes in-flight patches and the local array and
  materializes the updated array (the analogue of MPI_Waitall + unpack).

Anything scheduled between start and wait has no data dependence on the
exchange, so XLA's latency-hiding scheduler can overlap the collective —
the dataflow counterpart of the MPI request model.

The dialect also carries the collective subset the paper's mpi dialect
exposes (allreduce, broadcast) for use by drivers (e.g. residual norms).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

from repro_torch.core.ir import Attribute, Operation, SSAValue, TypeAttribute, VerificationError
from repro_torch.core.dialects.stencil import Bounds, TempType


def permute_pairs(
    axis_shifts: Sequence[tuple],
    axis_sizes: dict,
    periodic: bool,
) -> tuple:
    """Linearized ``lax.ppermute`` (source, dest) pairs for one exchange.

    ``axis_shifts`` is ``((axis_name, step), ...)`` — the relative offset of
    the rank the data comes *from*: receiver ``me`` takes data from rank
    ``me + step`` ⇒ sender ``r`` delivers to ``r - step``.  Multi-axis
    shifts linearize row-major over the tuple of mesh axes (diagonal
    exchanges).  Non-periodic out-of-grid destinations are dropped, so
    physical-edge ranks simply receive nothing.

    Returns ``(axis_arg, pairs)`` ready for ``lax.ppermute`` — the single
    shared pair construction used by every exchange execution path
    (stencil interpreter and ``repro_torch.dist.context_parallel``).
    """
    names = tuple(a for a, _ in axis_shifts)
    steps = [s for _, s in axis_shifts]
    sizes = [axis_sizes[n] for n in names]
    pairs: list[tuple[int, int]] = []
    for lin in range(math.prod(sizes)):
        rem, coords = lin, []
        for sz in reversed(sizes):
            coords.append(rem % sz)
            rem //= sz
        coords = coords[::-1]
        dst = [c - s for c, s in zip(coords, steps)]
        if periodic:
            dst = [d % sz for d, sz in zip(dst, sizes)]
        elif any(d < 0 or d >= sz for d, sz in zip(dst, sizes)):
            continue
        lin_dst = 0
        for d, sz in zip(dst, sizes):
            lin_dst = lin_dst * sz + d
        pairs.append((lin, lin_dst))
    axis_arg = names[0] if len(names) == 1 else names
    return axis_arg, pairs


class HaloPadOp(Operation):
    """``%padded = comm.halo_pad %core`` — boundary-condition fill of the
    halo frame (zeros, or a local wrap for periodic undecomposed dims);
    decomposed-dim halos are filled by the exchanges that follow."""

    name = "comm.halo_pad"

    def __init__(
        self,
        temp: SSAValue,
        result_bounds: Bounds,
        boundary: str,
        grid,  # dmp.GridAttr
    ) -> None:
        from repro_torch.core.ir import StringAttr

        assert isinstance(temp.type, TempType)
        super().__init__(
            operands=[temp],
            result_types=[TempType(result_bounds, temp.type.element_type)],
            attributes={"boundary": StringAttr(boundary), "grid": grid},
        )

    @property
    def temp(self) -> SSAValue:
        return self.operands[0]

    @property
    def boundary(self) -> str:
        return self.attributes["boundary"].value  # type: ignore[attr-defined]

    def verify_(self) -> None:
        if not self.results[0].type.bounds.contains(self.temp.type.bounds):
            raise VerificationError(
                f"comm.halo_pad result bounds {self.results[0].type.bounds} "
                f"must contain input bounds {self.temp.type.bounds}"
            )


@dataclass(frozen=True)
class InFlightType(TypeAttribute):
    """The type of an in-flight halo patch (MPI request + buffer analogue)."""

    bounds: Bounds  # rectangle being received (local coordinates)
    element_type: object

    def __hash__(self) -> int:
        return hash((InFlightType, self.bounds, self.element_type))


class ExchangeStartOp(Operation):
    """``%patch = comm.exchange_start %t {axis_name, shift, send/recv rects}``

    Sends ``send`` rectangle of ``%t`` to the rank ``shift`` steps along mesh
    axis ``axis_name``; the result is the rectangle received from the
    opposite neighbour, destined for ``recv``.  ``shift`` may be a tuple of
    (axis_name, step) pairs for diagonal exchanges (beyond-paper).
    """

    name = "comm.exchange_start"

    def __init__(
        self,
        temp: SSAValue,
        axis_shifts: Sequence[tuple],  # ((axis_name, step), ...)
        send_offset: tuple,
        recv_offset: tuple,
        size: tuple,
    ) -> None:
        assert isinstance(temp.type, TempType)
        from repro_torch.core.ir import IntAttr, StringAttr, TupleAttr

        rect = Bounds(tuple(recv_offset), tuple(o + s for o, s in zip(recv_offset, size)))
        super().__init__(
            operands=[temp],
            result_types=[InFlightType(rect, temp.type.element_type)],
            attributes={
                "axis_shifts": TupleAttr(
                    tuple(
                        TupleAttr((StringAttr(a), IntAttr(int(s))))
                        for a, s in axis_shifts
                    )
                ),
                "send_offset": TupleAttr(tuple(IntAttr(int(o)) for o in send_offset)),
                "recv_offset": TupleAttr(tuple(IntAttr(int(o)) for o in recv_offset)),
                "size": TupleAttr(tuple(IntAttr(int(s)) for s in size)),
            },
        )

    @property
    def temp(self) -> SSAValue:
        return self.operands[0]

    @property
    def axis_shifts(self) -> tuple:
        return tuple(
            (pair[0].value, pair[1].value) for pair in self.attributes["axis_shifts"]
        )

    @property
    def send_offset(self) -> tuple:
        return tuple(a.value for a in self.attributes["send_offset"])

    @property
    def recv_offset(self) -> tuple:
        return tuple(a.value for a in self.attributes["recv_offset"])

    @property
    def size(self) -> tuple:
        return tuple(a.value for a in self.attributes["size"])


class WaitOp(Operation):
    """``%out = comm.wait %t, %patch…`` — insert received patches into the
    array (MPI_Waitall + halo unpack)."""

    name = "comm.wait"

    def __init__(self, temp: SSAValue, patches: Sequence[SSAValue]) -> None:
        assert isinstance(temp.type, TempType)
        for p in patches:
            assert isinstance(p.type, InFlightType)
        super().__init__(
            operands=[temp, *patches], result_types=[temp.type]
        )

    @property
    def temp(self) -> SSAValue:
        return self.operands[0]

    @property
    def patches(self) -> tuple:
        return tuple(self.operands[1:])

    def verify_(self) -> None:
        bounds: Bounds = self.temp.type.bounds
        for p in self.patches:
            if not bounds.contains(p.type.bounds):
                raise VerificationError(
                    f"comm.wait patch {p.type.bounds} outside array bounds {bounds}"
                )


class BoundaryMaskOp(Operation):
    """``%out = comm.boundary_mask %t {core, grid}`` — re-apply a *zero*
    (dirichlet) boundary condition to redundantly-computed points.

    Emitted by the temporal-tiling pass: an epoch's intermediate applies
    compute into the halo frame, and points that lie outside the
    *physical* (global) domain must read as the boundary value for the
    next step, exactly as a fresh ``comm.halo_pad`` would have provided.
    The op is rank-position-aware but communication-free: a point at
    local logical coordinate ``p`` along dim ``d`` sits at global
    coordinate ``axis_index * n + (p - core.lb)`` and is zeroed when that
    falls outside ``[0, grid_extent * n)``.  Points inside the physical
    domain pass through untouched (bitwise)."""

    name = "comm.boundary_mask"

    def __init__(
        self,
        temp: SSAValue,
        core: Bounds,
        grid,  # dmp.GridAttr
    ) -> None:
        assert isinstance(temp.type, TempType)
        super().__init__(
            operands=[temp],
            result_types=[temp.type],
            attributes={"core": core, "grid": grid},
        )

    @property
    def temp(self) -> SSAValue:
        return self.operands[0]

    @property
    def core(self) -> Bounds:
        return self.attributes["core"]  # type: ignore[return-value]

    @property
    def grid(self):
        return self.attributes["grid"]

    def verify_(self) -> None:
        if self.core.rank != self.temp.type.bounds.rank:
            raise VerificationError(
                f"comm.boundary_mask core rank {self.core.rank} != temp "
                f"rank {self.temp.type.bounds.rank}"
            )


class AllReduceOp(Operation):
    """``%r = comm.allreduce %v {axes, op}`` — MPI_Allreduce analogue
    (lowers to jax.lax.psum/pmax over named mesh axes)."""

    name = "comm.allreduce"

    def __init__(self, value: SSAValue, axis_names: Sequence[str], op: str = "sum") -> None:
        from repro_torch.core.ir import StringAttr, TupleAttr

        assert op in ("sum", "max", "min")
        super().__init__(
            operands=[value],
            result_types=[value.type],
            attributes={
                "axes": TupleAttr(tuple(StringAttr(a) for a in axis_names)),
                "op": StringAttr(op),
            },
        )

    @property
    def axes(self) -> tuple:
        return tuple(a.value for a in self.attributes["axes"])

    @property
    def op(self) -> str:
        return self.attributes["op"].value  # type: ignore[attr-defined]


class BroadcastOp(Operation):
    """``%r = comm.broadcast %v {root, axes}`` — MPI_Bcast analogue."""

    name = "comm.broadcast"

    def __init__(self, value: SSAValue, axis_names: Sequence[str], root: int = 0) -> None:
        from repro_torch.core.ir import IntAttr, StringAttr, TupleAttr

        super().__init__(
            operands=[value],
            result_types=[value.type],
            attributes={
                "axes": TupleAttr(tuple(StringAttr(a) for a in axis_names)),
                "root": IntAttr(root),
            },
        )
