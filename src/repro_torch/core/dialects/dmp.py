# Copied from src/repro/core/dialects/dmp.py with repro. renamed to repro_torch.; keep its logic in step with that file.
"""The ``dmp`` dialect (paper sec. 4.2) — declarative domain decomposition.

``dmp.swap`` expresses halo exchanges as *data declarations*: a cartesian
grid of ranks (``GridAttr``) plus a list of ``ExchangeDecl``s, each marking
a rectangular region to receive into, the matching region to send from, and
the relative offset of the neighbour rank (paper fig. 3).

Adaptation to JAX (DESIGN.md §2): the paper's swap mutates a memref whose
allocation already includes the halo.  JAX is functional and shard_map
wants uniform core shards, so ``dmp.swap`` consumes a *core* temp
(bounds ``[0, n)``) and returns the halo-grown temp (bounds
``[-h_lo, n + h_hi)``) whose halo regions are filled by the declared
exchanges (decomposed dims) and by the boundary condition (physical edges
and undecomposed dims).  The declarative exchange payload — rectangles +
relative neighbour offsets — is exactly the paper's.

Rectangle coordinates are in the local logical frame: core is ``[0, n)``,
halos are negative / ``>= n``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

from repro_torch.core.ir import Attribute, Operation, SSAValue, StringAttr, VerificationError
from repro_torch.core.dialects.stencil import Bounds, TempType


@dataclass(frozen=True)
class GridAttr(Attribute):
    """Cartesian topology of ranks over the decomposed dims.

    ``shape[i]`` ranks decompose array dimension ``dims[i]``; ``axis_names[i]``
    is the JAX mesh axis implementing that grid axis — the TPU analogue of an
    MPI cartesian communicator.
    """

    shape: tuple
    axis_names: tuple
    dims: tuple

    def __post_init__(self) -> None:
        assert len(self.shape) == len(self.axis_names) == len(self.dims)

    def __hash__(self) -> int:
        return hash((GridAttr, self.shape, self.axis_names, self.dims))

    @property
    def rank(self) -> int:
        return len(self.shape)

    def axis_of_dim(self, dim: int) -> Optional[int]:
        return self.dims.index(dim) if dim in self.dims else None


@dataclass(frozen=True)
class ExchangeDecl(Attribute):
    """One halo exchange (paper fig. 3).

    ``neighbor`` — relative offset of the peer rank in the *grid* (length =
    grid rank, entries in {-1, 0, +1} for the standard strategy).
    ``recv_offset/size`` — rectangle (array coords) updated with the peer's
    data; ``send_offset/size`` — rectangle sent to the same peer in return.
    """

    neighbor: tuple
    recv_offset: tuple
    recv_size: tuple
    send_offset: tuple
    send_size: tuple

    def __hash__(self) -> int:
        return hash(
            (
                ExchangeDecl,
                self.neighbor,
                self.recv_offset,
                self.recv_size,
                self.send_offset,
                self.send_size,
            )
        )

    def __post_init__(self) -> None:
        assert len(self.recv_offset) == len(self.recv_size)
        assert tuple(self.recv_size) == tuple(self.send_size), (
            "send/recv rectangles must have equal size"
        )

    def numel(self) -> int:
        n = 1
        for s in self.recv_size:
            n *= int(s)
        return n

    def is_axis_aligned(self) -> bool:
        """True when the exchange moves along exactly one grid axis (a face
        exchange); diagonal/corner exchanges (beyond-paper) are not."""
        return sum(1 for c in self.neighbor if c != 0) == 1

    def extract_offset(self, grid: "GridAttr", core_shape: tuple) -> tuple:
        """The rectangle every rank extracts so that, after the uniform-SPMD
        permute toward ``-neighbor``, each receiver's ``recv`` rectangle is
        filled: the recv rect translated into the peer's frame — the peer
        sits ``+neighbor·n`` away, so my coordinate ``c`` is its
        ``c - neighbor·n``.

        (The decl's ``send_offset`` is the *other* half of the pairwise
        exchange — the paper's "in exchange, a region ... will be sent" —
        which equals the extract rect of the opposite-direction decl.)
        """
        off = list(self.recv_offset)
        for gax, step in enumerate(self.neighbor):
            if step == 0:
                continue
            d = grid.dims[gax]
            off[d] = off[d] - step * core_shape[d]
        return tuple(off)


class SwapOp(Operation):
    """``%out = dmp.swap %in {grid, exchanges, boundary, schedule}``.

    ``%in`` holds the local core; ``%out`` is halo-grown with exchanged /
    boundary-filled halos.  ``schedule`` is ``"sequential"`` (exchange
    rounds per grid axis, later rounds forwarding earlier halos — fills
    corners without diagonal messages; the paper's standard strategy) or
    ``"concurrent"`` (all exchanges independent — star stencils, or box
    stencils after the beyond-paper diagonal-exchange rewrite).
    """

    name = "dmp.swap"

    def __init__(
        self,
        temp: SSAValue,
        grid: GridAttr,
        exchanges: Sequence[ExchangeDecl],
        result_bounds: Optional[Bounds] = None,
        boundary: str = "zero",
        schedule: str = "sequential",
    ) -> None:
        assert isinstance(temp.type, TempType)
        assert boundary in ("zero", "periodic")
        assert schedule in ("sequential", "concurrent")
        from repro_torch.core.ir import TupleAttr

        rb = result_bounds or temp.type.bounds
        super().__init__(
            operands=[temp],
            result_types=[TempType(rb, temp.type.element_type)],
            attributes={
                "grid": grid,
                "exchanges": TupleAttr(tuple(exchanges)),
                "boundary": StringAttr(boundary),
                "schedule": StringAttr(schedule),
            },
        )

    @property
    def temp(self) -> SSAValue:
        return self.operands[0]

    @property
    def grid(self) -> GridAttr:
        return self.attributes["grid"]  # type: ignore[return-value]

    @property
    def exchanges(self) -> tuple:
        return tuple(self.attributes["exchanges"])  # type: ignore[arg-type]

    @property
    def boundary(self) -> str:
        return self.attributes["boundary"].value  # type: ignore[attr-defined]

    @property
    def schedule(self) -> str:
        return self.attributes["schedule"].value  # type: ignore[attr-defined]

    @property
    def result_bounds(self) -> Bounds:
        return self.results[0].type.bounds

    def halo_widths(self) -> tuple:
        """(lo_widths, hi_widths) grown by this swap, per array dim."""
        ib: Bounds = self.temp.type.bounds
        ob: Bounds = self.result_bounds
        lo = tuple(i - o for i, o in zip(ib.lb, ob.lb))
        hi = tuple(o - i for o, i in zip(ob.ub, ib.ub))
        return lo, hi

    def total_exchange_elems(self) -> int:
        return sum(e.numel() for e in self.exchanges)

    def rounds(self) -> list:
        """Group exchanges into dependency rounds.

        Sequential: one round per grid axis, in sweep order (later rounds
        read halos written by earlier ones — corner forwarding).
        Concurrent: all exchanges in one independent round.
        """
        if self.schedule == "concurrent":
            return [list(self.exchanges)]
        by_axis: dict[int, list[ExchangeDecl]] = {}
        for e in self.exchanges:
            active = [g for g, s in enumerate(e.neighbor) if s != 0]
            assert len(active) == 1, "sequential schedule expects face exchanges"
            by_axis.setdefault(active[0], []).append(e)
        return [by_axis[g] for g in sorted(by_axis)]

    def verify_(self) -> None:
        ib: Bounds = self.temp.type.bounds
        ob: Bounds = self.result_bounds
        if not ob.contains(ib):
            raise VerificationError(
                f"dmp.swap result bounds {ob} must contain input bounds {ib}"
            )
        for e in self.exchanges:
            if len(e.neighbor) != self.grid.rank:
                raise VerificationError(
                    f"exchange neighbor {e.neighbor} rank != grid rank "
                    f"{self.grid.rank}"
                )
            if len(e.recv_offset) != ob.rank:
                raise VerificationError(
                    f"exchange rectangle rank {len(e.recv_offset)} != temp "
                    f"rank {ob.rank}"
                )
            for off, size, lb, ub in zip(e.recv_offset, e.recv_size, ob.lb, ob.ub):
                if off < lb or off + size > ub:
                    raise VerificationError(
                        f"exchange recv rectangle [{off}, {off + size}) "
                        f"outside result bounds [{lb}, {ub})"
                    )
