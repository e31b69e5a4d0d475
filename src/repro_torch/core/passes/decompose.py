# Copied from src/repro/core/passes/decompose.py with repro. renamed to repro_torch.; keep its logic in step with that file.
"""Global→local decomposition (paper sec. 4.2).

"We offer a shared pass that automatically prepares stencil programs for
distributed execution.  This pass is parameterized by information on the
topology of MPI ranks in the computation, along with a decomposition
strategy. ... Given this information, we equally decompose the domain
represented in stencil to a 'local' data domain ... The stencil dialect is
also responsible for adding the necessary halos to local domains.
Subsequently, dmp.swap operations are inserted, ensuring that neighboring
ranks hold the updated data before proceeding to the following stencil
computation."

The pass rewrites a *global-domain* stencil function into a *rank-local*
function (SPMD: identical on all ranks) whose temps carry local bounds and
whose halo needs are satisfied by inserted ``dmp.swap`` ops.  Halo shapes
come from ``infer_value_halos`` (access-offset scanning); swaps are
inserted for every value an apply reads with nonzero extent — including
intermediate temps between chained applies (tracer advection) — and the
redundant ones are removed by ``eliminate_redundant_swaps``.
"""
from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Optional, Sequence

from repro_torch.core import ir
from repro_torch.core.dialects import dmp, stencil
from repro_torch.core.passes.halo import halo_widths, infer_value_halos, needs_corners


@dataclass
class SlicingStrategy:
    """The paper's extensible decomposition-strategy interface, with the
    standard 1D/2D/3D equal-slicing implementation.

    ``grid_shape[i]`` ranks decompose array dimension ``dims[i]`` and map to
    JAX mesh axis ``axis_names[i]``.
    """

    grid_shape: tuple
    axis_names: tuple
    dims: Optional[tuple] = None  # default: leading len(grid_shape) dims

    def __post_init__(self) -> None:
        if self.dims is None:
            self.dims = tuple(range(len(self.grid_shape)))
        assert len(self.grid_shape) == len(self.axis_names) == len(self.dims)

    @property
    def grid(self) -> dmp.GridAttr:
        return dmp.GridAttr(
            tuple(self.grid_shape), tuple(self.axis_names), tuple(self.dims)
        )

    # -- the strategy interface the paper describes --------------------
    def local_bounds(self, global_bounds: stencil.Bounds) -> stencil.Bounds:
        """Rank-local core bounds of an equally-sliced global domain."""
        lb = list(global_bounds.lb)
        ub = list(global_bounds.ub)
        for g, d in zip(self.grid_shape, self.dims):
            if d >= len(lb):
                continue
            extent = ub[d] - lb[d]
            if lb[d] != 0:
                raise ValueError(
                    f"decomposition requires zero-based domains, got lb={lb[d]} "
                    f"in dim {d} (encode physical ghosts via boundary fill)"
                )
            if extent % g != 0:
                raise ValueError(
                    f"dim {d} extent {extent} not divisible by grid size {g}"
                )
            ub[d] = extent // g
        return stencil.Bounds(tuple(lb), tuple(ub))

    def exchanges(
        self,
        core: stencil.Bounds,
        halo_lo: tuple,
        halo_hi: tuple,
        corners: bool,
    ) -> tuple:
        """Halo-exchange declarations for a core grown by (halo_lo, halo_hi).

        Returns ``(decls, schedule)``.  Standard strategy: one exchange per
        (decomposed dim, direction).  If ``corners`` (box stencil), later
        axes span the already-filled halos of earlier axes and the schedule
        is *sequential* — the classic corner-forwarding sweep, matching the
        paper's one-exchange-per-halo baseline.  Star stencils get
        *concurrent* core-width exchanges.
        """
        rank = core.rank
        n = core.shape
        decls: list[dmp.ExchangeDecl] = []
        grid_axes_in_order = sorted(range(len(self.dims)), key=lambda i: self.dims[i])
        for round_idx, gax in enumerate(grid_axes_in_order):
            d = self.dims[gax]
            if d >= rank or (halo_lo[d] == 0 and halo_hi[d] == 0):
                continue
            # span of the rectangle in the other dims
            span_off = []
            span_size = []
            for k in range(rank):
                if k == d:
                    span_off.append(0)  # placeholder, set below
                    span_size.append(0)
                    continue
                gax_k = self.grid.axis_of_dim(k)
                earlier = (
                    gax_k is not None
                    and grid_axes_in_order.index(gax_k) < round_idx
                )
                if corners and (earlier or gax_k is None):
                    # include already-filled halos (corner forwarding)
                    span_off.append(core.lb[k] - halo_lo[k])
                    span_size.append(n[k] + halo_lo[k] + halo_hi[k])
                elif gax_k is None:
                    # undecomposed dim: include its (locally-filled) halo
                    span_off.append(core.lb[k] - halo_lo[k])
                    span_size.append(n[k] + halo_lo[k] + halo_hi[k])
                else:
                    span_off.append(core.lb[k])
                    span_size.append(n[k])

            def rect(offset_d: int, size_d: int) -> tuple:
                off = list(span_off)
                size = list(span_size)
                off[d] = offset_d
                size[d] = size_d
                return tuple(off), tuple(size)

            def nbr(step: int) -> tuple:
                v = [0] * len(self.grid_shape)
                v[gax] = step
                return tuple(v)

            if halo_lo[d] > 0:
                # receive my low halo from neighbour -1; send my low core slab
                recv_off, size = rect(core.lb[d] - halo_lo[d], halo_lo[d])
                send_off, _ = rect(core.lb[d], halo_lo[d])
                decls.append(
                    dmp.ExchangeDecl(nbr(-1), recv_off, size, send_off, size)
                )
            if halo_hi[d] > 0:
                # receive my high halo from neighbour +1; send my high core slab
                recv_off, size = rect(core.ub[d], halo_hi[d])
                send_off, _ = rect(core.ub[d] - halo_hi[d], halo_hi[d])
                decls.append(
                    dmp.ExchangeDecl(nbr(+1), recv_off, size, send_off, size)
                )
        schedule = "sequential" if corners else "concurrent"
        return tuple(decls), schedule


def make_strategy_1d(nranks: int, axis: str = "x", dim: int = 0) -> SlicingStrategy:
    return SlicingStrategy((nranks,), (axis,), (dim,))


def make_strategy_2d(shape: tuple, axes: tuple = ("x", "y"), dims=(0, 1)) -> SlicingStrategy:
    return SlicingStrategy(tuple(shape), tuple(axes), tuple(dims))


def make_strategy_3d(shape: tuple, axes: tuple = ("x", "y", "z"), dims=(0, 1, 2)) -> SlicingStrategy:
    return SlicingStrategy(tuple(shape), tuple(axes), tuple(dims))


def _localize(
    bounds: stencil.Bounds, strategy: SlicingStrategy
) -> stencil.Bounds:
    return strategy.local_bounds(bounds)


def decompose_stencil(
    func: ir.FuncOp,
    strategy: SlicingStrategy,
    boundary: str = "zero",
) -> ir.FuncOp:
    """Rewrite a global stencil function into its rank-local SPMD version."""
    value_halos = infer_value_halos(func)
    corners = needs_corners(func, strategy.dims)

    new_args: list[ir.TypeAttribute] = []
    for arg in func.body.args:
        t = arg.type
        if isinstance(t, (stencil.FieldType, stencil.TempType)):
            new_args.append(type(t)(_localize(t.bounds, strategy), t.element_type))
        else:
            new_args.append(t)
    new_func = ir.FuncOp(func.sym_name + "_local", new_args)

    vmap: dict[ir.SSAValue, ir.SSAValue] = {}
    swapped: dict[ir.SSAValue, ir.SSAValue] = {}  # old value -> swapped new value
    for old_arg, new_arg in zip(func.body.args, new_func.body.args):
        vmap[old_arg] = new_arg

    def maybe_swap(old_val: ir.SSAValue, new_val: ir.SSAValue) -> None:
        """Insert a dmp.swap after the local definition of ``new_val`` if any
        consumer reads ``old_val`` beyond its core."""
        ext = value_halos.get(old_val)
        if ext is None:
            return
        lo_w, hi_w = halo_widths(ext)
        if all(w == 0 for w in lo_w) and all(w == 0 for w in hi_w):
            return
        core: stencil.Bounds = new_val.type.bounds
        grown = core.grow(lo_w, hi_w)
        decls, schedule = strategy.exchanges(core, lo_w, hi_w, corners)
        swap = dmp.SwapOp(
            new_val,
            strategy.grid,
            decls,
            result_bounds=grown,
            boundary=boundary,
            schedule=schedule,
        )
        new_func.body.add_op(swap)
        swapped[old_val] = swap.results[0]

    def mapped_operand(old: ir.SSAValue, want_halo: bool) -> ir.SSAValue:
        if want_halo and old in swapped:
            return swapped[old]
        return vmap[old]

    for op in func.body.ops:
        if isinstance(op, stencil.LoadOp):
            new_load = stencil.LoadOp(vmap[op.field])
            new_func.body.add_op(new_load)
            vmap[op.results[0]] = new_load.results[0]
            maybe_swap(op.results[0], new_load.results[0])
        elif isinstance(op, stencil.ApplyOp):
            local_rb = _localize(op.result_bounds, strategy)
            new_operands = [
                mapped_operand(o, want_halo=True) for o in op.operands
            ]
            new_apply = stencil.ApplyOp(
                new_operands,
                local_rb,
                n_results=len(op.results),
                element_type=op.results[0].type.element_type,
            )
            body_map: dict[ir.SSAValue, ir.SSAValue] = {}
            for old_barg, new_barg in zip(op.body.args, new_apply.body.args):
                body_map[old_barg] = new_barg
            for body_op in op.body.ops:
                new_apply.body.add_op(body_op.clone_into(body_map))
            new_func.body.add_op(new_apply)
            for old_res, new_res in zip(op.results, new_apply.results):
                vmap[old_res] = new_res
                maybe_swap(old_res, new_res)
        elif isinstance(op, stencil.StoreOp):
            new_store = stencil.StoreOp(
                mapped_operand(op.temp, want_halo=False),
                vmap[op.field],
                _localize(op.bounds, strategy),
            )
            new_func.body.add_op(new_store)
        elif isinstance(op, ir.ReturnOp):
            new_func.body.add_op(
                ir.ReturnOp([mapped_operand(o, want_halo=False) for o in op.operands])
            )
        elif isinstance(op, dmp.SwapOp):
            raise ValueError("decompose_stencil expects an undecomposed function")
        else:
            cloned = op.clone_into(vmap)
            new_func.body.add_op(cloned)
    return new_func
