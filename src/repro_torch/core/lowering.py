"""Executing the comm-level IR on PyTorch tensors (port of
``repro.core.lowering``).

The rank-local function — after the canonical dmp→comm lowering
(``core/passes/lower_comm.py``), so it holds comm ops and never
``dmp.swap`` — is executed op by op on tensors.  Two compute backends
share the body evaluator:

- ``torch`` — shifted slice reads evaluated eagerly (the reference);
- ``cuda``  — each ``stencil.apply`` (full, interior or boundary frame)
  goes to the hand-written CUDA kernel K1 of ``kernels/stencil_apply.py``,
  each ``stencil.fused_epoch`` to kernel K2 of ``kernels/epoch_kernel.py``.

A ``stencil.combine`` whose parts are applies read by nothing else is
assembled in place: its result is allocated once, by the first part, and
each part writes its own slice of it (K1 through a strided result, the
evaluator by a copy), so the combine itself copies nothing.  Where the
caller names a destination tensor for a field (``run_ranks``'s
``dests``), whatever is stored to that field ends in that tensor: the
apply (or in-place combine) whose whole result is stored writes straight
into it.  A captured CUDA graph relies on that to keep its results in
fixed buffers.

Halo exchanges: on one device every grid axis has size 1, so
``comm.exchange_start`` emulates the exchange locally (the patch itself
for periodic wrap, zeros for zero BC).  Over a mesh of ranks
(``StencilInterpreter.run_ranks``) one host thread runs each op on every
rank before the next, as ``lax.ppermute`` inside ``shard_map`` does:
``comm.exchange_start`` copies every rank's send rectangle to the rank
``comm.permute_pairs`` names (zeros where none sends), and
``comm.boundary_mask`` keeps the box of the rank's mesh coordinate.
``comm.wait`` inserts the patches.

Over a process mesh (one process per rank, ``dist.processes``) each
process runs its own rank: ``comm.exchange_start`` sends its send
rectangle to the paired process and receives from the process paired
with it in one ``torch.distributed.batch_isend_irecv`` (NCCL on the
card, gloo on the CPU), and the ``comm.wait`` that consumes the patch
awaits the requests, so whatever runs between the two (the interior
apply under ``overlap``) can run while the message is in flight.
``comm.allreduce`` gathers the operands of its group and reduces them
in rank order, as the single controller does.

Tensors are never written in place unless this interpreter allocated
them in the same call and no later op reads them in their old state; a
caller's tensor is never written, except a destination it names.

Slot pools: every field tensor of a call may carry one leading *slot*
dimension, ``[B, *shape]`` (the port's counterpart of the reference's
``jax.vmap`` over the compiled step: a serving pool of ``B`` independent
simulations).  Every op indexes the trailing dims, so each slot goes
through the same per-point operations as a call without the slot
dimension, and K1 and K2 advance all ``B`` slots in one launch.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.core import ir
from repro_torch.core.dialects import comm, dmp, stencil
from repro_torch.obs import trace as _obs

# --------------------------------------------------------------------------
# Shared point-function evaluator (the plain version of kernel K1)
# --------------------------------------------------------------------------

_UNARY = {
    ir.NegOp: torch.neg,
    ir.AbsOp: torch.abs,
    ir.SqrtOp: torch.sqrt,
    ir.ExpOp: torch.exp,
}
_BINARY = {
    ir.AddOp: torch.add,
    ir.SubOp: torch.sub,
    ir.MulOp: torch.mul,
    ir.DivOp: torch.div,
}


def _last_uses(ops: Sequence[ir.Operation]) -> dict:
    """Index of the last op in ``ops`` that reads each value."""
    last: dict = {}
    for i, op in enumerate(ops):
        for o in op.operands:
            last[o] = i
    return last


def eval_apply_body(
    apply_op: stencil.ApplyOp,
    operand_arrays: Sequence[torch.Tensor],
    operand_origins: Sequence[tuple],
    result_bounds: stencil.Bounds,
    device: Optional[torch.device] = None,
    lead: tuple = (),
) -> list:
    """Evaluate an apply's point function vectorized over ``result_bounds``.

    ``operand_arrays[k]`` covers logical coords starting at
    ``operand_origins[k]``; an access at offset ``o`` of operand ``k``
    becomes a slice view.  Every op is one float32 tensor op, rounded on
    its own, which is what the CUDA kernel computes point by point.
    Operands may carry leading (slot) dims before the ``rank`` indexed
    ones, and the results then carry them too; ``device`` and ``lead``
    (those dims) are only read when the apply has no operands.

    Intermediates are dropped after their last use, so the live set stays
    a few result-sized tensors however long the body is.
    """
    rb = result_bounds
    if operand_arrays:
        device = operand_arrays[0].device
        lead = tuple(operand_arrays[0].shape[: operand_arrays[0].ndim - rb.rank])
    shape = tuple(lead) + tuple(rb.shape)
    device = torch.device(device or "cpu")
    f32 = torch.float32
    ops = apply_op.body.ops
    last = _last_uses(ops)
    env: dict[ir.SSAValue, Any] = {}
    # results of arithmetic on result-sized inputs are fresh tensors; any
    # other value (a slice view of an operand, a constant, an index ramp)
    # is copied before it is returned
    fresh: set = set()

    def operand_slice(k: int, offset: tuple):
        idx = tuple(
            slice(rl + o - og, rl + o - og + n)
            for rl, o, og, n in zip(rb.lb, offset, operand_origins[k], rb.shape)
        )
        return operand_arrays[k][(Ellipsis,) + idx]

    for i, op in enumerate(ops):
        if isinstance(op, stencil.StencilReturnOp):
            outs = []
            for o in op.operands:
                v = env[o]
                if o not in fresh or tuple(v.shape) != shape or any(
                    v is w for w in outs
                ):
                    v = torch.broadcast_to(v, shape).clone(
                        memory_format=torch.contiguous_format
                    )
                outs.append(v)
            return outs
        res = op.results[0] if op.results else None
        if isinstance(op, stencil.AccessOp):
            env[res] = operand_slice(op.temp.index, op.offset)
        elif isinstance(op, stencil.IndexOp):
            d = op.dim
            view = [1] * rb.rank
            view[d] = rb.shape[d]
            io = torch.arange(rb.shape[d], dtype=f32, device=device).reshape(view)
            env[res] = io + torch.full((), rb.lb[d], dtype=f32, device=device)
        elif isinstance(op, ir.ConstantOp):
            # a fill on the device: torch.tensor would copy from pageable
            # host memory, which waits for the stream to drain
            env[res] = torch.full((), op.value, dtype=f32, device=device)
        elif type(op) in _BINARY:
            a, b = (env[o] for o in op.operands)
            env[res] = _BINARY[type(op)](a, b)
            if torch.broadcast_shapes(a.shape, b.shape) == shape:
                fresh.add(res)
        elif type(op) in _UNARY:
            a = env[op.operands[0]]
            env[res] = _UNARY[type(op)](a)
            if tuple(a.shape) == shape:
                fresh.add(res)
        elif isinstance(op, ir.SelectGeZeroOp):
            p, a, b = (env[o] for o in op.operands)
            env[res] = torch.where(p >= 0, a, b)
            if torch.broadcast_shapes(p.shape, a.shape, b.shape) == shape:
                fresh.add(res)
        else:
            raise NotImplementedError(f"apply body op {op.name}")
        for o in op.operands:
            if last.get(o) == i:
                env.pop(o, None)
    raise AssertionError("apply body missing stencil.return")


# --------------------------------------------------------------------------
# Boundary-condition fill
# --------------------------------------------------------------------------


def _pad_with_bc(x, lo: tuple, hi: tuple, grid: dmp.GridAttr, boundary: str):
    """Grow the trailing ``len(lo)`` dims of ``x`` by halo widths (a
    leading slot dim is kept as it is); wrap-fill periodic *undecomposed*
    dims locally, everything else zeros (decomposed dims are filled by
    exchanges)."""
    rank = len(lo)
    skip = x.ndim - rank
    zero_dims = range(rank)
    if boundary == "periodic":
        wrap_dims = [
            d
            for d in range(rank)
            if grid.axis_of_dim(d) is None and (lo[d] or hi[d])
        ]
        for d in wrap_dims:
            # the wrap of jnp.pad(mode="wrap"): logical index i reads i mod n
            n = x.shape[skip + d]
            idx = torch.arange(-lo[d], n + hi[d], device=x.device) % n
            x = x.index_select(skip + d, idx)
        zero_dims = [d for d in range(rank) if d not in wrap_dims]
    pad: list[int] = []  # the slot dim is not listed: F.pad leaves it whole
    for d in reversed(range(rank)):  # F.pad lists the last dim first
        pad += [lo[d], hi[d]] if d in zero_dims else [0, 0]
    if any(pad):
        x = F.pad(x, pad)
    return x


# --------------------------------------------------------------------------
# Boundary masks (comm.boundary_mask at a rank's mesh coordinate)
# --------------------------------------------------------------------------


def keep_box(op: comm.BoundaryMaskOp, coords: Optional[Mapping[str, int]] = None) -> dict:
    """The box a ``comm.boundary_mask`` keeps, as ``{dim: (lo, hi)}`` in
    the rank's local logical coordinates (points with ``lo <= x < hi`` are
    inside the physical global domain), for each dim along which the
    masked value reaches outside the core; every point is kept along the
    other dims.  ``coords`` maps a mesh axis name to this rank's
    coordinate along it (0 for every axis by default, as on one device):
    along a dim split ``g`` ways into cores of ``n``, the rank at
    coordinate ``c`` keeps ``[core.lb - c*n, core.lb - c*n + g*n)``."""
    vb: stencil.Bounds = op.temp.type.bounds
    core: stencil.Bounds = op.core
    grid: dmp.GridAttr = op.grid
    coords = coords or {}
    box = {}
    for d in range(vb.rank):
        if core.lb[d] <= vb.lb[d] and vb.ub[d] <= core.ub[d]:
            continue  # no points outside this shard's core along d
        gax = grid.axis_of_dim(d)
        n = core.ub[d] - core.lb[d]
        grid_extent = grid.shape[gax] if gax is not None else 1
        coord = coords.get(grid.axis_names[gax], 0) if grid_extent > 1 else 0
        lo = core.lb[d] - coord * n
        box[d] = (lo, lo + grid_extent * n)
    return box


def boundary_keep(op: comm.BoundaryMaskOp, shape: tuple, device,
                  coords: Optional[Mapping[str, int]] = None):
    """Boolean keep-mask broadcastable to ``shape`` (the masked value's
    bounds' shape, so to any slot pool of it too) for a boundary_mask op
    at mesh coordinate ``coords``, or ``None`` when every point is
    kept."""
    vb: stencil.Bounds = op.temp.type.bounds
    keep = None
    for d, (lo, hi) in keep_box(op, coords).items():
        view = [1] * len(shape)
        view[d] = shape[d]
        pos = torch.arange(
            shape[d], dtype=torch.int32, device=device
        ).reshape(view) + (vb.lb[d] - lo)
        k = (pos >= 0) & (pos < hi - lo)
        keep = k if keep is None else keep & k
    return keep


# --------------------------------------------------------------------------
# Function interpreter — one op-dispatch level, comm ops only
# --------------------------------------------------------------------------


@dataclasses.dataclass
class RankView:
    """One rank of a run: its index, its mesh coordinate by axis name, the
    device its tensors live on, and the state of the call on it (values,
    fields, and the values this call allocated and may write in place)."""

    rank: int
    coords: dict
    device: torch.device
    lead: tuple = ()  # the slot dim of this call's tensors, () without one
    env: dict = dataclasses.field(default_factory=dict)
    fields: dict = dataclasses.field(default_factory=dict)
    owned: set = dataclasses.field(default_factory=set)
    # field arg -> the tensor whatever is stored to that field ends in
    dests: dict = dataclasses.field(default_factory=dict)
    # in-place stencil.combine -> its result, allocated by its first part
    combined: dict = dataclasses.field(default_factory=dict)


class StencilInterpreter:
    """Interprets a rank-local, comm-lowered stencil function on tensors.

    Calling convention: positional float32 tensors for every *field*
    argument of the function; returns the updated tensors of every
    stored-to field, in first-store order.  A call may give every field
    one leading slot dim of one size ``B`` (``[B, *shape]``): each op then
    runs on all ``B`` slots at once, each slot as a call without it would.
    ``dmp.swap`` is rejected — run the dmp→comm pipeline (``lower-comm``)
    first.

    With ``distributed=True`` the function runs on every rank of a mesh at
    once (:meth:`run_ranks`): ``axis_sizes`` gives the size of each mesh
    axis, their product the number of ranks.  One host thread walks the ops in order
    and runs each op on every rank before the next, which is what
    ``lax.ppermute`` inside ``shard_map`` computes: each
    ``comm.exchange_start`` copies every rank's send rectangle and
    delivers it by ``comm.permute_pairs`` (a rank that receives nothing
    gets zeros), ``comm.boundary_mask`` and K2 keep the box of the rank's
    coordinate, ``comm.allreduce`` reduces over the ranks of its axes in
    rank order.  Every rank's work is enqueued on the current stream of
    its device.  An axis of size 1 (every axis on one device) emulates
    its exchanges locally: the patch itself for periodic wrap, zeros for
    zero BC.
    """

    def __init__(
        self,
        func: ir.FuncOp,
        axis_sizes: dict[str, int],
        distributed: bool = False,
        backend: str = "torch",
        tile: Optional[tuple] = None,
        mesh=None,
    ) -> None:
        if backend not in ("torch", "cuda"):
            raise ValueError(f"unknown backend {backend!r}")
        self.func = func
        self.axis_sizes = dict(axis_sizes)
        self.distributed = distributed
        self.backend = backend
        self.tile = tile  # K2's tile (None: its own choice); K1 takes none
        self.output_fields: list[ir.SSAValue] = []
        for op in func.body.ops:
            if isinstance(op, stencil.StoreOp) and op.field not in self.output_fields:
                self.output_fields.append(op.field)
        self._last_use = _last_uses(func.body.ops)
        self._part_of, self._covered = in_place_combines(func)
        self._stored_whole = _whole_stores(func, self._covered)
        self.n_ranks = math.prod(self.axis_sizes.values()) if distributed else 1
        # a process mesh (one process per rank): this process runs its
        # own rank, and exchanges and reductions go between processes
        self.mesh = mesh if mesh is not None and mesh.processes and distributed else None
        self.n_local = 1 if self.mesh is not None else self.n_ranks
        # open exchange windows: (rank, ExchangeStartOp result) -> obs
        # token, closed by the WaitOp consuming that patch (reset per call)
        self._open_exchanges: dict = {}
        # messages in flight: (rank, ExchangeStartOp result) -> (requests,
        # the tensors they read or write), awaited by the WaitOp consuming
        # that patch
        self._in_flight: dict = {}

    # -- public --------------------------------------------------------
    def __call__(self, *arrays):
        if self.n_local > 1:
            raise ValueError(
                f"a function distributed over {self.n_ranks} ranks runs every "
                "rank at once: call run_ranks with each rank's tensors"
            )
        return self.run_ranks([arrays], [{}])[0]

    def run_ranks(self, per_rank: Sequence[Sequence[torch.Tensor]],
                  coords: Sequence[Mapping[str, int]],
                  dests: Optional[Sequence[Mapping[int, torch.Tensor]]] = None) -> list:
        """Run the function on every rank in lockstep: ``per_rank[r]`` holds
        rank ``r``'s field tensors, ``coords[r]`` its coordinate along each
        mesh axis (over a process mesh, one entry: this process's rank).
        ``dests[r]`` (optional) maps a field's position to a tensor of its
        shape on rank ``r``'s device that what is stored to that field ends
        in (it may be the field's own tensor, never one that another
        field's tensor shares).  Every tensor of a call may carry one
        leading slot dim of one size (the same on every rank).
        Returns, per rank, the tuple the single-rank call returns."""
        if len(per_rank) != self.n_local or len(coords) != self.n_local:
            raise ValueError(
                f"{len(per_rank)} ranks of tensors and {len(coords)} coordinates "
                f"for a function over {self.n_local} ranks of this process"
            )
        fields = [
            a for a in self.func.body.args if isinstance(a.type, stencil.FieldType)
        ]
        from repro_torch.kernels.stencil_apply import split_slots

        dests = dests if dests is not None else [{}] * self.n_local
        views = []
        lead = None
        for r, (arrays, c, d) in enumerate(zip(per_rank, coords, dests)):
            if len(arrays) != len(fields):
                raise ValueError(
                    f"expected {len(fields)} field tensors, got {len(arrays)}"
                )
            if lead is None:
                rank = fields[0].type.bounds.rank if fields else 0
                slots, _ = split_slots(arrays, rank, "field tensors")
                lead = () if slots is None else (slots,)
            view = RankView(self._rank_of(c), dict(c), _common_device(arrays), lead)
            for arg, arr in zip(fields, arrays):
                expect = lead + tuple(arg.type.bounds.shape)
                if tuple(arr.shape) != expect:
                    raise ValueError(
                        f"field {arg.name_hint}: tensor shape {tuple(arr.shape)} "
                        f"!= local bounds shape {expect}"
                    )
                view.fields[arg] = arr
            for i, t in d.items():
                expect = lead + tuple(fields[i].type.bounds.shape)
                if tuple(t.shape) != expect or t.device != view.device or t.dtype != torch.float32:
                    raise ValueError(
                        f"destination of field {fields[i].name_hint}: a {t.dtype} tensor of "
                        f"shape {tuple(t.shape)} on {t.device}, expected float32 of shape "
                        f"{expect} on {view.device}"
                    )
                view.dests[fields[i]] = t
            views.append(view)
        self._open_exchanges = {}
        self._in_flight = {}
        for i, op in enumerate(self.func.body.ops):
            self._run_op(op, views, i)
            # drop what no later op reads: an unfused deep epoch then holds
            # a few of its frames at once, not all of them
            for o in op.operands:
                if self._last_use.get(o) == i:
                    for view in views:
                        view.env.pop(o, None)
        return [tuple(v.fields[f] for f in self.output_fields) for v in views]

    def kernel_applies(self) -> list:
        """The ``stencil.apply`` ops this interpreter hands to kernel K1,
        in execution order (empty for the ``torch`` backend)."""
        return [
            op
            for op in self.func.body.ops
            if isinstance(op, stencil.ApplyOp) and self._routes_to_kernel(op)
        ]

    def out_strides(self, op: stencil.ApplyOp) -> Optional[tuple]:
        """Per result of ``op``, the strides (in floats) of the tensor it is
        written into where that is a view into a larger one (its slice of
        an in-place combine's result), else ``None``; ``None`` when every
        result is contiguous.  A destination a result is stored into whole
        is contiguous."""
        out = tuple(
            _contiguous_strides(self._part_of[r].result_bounds.shape) if r in self._part_of
            else None
            for r in op.results
        )
        return out if any(o is not None for o in out) else None

    def kernel_epochs(self) -> list:
        """The ``stencil.fused_epoch`` ops this interpreter hands to kernel
        K2, in execution order (empty for the ``torch`` backend)."""
        if self.backend != "cuda":
            return []
        return [
            op for op in self.func.body.ops if isinstance(op, stencil.FusedEpochOp)
        ]

    # -- helpers ---------------------------------------------------------
    def _routes_to_kernel(self, op: stencil.ApplyOp) -> bool:
        return self.backend == "cuda"

    def _result_tensors(self, op: stencil.ApplyOp, view: RankView):
        """Per result of ``op``, the tensor it must be written into, or
        ``None`` where the backend allocates it: its slice of an in-place
        combine's result, or the destination of the field it is stored
        to whole; ``None`` when every result is the backend's."""
        out = []
        for res in op.results:
            comb = self._part_of.get(res)
            if comb is None:
                out.append(self._dest_of(res, view))
                continue
            buf = view.combined.get(comb)
            if buf is None:
                rb = comb.result_bounds
                buf = self._dest_of(comb.results[0], view)
                if buf is None:
                    alloc = torch.empty if self._covered[comb] else torch.zeros
                    buf = alloc(view.lead + tuple(rb.shape), dtype=torch.float32,
                                device=view.device)
                elif not self._covered[comb]:
                    buf.zero_()  # points no part covers are zero
                view.combined[comb] = buf
            out.append(buf[_slices(res.type.bounds, comb.result_bounds)])
        return out if any(o is not None for o in out) else None

    def _dest_of(self, value: ir.SSAValue, view: RankView):
        field = self._stored_whole.get(value)
        return None if field is None else view.dests.get(field)

    def _dead_after(self, value: ir.SSAValue, i: int) -> bool:
        return self._last_use.get(value, -1) <= i

    def _axis_size(self, name: str) -> int:
        return self.axis_sizes.get(name, 1) if self.distributed else 1

    def _rank_of(self, coords: Mapping[str, int]) -> int:
        """The row-major rank of a mesh coordinate (axes in mesh order)."""
        r = 0
        for a in self.axis_sizes:
            r = r * self._axis_size(a) + (coords.get(a, 0) if self._axis_size(a) > 1 else 0)
        return r

    # -- op execution ---------------------------------------------------
    def _run_op(self, op: ir.Operation, views: list, i: int) -> None:
        """Op ``i`` on every rank: the ops that move data between ranks see
        all of them at once, every other op runs rank by rank."""
        if isinstance(op, comm.ExchangeStartOp):
            self._exec_exchange(op, views)
        elif isinstance(op, comm.AllReduceOp):
            self._exec_allreduce(op, views)
        else:
            for view in views:
                self._exec(op, view, i)

    def _exec(self, op: ir.Operation, view: RankView, i: int) -> None:
        env, owned = view.env, view.owned
        if isinstance(op, stencil.LoadOp):
            env[op.results[0]] = view.fields[op.field]
        elif isinstance(op, stencil.ApplyOp):
            arrays = [env[o] for o in op.operands]
            origins = [o.type.bounds.lb for o in op.operands]
            out = self._result_tensors(op, view)
            if _obs.enabled():
                part = op.attributes.get("part")
                name = f"apply:{part.value if part is not None else 'full'}"
                with _obs.span(name, cat="compute", rank=view.rank,
                               ranks=self.n_ranks, shape=list(op.result_bounds.shape)):
                    outs = self._apply_backend(
                        op, arrays, origins, op.result_bounds, view.device, out, view.lead
                    )
            else:
                outs = self._apply_backend(
                    op, arrays, origins, op.result_bounds, view.device, out, view.lead
                )
            for res, arr in zip(op.results, outs):
                env[res] = arr
                owned.add(res)
        elif isinstance(op, stencil.CombineOp):
            combined = view.combined.pop(op, None)
            # in place: every part has written its slice already
            env[op.results[0]] = (
                combined if combined is not None else self._exec_combine(op, env, view.lead)
            )
            owned.add(op.results[0])
        elif isinstance(op, stencil.StoreOp):
            temp = env[op.temp]
            tb: stencil.Bounds = op.temp.type.bounds
            fb: stencil.Bounds = op.field.type.bounds
            sb: stencil.Bounds = op.bounds
            patch = temp[_slices(sb, tb)]
            # the stored tensor may be a view of ``temp`` and goes back to
            # the caller: no later op may write into ``temp`` in place
            owned.discard(op.temp)
            dest = view.dests.get(op.field)
            if dest is not None:
                if temp is not dest:  # else its producer wrote it there
                    if sb != fb and view.fields[op.field] is not dest:
                        dest.copy_(view.fields[op.field])
                    dest[_slices(sb, fb)] = patch
                view.fields[op.field] = dest
            elif sb == fb:
                # the next call hands this tensor to a kernel, which takes
                # contiguous tensors only
                view.fields[op.field] = patch.contiguous()
            else:
                # functional update: the field tensor may be the caller's
                new = view.fields[op.field].clone()
                new[_slices(sb, fb)] = patch
                view.fields[op.field] = new
        elif isinstance(op, comm.HaloPadOp):
            x = env[op.operands[0]]
            y = _exec_halo_pad(op, x)
            env[op.results[0]] = y
            if y is not x:
                owned.add(op.results[0])
        elif isinstance(op, comm.WaitOp):
            self._exec_comm_wait(op, view, i)
        elif isinstance(op, comm.BoundaryMaskOp):
            x = env[op.temp]
            y = self._exec_boundary_mask(op, x, view)
            env[op.results[0]] = y
            if y is not x:
                owned.add(op.results[0])
        elif isinstance(op, stencil.FusedEpochOp):
            if _obs.enabled():
                with _obs.span("fused_epoch", cat="compute", rank=view.rank,
                               ranks=self.n_ranks, backend=self.backend):
                    self._exec_fused_epoch(op, view)
            else:
                self._exec_fused_epoch(op, view)
        elif isinstance(op, ir.ReturnOp):
            pass
        elif isinstance(op, dmp.SwapOp):
            raise NotImplementedError(
                "dmp.swap reached the interpreter — run the canonical "
                "dmp→comm pipeline (lower-comm pass) before execution"
            )
        else:
            raise NotImplementedError(f"function-level op {op.name}")

    # -- apply backends -------------------------------------------------
    def _apply_backend(self, op, arrays, origins, rb, device, out=None, lead=()):
        """The apply's results (with the call's slot dim ``lead``), written
        into ``out``'s tensors where it names them (:meth:`_result_tensors`)."""
        if self._routes_to_kernel(op):
            from repro_torch.kernels.stencil_apply import run_apply_cuda

            return run_apply_cuda(op, arrays, origins, rb, device=device, out=out, lead=lead)
        return write_into(eval_apply_body(op, arrays, origins, rb, device=device, lead=lead), out)

    def _exec_combine(self, op: stencil.CombineOp, env, lead: tuple = ()):
        rb = op.result_bounds
        parts = [env[o] for o in op.operands]
        out = torch.zeros(lead + tuple(rb.shape), dtype=parts[0].dtype, device=parts[0].device)
        for val, part in zip(op.operands, parts):
            out[_slices(val.type.bounds, rb)] = part
        return out

    # -- comm ops (every rank at once; size-1 axes emulate locally) -------
    def _exec_exchange(self, op: comm.ExchangeStartOp, views: list) -> None:
        """``lax.ppermute`` of every rank's send rectangle: rank ``r``'s
        patch goes to the rank ``comm.permute_pairs`` pairs it with (the
        same coordinate along every other mesh axis); a rank that receives
        nothing gets zeros.  A patch between ranks of one process is a
        copy; between processes, a message (:meth:`_send_receive`)."""
        periodic = bool(op.attributes.get("periodic", ir.IntAttr(0)).value)
        names = [a for a, _ in op.axis_shifts]
        sizes = {a: self._axis_size(a) for a in names}
        _, pairs = comm.permute_pairs(op.axis_shifts, sizes, periodic)
        dest = dict(pairs)
        source = {d: s for s, d in pairs}
        local = {v.rank: v for v in views}
        origin = op.temp.type.bounds.lb
        idx = (Ellipsis,) + tuple(
            slice(o - g, o - g + s)
            for o, g, s in zip(op.send_offset, origin, op.size)
        )

        def lin_of(c):
            lin = 0
            for a in names:
                lin = lin * sizes[a] + (c.get(a, 0) if sizes[a] > 1 else 0)
            return lin

        def rank_at(c, lin):
            to = dict(c)
            for a in reversed(names):
                if sizes[a] > 1:
                    to[a] = lin % sizes[a]
                lin //= sizes[a]
            return self._rank_of(to)

        received: dict = {}
        sends, receives = [], {}
        for v in views:
            lin = lin_of(v.coords)
            if lin in dest:
                # a copy, not a view: a later wait may write into the sender's
                # tensor in place; device to device where the ranks' devices differ
                patch = v.env[op.temp][idx].clone(memory_format=torch.contiguous_format)
                to = rank_at(v.coords, dest[lin])
                if to in local:
                    received[to] = patch.to(local[to].device)
                else:
                    sends.append((patch, to))
            frm = rank_at(v.coords, source[lin]) if lin in source else None
            if frm is not None and frm not in local:
                x = v.env[op.temp]
                receives[v.rank] = (torch.empty(v.lead + tuple(op.size), dtype=x.dtype,
                                                device=x.device), frm)
        requests = self._send_receive(sends, list(receives.values()))
        keep = [p for p, _ in sends] + [b for b, _ in receives.values()]
        for v in views:
            patch = received.get(v.rank)
            if v.rank in receives:
                patch = receives[v.rank][0]
            if patch is None:
                x = v.env[op.temp]
                patch = torch.zeros(v.lead + tuple(op.size), dtype=x.dtype, device=x.device)
            v.env[op.results[0]] = patch
            if requests:
                self._in_flight[(v.rank, op.results[0])] = (requests, keep)
            if _obs.enabled():
                # the exchange window closes at the wait consuming this
                # patch; on the comm lane it shows over the interior apply
                self._open_exchanges[(v.rank, op.results[0])] = _obs.begin_window(
                    "comm.exchange", cat="comm", rank=v.rank,
                    ranks=self.n_ranks, size=list(op.size),
                )

    def _send_receive(self, sends: list, receives: list) -> list:
        """Start every ``(tensor, peer rank)`` send and receive of one
        exchange together (``torch.distributed.batch_isend_irecv``: the
        same batch on every process, so none waits on another's order);
        the requests, to be awaited where the patches are consumed.  A
        peer's process is its rank in this process's block of the world."""
        if not sends and not receives:
            return []
        import torch.distributed as dist

        base = self.mesh.process_base
        ops = [dist.P2POp(dist.isend, t, base + peer) for t, peer in sends]
        ops += [dist.P2POp(dist.irecv, t, base + peer) for t, peer in receives]
        return dist.batch_isend_irecv(ops)

    def _exec_allreduce(self, op: comm.AllReduceOp, views: list) -> None:
        """Reduce over the ranks that differ only along ``op.axes``, in rank
        order; every rank of a group gets the result on its device.  Over
        a process mesh the group's operands are gathered from its
        processes first, so the sum is the single controller's, bitwise."""
        red = {"sum": torch.add, "max": torch.maximum, "min": torch.minimum}[op.op]
        if self.mesh is not None:
            from repro_torch.dist import processes

            (v,) = views
            axes = tuple(a for a in op.axes if a in self.mesh.shape)
            group = processes.all_gather(v.env[op.operands[0]], self.mesh, axes)
            acc = group[0]
            for x in group[1:]:
                acc = red(acc, x)
            v.env[op.results[0]] = acc
            return
        axes = set(op.axes)
        groups: dict = {}
        for v in views:
            key = _coord_key({a: c for a, c in v.coords.items() if a not in axes})
            groups.setdefault(key, []).append(v)
        for group in groups.values():
            acc = group[0].env[op.operands[0]]
            for v in group[1:]:
                acc = red(acc, v.env[op.operands[0]].to(acc.device))
            for v in group:
                v.env[op.results[0]] = acc.to(v.device)

    def _exec_boundary_mask(self, op: comm.BoundaryMaskOp, x, view: RankView):
        """Zero every point outside the physical (global) domain — the
        temporal-tiling analogue of the zero-BC halo_pad, applied to
        redundantly-computed epoch intermediates."""
        keep = boundary_keep(op, tuple(op.temp.type.bounds.shape), view.device, view.coords)
        if keep is None:
            return x
        return torch.where(keep, x, torch.zeros((), dtype=x.dtype, device=x.device))

    def _exec_fused_epoch(self, op: stencil.FusedEpochOp, view: RankView) -> None:
        """Route a fused epoch through kernel K2 (``cuda`` backend) or
        evaluate its region inline (``torch``).  The boundary keep-masks
        of the rank's coordinate are built here, outside the kernel, as
        0/1 tensors for the plain version; on the card K2 tests the same
        boxes, passed as its arguments, so none are built there."""
        from repro_torch.kernels.epoch_kernel import (
            _emit_region,
            region_masks,
            run_epoch_cuda,
        )

        arrays = [view.env[o] for o in op.operands]
        device = view.device
        # escapes stored whole to a field with a destination go straight there
        out = [self._dest_of(r, view) for r in op.results]
        if self.backend == "cuda":
            masks = None if device.type == "cuda" else region_masks(op, device, view.coords)
            outs = run_epoch_cuda(op, arrays, masks, tile=self.tile, coords=view.coords, out=out)
        else:
            masks = region_masks(op, device, view.coords)
            outs = write_into(_emit_region(op, arrays, masks, lambda v: v.type.bounds), out)
        for res, arr in zip(op.results, outs):
            view.env[res] = arr

    def _exec_comm_wait(self, op: comm.WaitOp, view: RankView, i: int) -> None:
        env = view.env
        x = env[op.temp]
        if op.temp in view.owned and self._dead_after(op.temp, i):
            # allocated here and read by no later op: fill its halo in place
            out = x
        else:
            out = x.clone()
        for p in op.patches:
            requests, _ = self._in_flight.pop((view.rank, p), ((), ()))
            for req in requests:
                req.wait()  # on the card: this stream waits for the message
            out[_slices(p.type.bounds, op.temp.type.bounds)] = env[p]
            if _obs.enabled():
                _obs.end_window(self._open_exchanges.pop((view.rank, p), None))
        env[op.results[0]] = out
        view.owned.add(op.results[0])


def write_into(outs: list, out: Optional[Sequence]) -> list:
    """``outs`` with each result that ``out`` names a tensor for copied
    into that tensor (the plain versions' counterpart of a kernel writing
    its results where it is told)."""
    for j, o in enumerate(out or ()):
        if o is not None:
            o.copy_(outs[j])
            outs[j] = o
    return outs


def _slices(inner: stencil.Bounds, outer: stencil.Bounds) -> tuple:
    """The index of ``inner`` in a tensor that covers ``outer`` (its
    trailing dims: a leading slot dim is taken whole)."""
    return (Ellipsis,) + tuple(
        slice(l - o, l - o + n) for l, o, n in zip(inner.lb, outer.lb, inner.shape)
    )


def _contiguous_strides(shape: Sequence[int]) -> tuple:
    return tuple(math.prod(shape[d + 1:]) for d in range(len(shape)))


def _volume(b: stencil.Bounds) -> int:
    return math.prod(b.shape)


def in_place_combines(func: ir.FuncOp) -> tuple:
    """``({apply result: combine}, {combine: parts cover its result})`` for
    every ``stencil.combine`` that can be assembled in place: each part is
    a result of a ``stencil.apply`` read by nothing else, and no two parts
    overlap (so the order the parts are written in does not matter)."""
    part_of, covered = {}, {}
    for op in func.body.ops:
        if not isinstance(op, stencil.CombineOp):
            continue
        parts = list(op.operands)
        if not all(
            isinstance(v, ir.OpResult) and isinstance(v.op, stencil.ApplyOp) and v.num_uses == 1
            for v in parts
        ):
            continue
        bounds = [v.type.bounds for v in parts]
        if any(
            all(max(a.lb[d], b.lb[d]) < min(a.ub[d], b.ub[d]) for d in range(a.rank))
            for i, a in enumerate(bounds) for b in bounds[i + 1:]
        ):
            continue
        for v in parts:
            part_of[v] = op
        covered[op] = sum(map(_volume, bounds)) == _volume(op.result_bounds)
    return part_of, covered


def _whole_stores(func: ir.FuncOp, in_place: Mapping) -> dict:
    """``{temp: field}`` for each temp that an apply, a fused epoch or an
    in-place combine produces and that only a store reads, which writes
    the whole temp over the whole field, of a field the function never
    loads: given a destination for that field, the producer may write
    straight into it (no operand of it can read the destination)."""
    loaded = {op.field for op in func.body.ops if isinstance(op, stencil.LoadOp)}
    out = {}
    for op in func.body.ops:
        if not isinstance(op, stencil.StoreOp) or op.field in loaded:
            continue
        v, fb = op.temp, op.field.type.bounds
        if not (isinstance(v, ir.OpResult) and v.num_uses == 1
                and op.bounds == fb and v.type.bounds == fb):
            continue
        if isinstance(v.op, (stencil.ApplyOp, stencil.FusedEpochOp)) or v.op in in_place:
            out[v] = op.field
    return out


def _coord_key(coords: Mapping[str, int]) -> tuple:
    return tuple(sorted(coords.items()))


def _common_device(tensors) -> torch.device:
    """The one device of ``tensors``, all float32 (no implicit cast or
    move); the CPU when there are none."""
    devices = {t.device for t in tensors}
    if len(devices) > 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(
                f"stencil tensors must be float32, got {t.dtype} (no implicit cast)"
            )
    return devices.pop() if devices else torch.device("cpu")


def _exec_halo_pad(op: comm.HaloPadOp, x):
    ib: stencil.Bounds = op.operands[0].type.bounds
    ob: stencil.Bounds = op.results[0].type.bounds
    lo = tuple(i - o for i, o in zip(ib.lb, ob.lb))
    hi = tuple(o - i for o, i in zip(ob.ub, ib.ub))
    return _pad_with_bc(
        x, lo, hi, op.attributes["grid"], op.attributes["boundary"].value
    )


def run_func_dataflow(
    func: ir.FuncOp,
    inputs: Sequence[Any],
    axis_sizes: dict[str, int],
    distributed: bool = False,
    mesh=None,
) -> tuple:
    """Execute a *value-returning* comm-level function (temp args in,
    ``func.return`` values out) on one rank: without ``mesh`` the only
    rank (its axes of size 1); with a process mesh this process's rank of
    it, its exchanges messages to the processes of its neighbours
    (``axis_sizes`` then are the mesh's)."""
    if mesh is not None and mesh.processes:
        interp = StencilInterpreter(func, axis_sizes=dict(mesh.shape), distributed=True,
                                    mesh=mesh)
        rank = mesh.process_rank
        view = RankView(rank, mesh.coords(rank), _common_device(inputs),
                        env=dict(zip(func.body.args, inputs)))
    else:
        interp = StencilInterpreter(func, axis_sizes=axis_sizes, distributed=distributed)
        if interp.n_ranks > 1:
            raise ValueError("run_func_dataflow runs one rank; its axes must have size 1, or "
                             "pass the process mesh it runs this process's rank of")
        view = RankView(0, {}, _common_device(inputs), env=dict(zip(func.body.args, inputs)))
    for i, op in enumerate(func.body.ops):
        if isinstance(op, ir.ReturnOp):
            return tuple(view.env[o] for o in op.operands)
        interp._run_op(op, [view], i)
    raise AssertionError(f"{func.sym_name}: missing func.return")


def run_func_dataflow_ranks(
    func: ir.FuncOp,
    per_rank: Sequence[Sequence[Any]],
    coords: Sequence[Mapping[str, int]],
    axis_sizes: dict[str, int],
) -> list:
    """Execute a *value-returning* comm-level function on every rank of a
    mesh in lockstep (:meth:`StencilInterpreter.run_ranks` for a function
    of temps): ``per_rank[r]`` holds rank ``r``'s arguments, ``coords[r]``
    its coordinate along each mesh axis.  Returns, per rank, the tuple of
    ``func.return`` values."""
    interp = StencilInterpreter(func, axis_sizes=axis_sizes, distributed=True)
    if len(per_rank) != interp.n_ranks or len(coords) != interp.n_ranks:
        raise ValueError(
            f"{len(per_rank)} ranks of tensors and {len(coords)} coordinates "
            f"for a function over {interp.n_ranks} ranks"
        )
    views = [
        RankView(r, dict(c), _common_device(ins), env=dict(zip(func.body.args, ins)))
        for r, (ins, c) in enumerate(zip(per_rank, coords))
    ]
    interp._open_exchanges = {}
    for i, op in enumerate(func.body.ops):
        if isinstance(op, ir.ReturnOp):
            return [tuple(v.env[o] for o in op.operands) for v in views]
        interp._run_op(op, views, i)
    raise AssertionError(f"{func.sym_name}: missing func.return")
