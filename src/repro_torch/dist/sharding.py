"""Meshes of ranks, sharded tensors and the logical sharding rules (port
of ``repro.dist.sharding``).

One process drives every rank, as ``jax.shard_map`` drives every device
of a mesh from one program: a rank is a coordinate of a :class:`Mesh`
and the device its shard lives on.  Devices may repeat, so four ranks can
share one card (each exchange then is a copy on that card) or sit on
four cards of a node (each exchange a device-to-device copy).  A process
mesh (``dist.processes.process_mesh``) has one process per rank instead:
each process holds its own rank's shards, and what crosses ranks goes
over ``torch.distributed`` (NCCL between cards).

- :class:`Mesh` — an ndarray of ``torch.device``, one per rank, with named
  axes; ``.shape`` maps each axis name to its size, as
  ``jax.sharding.Mesh.shape`` does.
- :class:`PartitionSpec` (``P``) — per array dim, one mesh axis name, a
  tuple of names (split over their product, the first axis major) or
  ``None``: the reference's spec form.
- :class:`ShardedTensor` — a global tensor laid out over a mesh: one
  contiguous local tensor per rank, in the mesh's row-major rank order.
- :func:`reshard` / :func:`gather` — global tensors or float32 numpy
  arrays to sharded state and back.
- :func:`shard_map` — the single-controller runner: shard the arguments,
  hand every rank's local tensors to one body that runs all ranks in
  lockstep, and wrap its per-rank results.
- :func:`factor_slot_mesh` — a spatial mesh grown by a leading slot axis
  (serving slot pools), and :func:`read_row` / :func:`write_row`, one
  slot's row of a sharded ``[B, *shape]`` pool.

- stacked ranks (``shard_map(..., stacked_ranks=True)``, ranks that
  share one device): the body gets every rank's local tensor at once,
  stacked in front (:func:`stacked`: a view of the global tensor, no
  copy), and combines ranks with the collectives :func:`psum`,
  :func:`pmax`, :func:`pmean` and :func:`all_to_all` over named axes
  (plain, differentiable torch over the stacked dims) and
  :func:`own_chunk` / :func:`place_chunk` (the reference's slices at
  ``axis_index``); :func:`unstack` gives the global results back with the
  reference's gradient for replicated outputs.  The language-model mesh
  branches (flash-decode, expert parallelism) run so: one op for all
  ranks, but each product and float reduction one call per rank
  (:func:`per_rank`), so that a rank's numbers do not depend on how many
  ranks share the call.  On a single controller the ranks must
  share one device (ranks on several devices raise); on a process mesh
  the body gets this process's rank alone, with mesh dims of size 1 in
  front, and the collectives gather over process groups and reduce as
  the stacked ones do (bitwise the same forward);
- per-rank lists (the default ``shard_map``): :func:`as_views` lays a
  tensor out as views of itself (no copy) and :func:`assemble` puts a
  body's results together again, differentiably (context parallelism,
  whose exchange runs rank by rank through the interpreter).

The language-model half: :class:`ShardingRules` maps logical axis names
("batch", "embed", "mlp", ...) to mesh axes, :func:`use_mesh` activates a
mesh and its rules, :func:`_valid_spec` clamps a spec to what a shape
supports and :func:`kv_cache_layout` picks the decode cache's layout.

:func:`shard` differs from the reference on purpose.  The reference's
``jax.lax.with_sharding_constraint`` is a layout hint for GSPMD and never
changes a value; eager PyTorch has no sharding propagation, so under
:func:`use_mesh` (the weights whole) the port's ``shard`` resolves the
rules, clamps the spec, records it (see :func:`recording`; the dry run
reads the records) and returns its input unchanged, and the computation
that a mesh splits there (flash-decode over a sequence-sharded cache,
expert parallelism, context parallelism) runs per rank through
:func:`shard_map` and the collectives.

Tensor parallelism (the reference's GSPMD over ``param_pspecs``): a tree
is placed as each process's blocks of its specs (:func:`place`,
:func:`place_tree`; :func:`gather_tree` is the inverse; on a single
controller the distinct blocks are stacked, ``[*lead, *block]``), and a
step's body (:func:`tensor_parallel`) takes them as stacked ranks
(:func:`enter`), computes each rank's part one call a rank
(:func:`per_rank` with ``coords``) and runs the collectives GSPMD would
insert explicitly (:func:`psum`, :func:`all_gather`, :func:`relayout`;
``models.tp``); :func:`reduce_placed` completes a replicated block's
gradient on a process mesh.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Callable, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch.utils import _pytree as pytree


class Mesh:
    """Ranks on a grid of named axes, one ``torch.device`` each.

    ``devices`` is a nested sequence or ndarray of devices (or device
    strings) whose shape is the mesh's; rank ``r`` is the ``r``-th entry
    in row-major order, so its coordinate along each axis is
    ``np.unravel_index(r, shape)``.  Every device has one type (``cuda``
    or ``cpu``).

    A *process mesh* (``process_rank`` given; made by
    :func:`repro_torch.dist.processes.process_mesh`) has one process per
    rank: rank ``r`` is process ``r`` of the ``torch.distributed`` world,
    and this process holds rank ``process_rank`` only.  Without it one
    process (a single controller) holds every rank.  A process mesh
    smaller than the world is one block of it: rank ``r`` is process
    ``process_base + r`` (:func:`repro_torch.dist.processes.process_mesh`).
    """

    def __init__(self, devices, axis_names: Sequence[str],
                 process_rank: Optional[int] = None, process_base: int = 0) -> None:
        arr = np.asarray(devices, dtype=object)
        names = tuple(axis_names)
        if arr.ndim != len(names):
            raise ValueError(
                f"a mesh of {arr.ndim}-D devices needs {arr.ndim} axis names, got {names}"
            )
        if len(set(names)) != len(names) or not all(isinstance(n, str) and n for n in names):
            raise ValueError(f"mesh axis names must be distinct strings, got {names}")
        if arr.size == 0:
            raise ValueError("a mesh needs at least one device")
        flat = [torch.device(d) for d in arr.ravel()]
        types = {d.type for d in flat}
        if len(types) != 1 or not types <= {"cuda", "cpu"}:
            raise ValueError(
                f"a mesh takes CUDA devices or CPU devices, of one type; got {sorted(types)}"
            )
        self.devices = np.empty(arr.shape, dtype=object)
        for i, d in enumerate(flat):
            self.devices.flat[i] = d
        self.axis_names = names
        self.shape = dict(zip(names, arr.shape))
        self.size = int(arr.size)
        self.device_type = types.pop()
        if process_rank is not None and not 0 <= process_rank < self.size:
            raise ValueError(f"process rank {process_rank} outside a mesh of {self.size}")
        self.process_rank = process_rank
        self.process_base = int(process_base)  # the world rank of this block's rank 0

    @property
    def processes(self) -> bool:
        """Whether each rank is a process of its own (a process mesh)."""
        return self.process_rank is not None

    @property
    def local_ranks(self) -> tuple:
        """The ranks this process holds: every rank on a single controller,
        its own on a process mesh."""
        return (self.process_rank,) if self.processes else tuple(range(self.size))

    def device(self, rank: int) -> torch.device:
        return self.devices.flat[rank]

    def coords(self, rank: int) -> dict:
        """Rank ``rank``'s coordinate along each mesh axis, by name."""
        return {
            n: int(c) for n, c in zip(self.axis_names, np.unravel_index(rank, self.devices.shape))
        }

    def describe(self) -> str:
        """Axes, shape and devices: what a compiled artifact depends on."""
        return (
            f"axes={self.axis_names}shape={tuple(self.shape.values())}"
            f"devices={tuple(str(d) for d in self.devices.flat)}"
            + (f"processes={self.size}" if self.processes else "")
            + (f"base={self.process_base}" if self.process_base else "")
        )

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Mesh({dict(self.shape)}, devices={[str(d) for d in self.devices.flat]})"


class PartitionSpec(tuple):
    """Per array dim, the mesh axis that splits it, a tuple of axes that
    split it over their product (the first major) or ``None``:
    ``P("x", None)`` splits dim 0 over axis ``x`` and keeps dim 1 whole."""

    def __new__(cls, *entries: Optional[str]) -> "PartitionSpec":
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedTensor:
    """A global tensor of ``shape`` laid out over ``mesh`` by ``spec``:
    ``shards[i]`` is the contiguous local tensor of ``mesh.local_ranks[i]``
    (rank ``i`` on a single controller; on a process mesh the one shard
    is this process's), on that rank's device.  Ranks that differ only
    along axes the spec does not name hold equal copies."""

    mesh: Mesh
    spec: PartitionSpec
    shards: tuple
    shape: tuple

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype


def _entry_axes(entry) -> tuple:
    """The mesh axes of one spec entry: ``()``, ``(name,)`` or the tuple."""
    if entry is None:
        return ()
    return tuple(a for a in entry if a is not None) if isinstance(entry, tuple) else (entry,)


def _spec_axes(spec: Sequence) -> tuple:
    """Every mesh axis a spec names, in order."""
    return tuple(a for e in spec for a in _entry_axes(e))


def _axes_size(mesh: Mesh, axes: tuple) -> int:
    return math.prod(mesh.shape[a] for a in axes)


def _axes_index(mesh: Mesh, axes: tuple, coords: Mapping[str, int]) -> int:
    """The row-major index of ``coords`` over ``axes`` (the first major)."""
    i = 0
    for a in axes:
        i = i * mesh.shape[a] + coords[a]
    return i


def _local_slices(shape: tuple, mesh: Mesh, spec: Sequence, rank: int) -> tuple:
    """The index of rank ``rank``'s block in a global array of ``shape``."""
    coords = mesh.coords(rank)
    out = []
    for d, n in enumerate(shape):
        axes = _entry_axes(spec[d] if d < len(spec) else None)
        if not axes:
            out.append(slice(None))
            continue
        g = _axes_size(mesh, axes)
        i = _axes_index(mesh, axes, coords)
        out.append(slice(i * (n // g), (i + 1) * (n // g)))
    return tuple(out)


def _check_spec(shape: tuple, mesh: Mesh, spec: Sequence) -> None:
    if len(spec) > len(shape):
        raise ValueError(f"spec {tuple(spec)} has more entries than the shape {shape} has dims")
    named = _spec_axes(spec)
    if len(set(named)) != len(named):
        raise ValueError(f"spec {tuple(spec)} names a mesh axis twice")
    for d, entry in enumerate(spec):
        axes = _entry_axes(entry)
        for axis in axes:
            if axis not in mesh.shape:
                raise ValueError(
                    f"spec {tuple(spec)} names {axis!r}, not an axis of {mesh.axis_names}"
                )
        if axes and shape[d] % _axes_size(mesh, axes):
            raise ValueError(
                f"dim {d} extent {shape[d]} not divisible by mesh axes {axes} "
                f"of size {_axes_size(mesh, axes)}"
            )


def _as_tensor(a) -> torch.Tensor:
    if isinstance(a, ShardedTensor):
        return gather(a)
    if isinstance(a, torch.Tensor):
        return a
    if isinstance(a, np.ndarray):
        if a.dtype != np.float32:
            raise TypeError(f"expected a float32 numpy array, got {a.dtype} (no implicit cast)")
        return torch.from_numpy(np.ascontiguousarray(a))
    raise TypeError(f"expected a tensor, a float32 numpy array or a ShardedTensor, got {type(a).__name__}")


def _fresh(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A contiguous copy of ``x`` on ``device`` that shares no storage."""
    out = torch.empty(tuple(x.shape), dtype=x.dtype, device=device)
    out.copy_(x)
    return out


def _shard_one(a, mesh: Mesh, spec: Sequence) -> ShardedTensor:
    """Lay one global array out over ``mesh``; an array already laid out
    this way is returned as it is."""
    spec = PartitionSpec(*spec)
    if isinstance(a, ShardedTensor) and a.mesh is mesh and tuple(a.spec) == tuple(spec):
        return a
    x = _as_tensor(a)
    shape = tuple(x.shape)
    _check_spec(shape, mesh, spec)
    shards = tuple(
        _fresh(x[_local_slices(shape, mesh, spec, r)], mesh.device(r)) for r in mesh.local_ranks
    )
    return ShardedTensor(mesh, spec, shards, shape)


def reshard(arrays, mesh: Optional[Mesh], specs) -> tuple:
    """Place global tensors, float32 numpy arrays or sharded tensors onto
    ``mesh`` with one spec each (a :class:`ShardedTensor` per array, each
    shard a fresh contiguous tensor); with ``mesh=None``, plain tensors
    (a sharded one gathered)."""
    arrays = tuple(arrays)
    if mesh is None:
        return tuple(_as_tensor(a) for a in arrays)
    specs = tuple(specs)
    if len(arrays) != len(specs):
        raise ValueError(f"{len(arrays)} arrays for {len(specs)} partition specs")
    return tuple(_shard_one(a, mesh, s) for a, s in zip(arrays, specs))


def gather(x, device=None, *, root: Optional[int] = None) -> Optional[torch.Tensor]:
    """The global tensor of a :class:`ShardedTensor`, on ``device`` (rank
    0's device by default; this process's on a process mesh, where every
    process takes part and gets the whole tensor, or with ``root`` only
    process ``root`` does, and the others get ``None``); a plain tensor is
    returned as it is."""
    if not isinstance(x, ShardedTensor):
        return x
    mesh = x.mesh
    shards = x.shards
    if mesh.processes:
        from repro_torch.dist import processes

        (local,) = shards
        if root is None:
            shards = processes.all_gather(local, mesh)
        else:
            shards = processes.gather_to(local, mesh, root)
            if shards is None:
                return None
        device = device or local.device
    out = torch.empty(x.shape, dtype=x.dtype, device=device or mesh.device(0))
    for r in _block_ranks(x):
        out[_local_slices(x.shape, mesh, x.spec, r)].copy_(shards[r])
    return out


def _block_ranks(x: ShardedTensor) -> list:
    """One rank per block of ``x``: the rank at coordinate 0 of every axis
    the spec does not name."""
    named = set(_spec_axes(x.spec))
    return [
        r for r in range(x.mesh.size)
        if not any(c for a, c in x.mesh.coords(r).items() if a not in named)
    ]


def _global_shape(local_shape: Sequence[int], mesh: Mesh, spec: Sequence) -> tuple:
    return tuple(
        n * _axes_size(mesh, _entry_axes(spec[d] if d < len(spec) else None))
        for d, n in enumerate(local_shape)
    )


def shard_map(f: Callable, *, mesh: Mesh, in_specs: Sequence, out_specs: Sequence,
              stacked_ranks: bool = False) -> Callable:
    """The single-controller counterpart of ``jax.shard_map``.

    ``f(local)`` gets, for every rank in mesh order, the tuple of that
    rank's local tensors, runs all ranks (exchanging between them as it
    goes) and returns, per rank, a tuple of local outputs.  The returned
    function takes global arrays or :class:`ShardedTensor` s, lays each
    out by ``in_specs`` and returns a tuple of :class:`ShardedTensor` s
    laid out by ``out_specs``.

    With ``stacked_ranks=True`` (ranks that share one device) ``f`` gets
    every rank at once instead: one tensor per input, the ranks' local
    tensors stacked in front (:func:`stacked`: views of the global
    tensors, no copy), computes per rank over those leading dims with the
    stacked collectives (:func:`psum`, :func:`pmax`, :func:`pmean`,
    :func:`all_to_all`) and returns a tuple of stacked outputs; the
    function returns the global tensors (:func:`unstack`).

    On a process mesh (one process per rank, every process calling with
    the same global tensors) ``f`` runs this process's rank only: the
    per-rank list holds one entry, and a stacked body gets this rank's
    block with every mesh dim in front of size 1, so the same body runs
    unchanged and its collectives go over process groups; every process
    gets the whole results."""
    in_specs, out_specs = tuple(in_specs), tuple(out_specs)
    enter, leave = (_enter, _leave) if mesh.processes else (stacked, unstack)

    def run_stacked(*arrays):
        if len(arrays) != len(in_specs):
            raise ValueError(f"{len(arrays)} arguments for {len(in_specs)} input specs")
        outs = f(*(enter(a, mesh, s) for a, s in zip(arrays, in_specs)))
        return tuple(leave(o, mesh, s) for o, s in zip(outs, out_specs))

    if stacked_ranks:
        return run_stacked

    def run(*arrays):
        if len(arrays) != len(in_specs):
            raise ValueError(f"{len(arrays)} arguments for {len(in_specs)} input specs")
        sharded = reshard(arrays, mesh, in_specs)
        n = len(mesh.local_ranks)
        per_rank = f([tuple(s.shards[i] for s in sharded) for i in range(n)])
        if len(per_rank) != n:
            raise ValueError(f"{len(per_rank)} rank results for {n} ranks of this process")
        return tuple(
            ShardedTensor(
                mesh,
                PartitionSpec(*spec),
                tuple(p[j] for p in per_rank),
                _global_shape(per_rank[0][j].shape, mesh, spec),
            )
            for j, spec in enumerate(out_specs)
        )

    return run


def factor_slot_mesh(mesh: Mesh, slots: int = 1, axis: str = "slot", devices=None) -> Mesh:
    """Extend a spatial ``mesh`` with a leading slot axis of size ``slots``
    factored out of the device inventory.

    The slot axis carries a *batch* dimension (pooled serving slots, or
    ensemble members), not an array dimension: exchanges keep binding the
    spatial axis names, so each slot block of ``slots × spatial`` ranks
    runs the solo exchange pattern.  ``slots == 1`` reuses the mesh's own
    devices (every rank then holds all ``B`` rows of its shard);
    ``slots > 1`` takes the first ``slots * spatial`` devices of
    ``devices`` (default: ``tune.space.default_devices()``, every card),
    slot-major, so slot block 0 is the original mesh's device prefix.
    Devices may repeat, as in any :class:`Mesh`.

    A process mesh (one process a rank) grows over the world's processes
    instead, slot-major, into a process mesh ``(slot, *spatial)`` (``devices``
    is not read): ``slots × spatial`` must divide the world's processes,
    and a mesh smaller than the world is a block of it, each block running
    the same slots (``dist.processes.process_mesh``)."""
    if int(slots) != slots or slots < 1:
        raise ValueError(f"slots must be a positive integer, got {slots!r}")
    slots = int(slots)
    if axis in mesh.axis_names:
        raise ValueError(f"slot axis {axis!r} collides with mesh axes {tuple(mesh.axis_names)}")
    spatial_shape = tuple(mesh.shape[a] for a in mesh.axis_names)
    names = (axis,) + tuple(mesh.axis_names)
    if mesh.processes:
        from repro_torch.dist import processes

        world = processes.world().size
        if world % (slots * mesh.size):
            raise ValueError(
                f"slot axis of {slots} over a {mesh.size}-process spatial mesh needs "
                f"{slots * mesh.size} processes, or a number that divides the world's; the "
                f"world has {world}"
            )
        return processes.process_mesh((slots,) + spatial_shape, names)
    if slots == 1:
        return Mesh(mesh.devices.reshape((1,) + spatial_shape), names)
    n_spatial = int(np.prod(spatial_shape))
    if devices is None:
        from repro_torch.tune.space import default_devices

        devices = default_devices()
    pool = [torch.device(d) for d in devices]
    need = slots * n_spatial
    if need > len(pool):
        raise ValueError(
            f"slot axis of {slots} over a {n_spatial}-rank spatial mesh "
            f"needs {need} devices, have {len(pool)}"
        )
    devs = np.empty(need, dtype=object)
    for i, d in enumerate(pool[:need]):
        devs[i] = d
    return Mesh(devs.reshape((slots,) + spatial_shape), names)


def _row_blocks(x: ShardedTensor, i: int):
    """``(rank, local row, index of the rank's block after dim 0)`` for
    every rank whose block of the sharded ``[B, *shape]`` tensor ``x``
    holds row ``i`` (each rank's shards entry, on a process mesh this
    process's alone, is ``x.shards[mesh.local_ranks.index(rank)]``)."""
    if not 0 <= i < x.shape[0]:
        raise IndexError(f"row {i} of a pool of {x.shape[0]}")
    rows = block_shape(x.shape, x.mesh, x.spec)[0]
    for r in range(x.mesh.size):
        idx = _local_slices(x.shape, x.mesh, x.spec, r)
        start = idx[0].start or 0
        if start <= i < start + rows:
            yield r, i - start, idx[1:]


def read_row(x, i: int) -> torch.Tensor:
    """Row ``i`` of a ``[B, *shape]`` pool as a new global tensor (on rank
    0's device for a :class:`ShardedTensor`, this process's on a process
    mesh; a clone for a plain tensor): it shares nothing with ``x``, so
    later writes to ``x`` leave it as it is.  On a process mesh every
    process calls it and gets the whole row: each block of it is
    broadcast from the process that owns it, in rank order."""
    if not isinstance(x, ShardedTensor):
        return x[i].clone()
    mesh = x.mesh
    named = _spec_axes(x.spec)
    device = mesh.device(mesh.process_rank if mesh.processes else 0)
    out = torch.empty(x.shape[1:], dtype=x.dtype, device=device)
    if mesh.processes:
        import torch.distributed as dist

        from repro_torch.dist import processes

        group, _ = processes._block(mesh, None)
    for r, local, rest in _row_blocks(x, i):
        # one copy per block, as gather takes it
        if any(c for a, c in mesh.coords(r).items() if a not in named):
            continue
        if not mesh.processes:
            out[rest].copy_(x.shards[r][local])
            continue
        block = (x.shards[0][local].contiguous() if r == mesh.process_rank
                 else torch.empty(out[rest].shape, dtype=x.dtype, device=device))
        dist.broadcast(block, src=mesh.process_base + r, group=group)
        out[rest].copy_(block)
    return out


def write_row(x, i: int, value) -> None:
    """Write ``value`` (a global ``shape`` tensor or float32 array) into row
    ``i`` of a ``[B, *shape]`` pool in place: every local rank's copy of
    that row's block (on a process mesh only the processes that hold the
    row write, and no message moves), so the tensors (and the ring slots
    they may be) stay the same objects."""
    v = _as_tensor(value)
    if not isinstance(x, ShardedTensor):
        x[i].copy_(v)
        return
    if tuple(v.shape) != tuple(x.shape[1:]):
        raise ValueError(f"a row of shape {tuple(v.shape)} for a pool of rows {tuple(x.shape[1:])}")
    local = x.mesh.local_ranks
    for r, row, rest in _row_blocks(x, i):
        if r in local:
            x.shards[local.index(r)][row].copy_(v[rest])


# --------------------------------------------------------------------------
# stacked ranks: the LM branches' shard_map bodies and their collectives
# --------------------------------------------------------------------------


def _on(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``x`` on ``device`` (a meta tensor stays meta: the dry run's)."""
    if x.device.type == "meta" or x.device == device:
        return x
    return x.to(device)


def as_views(x: torch.Tensor, mesh: Mesh, spec: Sequence) -> ShardedTensor:
    """``x`` laid out over ``mesh`` by ``spec`` without a copy: each
    rank's shard is a view of its block of ``x`` where the rank sits on
    ``x``'s device (or ``x`` is a meta tensor), else that block moved to
    the rank's device."""
    spec = PartitionSpec(*spec)
    shape = tuple(x.shape)
    _check_spec(shape, mesh, spec)
    shards = tuple(
        _on(x[_local_slices(shape, mesh, spec, r)], mesh.device(r)) for r in range(mesh.size)
    )
    return ShardedTensor(mesh, spec, shards, shape)


class _Assemble(torch.autograd.Function):
    """The global tensor of per-rank blocks, as a ``shard_map`` output with
    the reference's unchecked replication (``check_vma=False``): the
    forward takes one copy of each block (the rank at coordinate 0 of the
    axes the spec does not name); the backward hands every rank its block
    of the cotangent divided by the number of copies, as JAX's transpose
    of such an output does."""

    @staticmethod
    def forward(ctx, meta, *shards):
        x, device = meta
        ctx.meta = x
        out = torch.empty(x.shape, dtype=x.dtype, device=device)
        for r in _block_ranks(x):
            out[_local_slices(x.shape, x.mesh, x.spec, r)].copy_(shards[r])
        return out

    @staticmethod
    def backward(ctx, grad):
        x = ctx.meta
        g = grad / _copies(x.mesh, x.spec)
        return (None,) + tuple(
            _on(g[_local_slices(x.shape, x.mesh, x.spec, r)], s.device)
            for r, s in enumerate(x.shards)
        )


def _copies(mesh: Mesh, spec: Sequence) -> int:
    """How many ranks hold each block: the product of the axes the spec
    does not name."""
    named = set(_spec_axes(spec))
    return math.prod(n for a, n in mesh.shape.items() if a not in named)


def assemble(x, device=None) -> torch.Tensor:
    """The global tensor of a :class:`ShardedTensor` that a ``shard_map``
    body made, on ``device`` (default: rank 0's shard's device),
    differentiable as :class:`_Assemble` says; a plain tensor is returned
    as it is."""
    if not isinstance(x, ShardedTensor):
        return x
    dev = device or x.shards[0].device
    return _Assemble.apply((x, dev), *x.shards)


def _same_device(a: torch.device, b: torch.device) -> bool:
    """Whether two devices are one (``cuda`` without an index is the
    current card)."""
    if a.type != b.type:
        return False
    if a.type != "cuda" or a.index == b.index:
        return True
    cur = torch.cuda.current_device()
    return (cur if a.index is None else a.index) == (cur if b.index is None else b.index)


def stacked(x: torch.Tensor, mesh: Mesh, spec: Sequence) -> torch.Tensor:
    """Every rank's block of ``x`` laid out by ``spec``, stacked: a view of
    ``x`` of shape ``[*mesh dims, *local shape]`` whose entry at a rank's
    mesh coordinate is that rank's local tensor (axes the spec does not
    name are broadcast: each rank on them holds the same block).  No
    copy; writes into ``x`` show through.  All ranks must sit on ``x``'s
    device (or ``x`` be a meta tensor)."""
    spec = PartitionSpec(*spec)
    shape = tuple(x.shape)
    _check_spec(shape, mesh, spec)
    if (x.device.type != "meta" and not mesh.processes
            and not all(_same_device(d, x.device) for d in mesh.devices.flat)):
        raise ValueError(
            f"the ranks of {mesh!r} are not all on {x.device}: the stacked "
            "shard_map runs ranks that share one device (ranks on several "
            "devices need one process each)"
        )
    tags: list = []
    y = x
    for d in reversed(range(len(shape))):
        axes = _entry_axes(spec[d] if d < len(spec) else None)
        if axes:
            g = _axes_size(mesh, axes)
            y = y.unflatten(d, tuple(mesh.shape[a] for a in axes) + (shape[d] // g,))
        tags[:0] = list(axes) + [None]
    perm = [tags.index(a) for a in mesh.axis_names if a in tags]
    perm += [i for i, t in enumerate(tags) if t is None]
    y = y.permute(perm)
    for k, a in enumerate(mesh.axis_names):
        if a not in tags:
            y = y.unsqueeze(k)
    L = len(mesh.axis_names)
    return y.expand(*mesh.shape.values(), *y.shape[L:])


class _FirstCopy(torch.autograd.Function):
    """Index 0 along the given dims (kept, size 1); the backward spreads
    the cotangent over them divided by their number of entries (JAX's
    transpose of a ``check_vma=False`` output, see :class:`_Assemble`)."""

    @staticmethod
    def forward(ctx, y, dims):
        ctx.shape, ctx.dims = y.shape, dims
        for d in dims:
            y = y.narrow(d, 0, 1)
        return y.clone()

    @staticmethod
    def backward(ctx, g):
        n = math.prod(ctx.shape[d] for d in ctx.dims)
        return (g / n).expand(ctx.shape), None


def unstack(y: torch.Tensor, mesh: Mesh, spec: Sequence) -> torch.Tensor:
    """The global tensor of stacked ranks ``y`` (``[*mesh dims, *local]``)
    laid out by ``spec``: the inverse of :func:`stacked`, taking one copy
    of each block, differentiable as :class:`_Assemble` says."""
    spec = PartitionSpec(*spec)
    L = len(mesh.axis_names)
    named = set(_spec_axes(spec))
    unnamed = tuple(k for k, a in enumerate(mesh.axis_names) if a not in named)
    if unnamed:
        y = _FirstCopy.apply(y, unnamed)
    local = tuple(y.shape[L:])
    perm, shape = [], []
    for d, n in enumerate(local):
        axes = _entry_axes(spec[d] if d < len(spec) else None)
        perm += [mesh.axis_names.index(a) for a in axes]
        perm.append(L + d)
        shape.append(n * _axes_size(mesh, axes))
    perm += list(unnamed)
    return y.permute(perm).reshape(shape)


def _axis_names(axis) -> tuple:
    return tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)


def _axis_dims(mesh: Mesh, axis) -> list:
    return [mesh.axis_names.index(a) for a in _axis_names(axis)]


# -- one process per rank: this rank's block with size-1 mesh dims in front


def _own(mesh: Mesh, axes=None) -> tuple:
    """The index of this process's entry in the mesh dims of a stacked
    tensor that is full along ``axes`` (default: every axis) and of size
    1 along the others."""
    c = mesh.coords(mesh.process_rank)
    axes = mesh.axis_names if axes is None else axes
    return tuple(slice(c[a], c[a] + 1) if a in axes else slice(None) for a in mesh.axis_names)


def _gather_axes(x: torch.Tensor, mesh: Mesh, axes) -> torch.Tensor:
    """This process's stacked block ``x`` (``[1, ..., 1, *local]``) and
    those of the processes that differ from it only along ``axes``: a
    tensor full along those mesh dims (in rank order) and of size 1 along
    the others, as the stacked path holds them."""
    from repro_torch.dist import processes

    L = len(mesh.axis_names)
    parts = processes.all_gather(x, mesh, axes)
    shape = [mesh.shape[a] if a in axes else 1 for a in mesh.axis_names] + list(x.shape[L:])
    return torch.stack(parts).reshape(shape)


class _GatherAxes(torch.autograd.Function):
    """:func:`_gather_axes`, differentiable: this process's block gets the
    sum, over the processes of its group in rank order, of their
    cotangents at its entry."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return _gather_axes(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        from repro_torch.dist import processes

        own = _own(ctx.mesh, ctx.axes)
        parts = processes.all_gather(g, ctx.mesh, ctx.axes)
        acc = parts[0][own]
        for p in parts[1:]:
            acc = acc + p[own]
        return acc, None, None


def _gather(x: torch.Tensor, mesh: Mesh, axis) -> torch.Tensor:
    return _GatherAxes.apply(x, mesh, tuple(a for a in mesh.axis_names if a in _axis_names(axis)))


class _Enter(torch.autograd.Function):
    """This process's stacked block of the global ``x``; the backward sums
    every process's cotangent of its block into the global gradient, as
    the stacked path sums its ranks' (so every process holds the global
    gradient of the one program they run together)."""

    @staticmethod
    def forward(ctx, x, mesh, spec):
        ctx.mesh, ctx.spec, ctx.like = mesh, spec, (x.shape, x.dtype, x.device)
        return stacked(x, mesh, spec)[_own(mesh)].clone()

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        full = _gather_axes(g, mesh, mesh.axis_names)
        shape, dtype, device = ctx.like
        with torch.enable_grad():
            z = torch.zeros(shape, dtype=dtype, device=device, requires_grad=True)
            (gx,) = torch.autograd.grad(stacked(z, mesh, ctx.spec), z, full)
        return gx, None, None


def _enter(x: torch.Tensor, mesh: Mesh, spec: Sequence) -> torch.Tensor:
    """On a process mesh, this rank's block of the global ``x`` laid out
    by ``spec``: ``[1, ..., 1, *local]`` (a view where no gradient is
    wanted)."""
    if not (torch.is_grad_enabled() and x.requires_grad):
        return stacked(x, mesh, spec)[_own(mesh)]
    return _Enter.apply(x, mesh, PartitionSpec(*spec))


class _Leave(torch.autograd.Function):
    """The global tensor of every process's stacked block: the blocks are
    gathered and put together as :func:`unstack` puts the stacked ranks
    together (one copy of each block).  Every process runs the same
    program on the result, so the backward hands this process the
    cotangent of its own block only, as :func:`unstack`'s backward hands
    each stacked rank its own."""

    @staticmethod
    def forward(ctx, y, mesh, spec):
        ctx.mesh, ctx.spec = mesh, spec
        full = _gather_axes(y, mesh, mesh.axis_names)
        ctx.like = (full.shape, full.dtype, full.device)
        return unstack(full, mesh, spec)

    @staticmethod
    def backward(ctx, g):
        shape, dtype, device = ctx.like
        with torch.enable_grad():
            z = torch.zeros(shape, dtype=dtype, device=device, requires_grad=True)
            (gz,) = torch.autograd.grad(unstack(z, ctx.mesh, ctx.spec), z, g)
        return gz[_own(ctx.mesh)], None, None


def _leave(y: torch.Tensor, mesh: Mesh, spec: Sequence) -> torch.Tensor:
    return _Leave.apply(y, mesh, PartitionSpec(*spec))


def _chain(x: torch.Tensor, dims: list, red) -> torch.Tensor:
    """``x`` reduced by ``red`` (``torch.add``, ...) over the mesh dims
    ``dims``, one entry after another in row-major order of those dims,
    keeping them as dims of size 1: the same arithmetic for every entry
    whether the ranks are stacked or gathered from processes."""
    k = len(dims)
    y = x.movedim(dims, list(range(k)))
    y = y.reshape(math.prod(y.shape[:k]), *y.shape[k:])
    acc = y[0]
    for i in range(1, y.shape[0]):
        acc = red(acc, y[i])
    for d in sorted(dims):
        acc = acc.unsqueeze(d)
    return acc


def _rank_block(x: torch.Tensor) -> torch.Tensor:
    """``x`` contiguous and, on a card, 256-byte aligned (a copy where it is
    not: cuBLAS picks its kernel by the operands' alignment too), so that a
    library call on it sees the same layout on every rank."""
    x = x.contiguous()
    return x.clone() if x.is_cuda and x.data_ptr() % 256 else x


def _split_ranks(x: torch.Tensor, lead: tuple) -> list:
    """The entries of ``x`` along its ``len(lead)`` leading dims (expanded
    to ``lead``), in row-major order: views, whose backward stacks the
    entries' cotangents once (an index per entry would scatter each into a
    zero tensor of the whole)."""
    blocks = [x.expand(*lead, *x.shape[len(lead):])]
    for _ in lead:
        blocks = [b for y in blocks for b in y.unbind(0)]
    return blocks


def per_rank(f: Callable, *xs: torch.Tensor, mesh: Mesh, coords: bool = False):
    """``f`` on each rank's entry of stacked ranks ``xs`` (``[*mesh dims,
    *local]``), one call per rank on its local tensors, and its results
    (tensors, or tuples and dicts of them) stacked again.  A rank's numbers
    are then those of the same call in a process that holds only its
    block: one batched call over the stacked ranks may take another cuBLAS
    kernel, or sum a reduction in another order, than a call on one rank's
    block.  With ``coords`` the call is ``f(coords, *blocks)``, ``coords``
    the rank's coordinate along each mesh axis (``Mesh.coords``), and every
    mesh dim runs in full.  Meta tensors (the dry run) take one call, on
    the first rank's block, for all."""
    L = len(mesh.axis_names)
    lead = torch.broadcast_shapes(*(x.shape[:L] for x in xs))
    if coords and not mesh.processes:
        lead = tuple(mesh.shape.values())
    if any(x.is_meta for x in xs):
        first = tuple(x.expand(*lead, *x.shape[L:])[(0,) * L] for x in xs)
        out = f(mesh.coords(0), *first) if coords else f(*first)
        return pytree.tree_map(lambda t: t.expand(*lead, *t.shape), out)
    blocks = [_split_ranks(x, lead) for x in xs]
    outs = []
    for i, idx in enumerate(np.ndindex(*lead)):
        args = [_rank_block(b[i]) for b in blocks]
        if coords:
            rank = mesh.process_rank if mesh.processes else int(np.ravel_multi_index(idx, lead))
            args.insert(0, mesh.coords(rank))
        outs.append(f(*args))
    leaves, tree = pytree.tree_flatten(outs[0])
    cols = [pytree.tree_flatten(o)[0] for o in outs]
    return pytree.tree_unflatten(
        [(cols[0][i] if len(cols) == 1 else torch.stack([c[i] for c in cols]))
         .reshape(*lead, *leaf.shape) for i, leaf in enumerate(leaves)], tree)


class _Spread(torch.autograd.Function):
    """``y`` (size 1 along the mesh dims ``dims``) expanded to ``shape``;
    the backward sums the copies' cotangents by :func:`_chain`, in rank
    order, as a process mesh sums them (autograd's own expand backward
    sums in an order of its choosing)."""

    @staticmethod
    def forward(ctx, y, shape, dims):
        ctx.dims = dims
        return y.expand(shape)

    @staticmethod
    def backward(ctx, g):
        return _chain(g, list(ctx.dims), torch.add), None, None


def _spread(y: torch.Tensor, shape, dims) -> torch.Tensor:
    dims = tuple(d for d in dims if y.shape[d] != shape[d])
    if not dims or y.is_meta or not (torch.is_grad_enabled() and y.requires_grad):
        return y.expand(shape)
    return _Spread.apply(y, tuple(shape), dims)


def psum(x: torch.Tensor, axis, mesh: Mesh) -> torch.Tensor:
    """``jax.lax.psum`` over ``axis`` (a name or a tuple of names; an empty
    tuple is no axis) of stacked ranks: every rank of a group gets the
    group's sum (on a process mesh over the processes of the group)."""
    if not _axis_names(axis):
        return x
    _count("all-reduce", x, mesh)
    if mesh.processes:
        return _chain(_gather(x, mesh, axis), _axis_dims(mesh, axis), torch.add)
    dims = _axis_dims(mesh, axis)
    return _spread(_chain(x, dims, torch.add), x.shape, dims)


def pmax(x: torch.Tensor, axis, mesh: Mesh) -> torch.Tensor:
    """``jax.lax.pmax`` over ``axis`` of stacked ranks."""
    if not _axis_names(axis):
        return x
    _count("all-reduce", x, mesh)
    if mesh.processes:
        return _gather(x, mesh, axis).amax(dim=_axis_dims(mesh, axis), keepdim=True)
    return x.amax(dim=_axis_dims(mesh, axis), keepdim=True).expand(x.shape)


def all_gather(x: torch.Tensor, axis, mesh: Mesh, dim: int) -> torch.Tensor:
    """``jax.lax.all_gather(..., tiled=True)`` over ``axis`` (a name or a
    tuple of names, the first major) of stacked ranks: every rank of a
    group gets the group's local tensors concatenated along the local dim
    ``dim`` in rank order (on a process mesh, gathered from the group's
    processes).  The backward hands each rank its slice of the group's
    summed cotangents, summed in rank order on both paths."""
    axes = tuple(a for a in mesh.axis_names if a in _axis_names(axis))
    if not axes:
        return x
    _count("all-gather", x, mesh)
    L = len(mesh.axis_names)
    y = _gather(x, mesh, axes) if mesh.processes else x
    for a in reversed(axes):
        k = mesh.axis_names.index(a)
        y = y.movedim(k, L - 1 + dim).flatten(L - 1 + dim, L + dim).unsqueeze(k)
    if mesh.processes:
        return y
    return _spread(y, (*x.shape[:L], *y.shape[L:]), [mesh.axis_names.index(a) for a in axes])


def pmean(x: torch.Tensor, axis, mesh: Mesh) -> torch.Tensor:
    """``jax.lax.pmean`` over ``axis``: the group's sum over its size."""
    n = math.prod(mesh.shape[a] for a in _axis_names(axis))
    return psum(x, axis, mesh) / n


def all_to_all(x: torch.Tensor, axis: str, mesh: Mesh, split_axis: int, concat_axis: int,
               tiled: bool = True) -> torch.Tensor:
    """``jax.lax.all_to_all(..., tiled=True)`` over ``axis`` of stacked
    ranks: rank ``j`` of a group gets chunk ``j`` (along the local dim
    ``split_axis``) of every rank ``i`` of the group, concatenated along
    the local dim ``concat_axis`` in the order of ``i``.  On a process
    mesh the group's blocks are gathered and this process keeps its
    entry of the stacked result."""
    if not tiled:
        raise NotImplementedError("all_to_all takes tiled=True only")
    _count("all-to-all", x, mesh)
    L = len(mesh.axis_names)
    a = mesh.axis_names.index(axis)
    n = mesh.shape[axis]
    if x.shape[L + split_axis] % n:
        raise ValueError(
            f"all_to_all over {axis!r}: local dim {split_axis} of extent "
            f"{x.shape[L + split_axis]} does not split into {n} chunks"
        )
    if mesh.processes:
        x = _gather(x, mesh, axis)
    # labels: mesh dims ("m", k) with ("i",) the source rank on the axis,
    # local dims ("l", k) with the split one cut into ("j",) × ("l", split)
    src = [("i",) if k == a else ("m", k) for k in range(L)]
    for k in range(x.ndim - L):
        src += [("j",), ("l", k)] if k == split_axis else [("l", k)]
    y = x.unflatten(L + split_axis, (n, x.shape[L + split_axis] // n))
    dst = [("j",) if k == a else ("m", k) for k in range(L)]
    shape = [y.shape[src.index(t)] for t in dst]
    for k in range(x.ndim - L):
        ext = y.shape[src.index(("l", k))]
        dst += [("i",), ("l", k)] if k == concat_axis else [("l", k)]
        shape.append(ext * n if k == concat_axis else ext)
    out = y.permute([src.index(t) for t in dst]).reshape(shape)
    return out[_own(mesh, (axis,))] if mesh.processes else out


def axis_index(mesh: Mesh, axis: str, rank: int) -> int:
    """Rank ``rank``'s index along ``axis``: ``jax.lax.axis_index``."""
    return mesh.coords(rank)[axis]


def own_chunk(x: torch.Tensor, axis: str, mesh: Mesh, dim: int) -> torch.Tensor:
    """For stacked ranks, chunk ``j`` of each rank's local dim ``dim`` (cut
    into as many chunks as ``axis`` has ranks), ``j`` the rank's index
    along ``axis``: the reference's ``dynamic_slice`` at
    ``axis_index * size``.  A view."""
    L = len(mesh.axis_names)
    a = mesh.axis_names.index(axis)
    n = mesh.shape[axis]
    y = x.unflatten(L + dim, (n, x.shape[L + dim] // n))
    if mesh.processes:
        return y.select(L + dim, mesh.coords(mesh.process_rank)[axis])
    return torch.diagonal(y, dim1=a, dim2=L + dim).movedim(-1, a)


def place_chunk(x: torch.Tensor, axis: str, mesh: Mesh, dim: int) -> torch.Tensor:
    """The inverse of :func:`own_chunk`: each rank's local dim ``dim`` grown
    by as many chunks as ``axis`` has ranks, its tensor at chunk ``j`` (its
    index along ``axis``) and zeros elsewhere: the reference's
    ``dynamic_update_slice`` into zeros."""
    L = len(mesh.axis_names)
    a = mesh.axis_names.index(axis)
    n = mesh.shape[axis]
    y = x.unsqueeze(L + dim)
    if mesh.processes:
        j = torch.arange(n, device=x.device) == mesh.coords(mesh.process_rank)[axis]
        mask = j.reshape([n if k == L + dim else 1 for k in range(y.ndim)])
    else:
        eye = torch.eye(n, dtype=torch.bool, device=x.device)
        mask = eye.reshape([n if k in (a, L + dim) else 1 for k in range(y.ndim)])
    y = torch.where(mask, y, torch.zeros((), dtype=x.dtype, device=x.device))
    return y.flatten(L + dim, L + dim + 1)


def _counters() -> list:
    if not hasattr(_STATE, "counters"):
        _STATE.counters = []
    return _STATE.counters


@contextlib.contextmanager
def counting_collectives():
    """Count, per kind (``all-reduce``, ``all-to-all``), one rank's
    operand bytes in every collective in scope: what the reference's dry
    run sums from the collectives of its per-device HLO."""
    counts: dict = {}
    _counters().append(counts)
    try:
        yield counts
    finally:
        _counters().pop()


def _count(kind: str, x: torch.Tensor, mesh: Mesh) -> None:
    for counts in _counters():
        ranks = 1 if mesh.processes else mesh.size  # a process holds one rank's block
        per_rank = x.numel() // ranks * x.element_size()
        counts[kind] = counts.get(kind, 0) + per_rank


# --------------------------------------------------------------------------
# the language-model half: logical → physical sharding rules
# --------------------------------------------------------------------------

#: A physical mapping for one logical axis: a mesh axis name, a tuple of
#: mesh axis names (sharded over their product), or None (replicated).
Physical = Union[None, str, Tuple[str, ...]]


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Logical-axis → physical-mesh-axis table."""

    table: Mapping[str, Physical]

    def physical(self, logical: Optional[str]) -> Physical:
        if logical is None:
            return None
        return self.table.get(logical)

    def replace(self, **updates: Physical) -> "ShardingRules":
        return ShardingRules({**self.table, **updates})


def default_rules(multi_pod: bool = False) -> ShardingRules:
    """The production rules: batch over the data axes (FSDP-style), every
    contracted model dimension over "model" (megatron-style TP).

    Multi-pod runs add a leading "pod" axis to the batch group."""
    batch: Physical = ("pod", "data") if multi_pod else "data"
    return ShardingRules(
        {
            # activations
            "batch": batch,
            "seq": None,
            "embed_act": None,
            "mlp_act": "model",
            "vocab_act": "model",
            "heads": "model",
            "kv_heads": "model",
            # weights
            "embed": None,
            "vocab": "model",
            "q_heads_p": "model",
            "kv_heads_p": "model",
            "mlp": "model",
            "expert": "model",
        }
    )


_STATE = threading.local()


def _stack() -> list:
    if not hasattr(_STATE, "stack"):
        _STATE.stack = []
    return _STATE.stack


@contextlib.contextmanager
def use_mesh(mesh, rules: Optional[ShardingRules] = None, *, body: bool = False):
    """Activate ``mesh``/``rules`` for every ``shard`` call and mesh
    branch in scope (this thread).  ``body=True`` is the body of a
    tensor-parallel step (:func:`tensor_parallel`)."""
    rules = rules or default_rules(multi_pod="pod" in mesh.axis_names)
    _stack().append((mesh, rules, body))
    try:
        yield mesh
    finally:
        _stack().pop()


def active_context() -> Optional[tuple]:
    """``(mesh, rules, body)`` in scope, or ``None``: what a remat'd cell
    re-enters in the backward (:func:`use_context`)."""
    s = _stack()
    return s[-1] if s else None


@contextlib.contextmanager
def use_context(ctx: Optional[tuple]):
    """Re-enter a context that :func:`active_context` returned."""
    if ctx is None or active_context() is ctx:
        yield
        return
    _stack().append(ctx)
    try:
        yield
    finally:
        _stack().pop()


def active_mesh():
    s = _stack()
    return s[-1][0] if s else None


def active_rules() -> Optional[ShardingRules]:
    s = _stack()
    return s[-1][1] if s else None


def _valid_spec(mesh, spec: Sequence, shape: tuple) -> PartitionSpec:
    """Clamp ``spec`` to what ``shape`` supports on ``mesh`` (reads
    ``mesh.shape`` only).

    Per dimension, mesh axes are kept (in order) only while the product
    of their sizes still divides the dimension; axes unknown to the mesh
    or already used by an earlier dimension are dropped."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    used: set = set()
    out = []
    for dim, entry in zip(shape, entries[: len(shape)]):
        if entry is None:
            out.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        kept = []
        prod = 1
        for a in axes:
            if a is None or a not in mesh.shape or a in used:
                continue
            size = mesh.shape[a]
            if dim % (prod * size) == 0:
                kept.append(a)
                prod *= size
                used.add(a)
        if not kept:
            out.append(None)
        elif len(kept) == 1:
            out.append(kept[0])
        else:
            out.append(tuple(kept))
    return PartitionSpec(*out)


def _recorders() -> list:
    if not hasattr(_STATE, "recorders"):
        _STATE.recorders = []
    return _STATE.recorders


@contextlib.contextmanager
def recording():
    """Collect ``(shape, spec)`` of every :func:`shard` (and cache
    constraint) in scope, in call order: the layouts the reference would
    have pinned."""
    log: list = []
    _recorders().append(log)
    try:
        yield log
    finally:
        _recorders().pop()


def record_spec(shape: tuple, spec: PartitionSpec) -> None:
    for log in _recorders():
        log.append((tuple(shape), spec))


def shard(x, *logical: Optional[str]):
    """The reference's layout constraint for ``logical`` axes.

    Without an active mesh it returns at once.  With one (``use_mesh``,
    the weights whole), it resolves the rules, clamps the spec with
    :func:`_valid_spec`, records it (see :func:`recording`; the dry run
    reads the records) and returns ``x``: the reference's
    ``with_sharding_constraint`` only steers GSPMD's layout and never
    changes a value.  Inside a tensor-parallel body
    (:func:`tensor_parallel`) the layout is applied, by the blocks'
    explicit collectives at the reference's constraint points: the psum of
    a row-parallel product's partial sums, the all-gather where a spec
    asks for a dim whole, the slice where it asks for a block
    (:func:`relayout`); there ``shard`` sees one rank's local tensor
    inside :func:`per_rank` and returns it unrecorded."""
    mesh = active_mesh()
    if mesh is None or _stack()[-1][2]:
        return x
    rules = active_rules() or default_rules(multi_pod="pod" in mesh.axis_names)
    entries = tuple(rules.physical(a) if isinstance(a, str) else a for a in logical)
    record_spec(tuple(x.shape), _valid_spec(mesh, PartitionSpec(*entries), tuple(x.shape)))
    return x


def _batch_axis_size(mesh, rules: ShardingRules) -> int:
    batch_ax = rules.physical("batch")
    axes = batch_ax if isinstance(batch_ax, tuple) else (batch_ax,)
    return math.prod(mesh.shape.get(a, 1) for a in axes if a)


def kv_cache_layout(B: int, T: int, Kh: int, mesh, rules: Optional[ShardingRules] = None) -> str:
    """Pick the decode-cache layout for a [B, T, Kh, hd] cache.

    - ``"heads"``   — KV heads divide the model axis: classic TP.
    - ``"seq"``     — they don't; shard the *sequence* dim over "model".
    - ``"seq_all"`` — tiny-batch long-context: batch can't shard, so the
      sequence dim is spread over every available axis.
    - ``"batch"``   — no model axis (or nothing else fits) but batch
      divides the data axes.
    - ``"flat"``    — replicate (single device / nothing divides).
    """
    if mesh is None:
        return "flat"
    rules = rules or default_rules(multi_pod="pod" in mesh.axis_names)
    n_b = _batch_axis_size(mesh, rules)
    model = mesh.shape.get("model", 1)
    batch_ok = n_b <= 1 or B % n_b == 0
    if model > 1:
        if Kh % model == 0 and batch_ok:
            return "heads"
        if batch_ok and n_b > 1 and T % model == 0:
            return "seq"
        if T % (max(n_b, 1) * model) == 0:
            return "seq_all"
    if n_b > 1 and B % n_b == 0:
        return "batch"
    return "flat"


# --------------------------------------------------------------------------
# tensor parallelism: placed trees and the body of a step
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """The reference's ``jax.sharding.NamedSharding``: a leaf laid out over
    ``mesh`` by ``spec`` (a ``Trainer``'s ``state_shardings`` is a tree of
    them)."""

    mesh: Mesh
    spec: PartitionSpec


def _lead(mesh: Mesh, spec: Sequence) -> tuple:
    """Per mesh axis, its size where ``spec`` names it, else 1: the leading
    dims of a placed leaf on a single controller."""
    named = set(_spec_axes(spec))
    return tuple(n if a in named else 1 for a, n in mesh.shape.items())


def block_shape(shape: Sequence[int], mesh: Mesh, spec: Sequence) -> tuple:
    """One rank's block of a global ``shape`` laid out by ``spec``."""
    return tuple(
        n // _axes_size(mesh, _entry_axes(spec[d] if d < len(spec) else None))
        for d, n in enumerate(shape)
    )


def placed_shape(shape: Sequence[int], mesh: Mesh, spec: Sequence) -> tuple:
    """The shape :func:`place` gives a global ``shape``: the block on a
    process mesh, ``[*_lead, *block]`` on a single controller."""
    local = block_shape(shape, mesh, spec)
    return local if mesh.processes or not local else (*_lead(mesh, spec), *local)


def place(x, mesh: Mesh, spec: Sequence) -> torch.Tensor:
    """The global ``x`` (a tensor or a numpy array of any dtype) as this
    process's part of it laid out by ``spec``: on a process mesh the
    rank's block, on a single controller every distinct block stacked
    (``[*_lead, *block]``: one entry per coordinate of the axes the spec
    names, none repeated for the others).  A fresh contiguous tensor on
    this process's device (rank 0's on a single controller); only the
    block crosses to the device."""
    spec = PartitionSpec(*spec)
    if isinstance(x, (np.ndarray, np.generic)):
        x = np.asarray(x)
        if mesh.processes and x.ndim:  # the block alone leaves the file (a memmap)
            _check_spec(x.shape, mesh, spec)
            block = np.array(x[_local_slices(x.shape, mesh, spec, mesh.process_rank)])
            return _fresh(torch.from_numpy(block), mesh.device(mesh.process_rank))
        x = torch.from_numpy(np.array(x))
    shape = tuple(x.shape)
    _check_spec(shape, mesh, spec)
    device = mesh.device(mesh.process_rank if mesh.processes else 0)
    if not shape:  # a scalar (a step count): the same on every rank
        return x if x.is_meta else _fresh(x, device)
    if x.is_meta:
        return torch.empty(placed_shape(shape, mesh, spec), dtype=x.dtype, device="meta")
    if mesh.processes:
        return _fresh(x[_local_slices(shape, mesh, spec, mesh.process_rank)], device)
    if not all(_same_device(d, x.device) for d in mesh.devices.flat):
        # the blocks are cut where x lies, and only they cross to the device
        mesh = Mesh(np.full(mesh.devices.shape, x.device, dtype=object), mesh.axis_names)
    y = stacked(x, mesh, spec)
    lead = _lead(mesh, spec)
    return _fresh(y[tuple(slice(0, n) for n in lead)], device)


def gather_placed(x: torch.Tensor, mesh: Mesh, spec: Sequence) -> torch.Tensor:
    """The inverse of :func:`place`: the global tensor (on a process mesh
    gathered from every process)."""
    spec = PartitionSpec(*spec)
    if x.ndim == 0:
        return x
    if mesh.processes:
        shape = _global_shape(tuple(x.shape), mesh, spec)
        return gather(ShardedTensor(mesh, spec, (x,), shape))
    L = len(mesh.axis_names)
    full = x.expand(*mesh.shape.values(), *x.shape[L:])
    with torch.no_grad():
        return unstack(full, mesh, spec)


def as_sharded(x: torch.Tensor, mesh: Mesh, spec: Sequence) -> ShardedTensor:
    """A placed leaf as a :class:`ShardedTensor` (views, no copy): what the
    ``Checkpointer`` saves, gathering the blocks to one writer."""
    spec = PartitionSpec(*spec)
    L = len(mesh.axis_names)
    if x.ndim == 0:
        return x
    if mesh.processes:
        shards = (x,)
        local = tuple(x.shape)
    else:
        full = x.expand(*mesh.shape.values(), *x.shape[L:])
        shards = tuple(full[idx] for idx in np.ndindex(*full.shape[:L]))
        local = tuple(x.shape[L:])
    return ShardedTensor(mesh, spec, shards, _global_shape(local, mesh, spec))


def rank_block(x: torch.Tensor, mesh: Mesh, spec: Sequence, rank: int) -> torch.Tensor:
    """Rank ``rank``'s block of a leaf placed on the single controller
    ``mesh`` (a view): what the process of that rank holds on a process
    mesh of the same shape."""
    if x.ndim == 0:
        return x
    named = set(_spec_axes(spec))
    return x[tuple(c if a in named else 0 for a, c in mesh.coords(rank).items())]


def block_bytes(shapes, specs, mesh: Mesh) -> int:
    """One rank's bytes of a tree of global-shaped leaves (tensors or meta
    tensors) laid out by a tree of specs."""
    if isinstance(shapes, dict):
        return sum(block_bytes(v, specs[k], mesh) for k, v in shapes.items())
    return math.prod(block_shape(shapes.shape, mesh, specs)) * shapes.element_size()


def _map_specs(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v, specs[k]) for k, v in tree.items()}
    return fn(tree, specs)


def place_tree(tree, specs, mesh: Mesh):
    """:func:`place` over a nested dict of leaves and the matching tree of
    specs."""
    return _map_specs(lambda x, s: place(x, mesh, s), tree, specs)


def gather_tree(tree, specs, mesh: Mesh):
    """:func:`gather_placed` over a tree: the global tensors of a placed
    tree (a collective on a process mesh: every process calls it)."""
    return _map_specs(lambda x, s: gather_placed(x, mesh, s), tree, specs)


def enter(x: torch.Tensor, mesh: Mesh, spec: Sequence) -> torch.Tensor:
    """A placed leaf as the body of a step holds it: ``[*mesh dims,
    *local]`` (on a single controller the distinct blocks spread over the
    axes the spec does not name, whose copies' gradients sum in rank
    order; on a process mesh this rank's block with size-1 mesh dims in
    front, whose gradient :func:`reduce_placed` completes)."""
    L = len(mesh.axis_names)
    if mesh.processes:
        return x.reshape((1,) * L + tuple(x.shape))
    return _spread(x, (*mesh.shape.values(), *x.shape[L:]), range(L))


def reduce_placed(g: torch.Tensor, mesh: Mesh, spec: Sequence) -> torch.Tensor:
    """On a process mesh, the gradient of a placed leaf summed over the
    ranks that hold copies of its block (the axes its spec does not name),
    in rank order, as :func:`enter`'s backward sums them on a single
    controller; on a single controller ``g`` as it is."""
    named = set(_spec_axes(spec))
    axes = tuple(a for a in mesh.axis_names if a not in named and mesh.shape[a] > 1)
    if not mesh.processes or not axes:
        return g
    L = len(mesh.axis_names)
    y = _gather_axes(g.reshape((1,) * L + tuple(g.shape)), mesh, axes)
    return _chain(y, _axis_dims(mesh, axes), torch.add).reshape(g.shape)


def leave(y: torch.Tensor, mesh: Mesh, spec: Sequence) -> torch.Tensor:
    """A body's stacked ``y`` as the global tensor laid out by ``spec``
    (one copy of each block; differentiable as :func:`unstack` and
    ``shard_map``'s outputs are)."""
    return _leave(y, mesh, spec) if mesh.processes else unstack(y, mesh, spec)


def to_placed(y: torch.Tensor, mesh: Mesh, spec: Sequence) -> torch.Tensor:
    """A body's stacked ``y`` laid out by ``spec`` as a placed leaf: its
    distinct blocks (the first copy along the axes the spec does not
    name), contiguous; no collective."""
    L = len(mesh.axis_names)
    if mesh.processes:
        return y.reshape(y.shape[L:]).contiguous()
    lead = _lead(mesh, spec)
    return y[tuple(slice(0, n) for n in lead)].contiguous()


@contextlib.contextmanager
def tensor_parallel(mesh: Mesh, rules: Optional[ShardingRules] = None):
    """The body of a tensor- and data-parallel step over ``mesh``: the
    models' blocks take stacked ranks (``[*mesh dims, *local]``, each
    weight its block of ``param_pspecs``), compute each rank's part with
    :func:`per_rank` and run the collectives GSPMD would insert."""
    with use_mesh(mesh, rules, body=True):
        yield mesh


def body_mesh() -> Optional[Mesh]:
    """The mesh of the tensor-parallel body in scope, or ``None``."""
    s = _stack()
    return s[-1][0] if s and s[-1][2] else None


def clamp_axes(logical: str, extent: int) -> tuple:
    """The mesh axes the active rules give ``logical`` for a dim of
    ``extent``, clamped as :func:`_valid_spec` clamps them (``()``:
    replicated)."""
    mesh, rules = active_mesh(), active_rules()
    entry = _valid_spec(mesh, PartitionSpec(rules.physical(logical)), (extent,))[0]
    return _entry_axes(entry)


def axes_size(mesh: Mesh, axes: tuple) -> int:
    return _axes_size(mesh, tuple(axes))


def axes_index(mesh: Mesh, axes: tuple, coords: Mapping[str, int]) -> int:
    """A rank's index over ``axes`` (the first major), from its ``coords``."""
    return _axes_index(mesh, tuple(axes), coords)


def own(x: torch.Tensor, axes: tuple, mesh: Mesh, dim: int) -> torch.Tensor:
    """:func:`own_chunk` over several axes (the first major): each rank's
    block of its whole local dim ``dim``."""
    for a in axes:
        x = own_chunk(x, a, mesh, dim)
    return x


def relayout(x: torch.Tensor, have: Sequence, want: Sequence, mesh: Mesh) -> torch.Tensor:
    """Stacked ``x`` laid out by ``have`` (one entry of axes per local dim)
    into the layout ``want``: an all-gather where ``want`` keeps a dim
    whole that ``have`` splits, a slice where ``want`` splits a whole dim;
    the layout conversions of the reference's constraints."""
    for d in range(len(have)):
        h, w = _entry_axes(have[d]), _entry_axes(want[d] if d < len(want) else None)
        if h == w:
            continue
        if h:
            x = all_gather(x, h, mesh, d)
        if w:
            x = own(x, w, mesh, d)
    return x
