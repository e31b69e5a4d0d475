"""Meshes of ranks, sharded tensors and the logical sharding rules (port
of ``repro.dist.sharding``).

One process drives every rank, as ``jax.shard_map`` drives every device
of a mesh from one program: a rank is a coordinate of a :class:`Mesh`
and the device its shard lives on.  Devices may repeat, so four ranks can
share one card (each exchange then is a copy on that card) or sit on
four cards of a node (each exchange a device-to-device copy).

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
  ranks instead of one per rank.  Ranks on several devices need one
  process each (the multi-process transport), and raise;
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
changes a value; eager PyTorch on one controller has no sharding
propagation, so the port's ``shard`` resolves the rules, clamps the spec,
records it (see :func:`recording`; the dry run reads the records) and
returns its input unchanged.  The computation that a mesh really splits
(flash-decode over a sequence-sharded cache, expert parallelism, context
parallelism) runs per rank through :func:`shard_map` and the collectives.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Callable, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch


class Mesh:
    """Ranks on a grid of named axes, one ``torch.device`` each.

    ``devices`` is a nested sequence or ndarray of devices (or device
    strings) whose shape is the mesh's; rank ``r`` is the ``r``-th entry
    in row-major order, so its coordinate along each axis is
    ``np.unravel_index(r, shape)``.  Every device has one type (``cuda``
    or ``cpu``).
    """

    def __init__(self, devices, axis_names: Sequence[str]) -> None:
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
    ``shards[r]`` is rank ``r``'s contiguous local tensor, on
    ``mesh.device(r)``.  Ranks that differ only along axes the spec does
    not name hold equal copies."""

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
        _fresh(x[_local_slices(shape, mesh, spec, r)], mesh.device(r)) for r in range(mesh.size)
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


def gather(x, device=None) -> torch.Tensor:
    """The global tensor of a :class:`ShardedTensor`, on ``device`` (rank
    0's device by default); a plain tensor is returned as it is."""
    if not isinstance(x, ShardedTensor):
        return x
    mesh = x.mesh
    out = torch.empty(x.shape, dtype=x.dtype, device=device or mesh.device(0))
    for r in _block_ranks(x):
        out[_local_slices(x.shape, mesh, x.spec, r)].copy_(x.shards[r])
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
    function returns the global tensors (:func:`unstack`)."""
    in_specs, out_specs = tuple(in_specs), tuple(out_specs)

    def run_stacked(*arrays):
        if len(arrays) != len(in_specs):
            raise ValueError(f"{len(arrays)} arguments for {len(in_specs)} input specs")
        outs = f(*(stacked(a, mesh, s) for a, s in zip(arrays, in_specs)))
        return tuple(unstack(o, mesh, s) for o, s in zip(outs, out_specs))

    if stacked_ranks:
        return run_stacked

    def run(*arrays):
        if len(arrays) != len(in_specs):
            raise ValueError(f"{len(arrays)} arguments for {len(in_specs)} input specs")
        sharded = reshard(arrays, mesh, in_specs)
        per_rank = f([tuple(s.shards[r] for s in sharded) for r in range(mesh.size)])
        if len(per_rank) != mesh.size:
            raise ValueError(f"{len(per_rank)} rank results for a mesh of {mesh.size}")
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
    Devices may repeat, as in any :class:`Mesh`."""
    if int(slots) != slots or slots < 1:
        raise ValueError(f"slots must be a positive integer, got {slots!r}")
    slots = int(slots)
    if axis in mesh.axis_names:
        raise ValueError(f"slot axis {axis!r} collides with mesh axes {tuple(mesh.axis_names)}")
    spatial_shape = tuple(mesh.shape[a] for a in mesh.axis_names)
    names = (axis,) + tuple(mesh.axis_names)
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
    holds row ``i``."""
    if not 0 <= i < x.shape[0]:
        raise IndexError(f"row {i} of a pool of {x.shape[0]}")
    for r in range(x.mesh.size):
        idx = _local_slices(x.shape, x.mesh, x.spec, r)
        start = idx[0].start or 0
        n = x.shards[r].shape[0]
        if start <= i < start + n:
            yield r, i - start, idx[1:]


def read_row(x, i: int) -> torch.Tensor:
    """Row ``i`` of a ``[B, *shape]`` pool as a new global tensor (on rank
    0's device for a :class:`ShardedTensor`; a clone for a plain tensor):
    it shares nothing with ``x``, so later writes to ``x`` leave it as it
    is."""
    if not isinstance(x, ShardedTensor):
        return x[i].clone()
    out = torch.empty(x.shape[1:], dtype=x.dtype, device=x.mesh.device(0))
    for r, local, rest in _row_blocks(x, i):
        # one copy per block, as gather takes it
        if any(c for a, c in x.mesh.coords(r).items() if a not in _spec_axes(x.spec)):
            continue
        out[rest].copy_(x.shards[r][local])
    return out


def write_row(x, i: int, value) -> None:
    """Write ``value`` (a global ``shape`` tensor or float32 array) into row
    ``i`` of a ``[B, *shape]`` pool in place: every rank's copy of that
    row's block, so the tensors (and the ring slots they may be) stay the
    same objects."""
    v = _as_tensor(value)
    if not isinstance(x, ShardedTensor):
        x[i].copy_(v)
        return
    if tuple(v.shape) != tuple(x.shape[1:]):
        raise ValueError(f"a row of shape {tuple(v.shape)} for a pool of rows {tuple(x.shape[1:])}")
    for r, local, rest in _row_blocks(x, i):
        x.shards[r][local].copy_(v[rest])


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
    if x.device.type != "meta" and not all(_same_device(d, x.device) for d in mesh.devices.flat):
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


def _axis_dims(mesh: Mesh, axis) -> list:
    axes = tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)
    return [mesh.axis_names.index(a) for a in axes]


def psum(x: torch.Tensor, axis, mesh: Mesh) -> torch.Tensor:
    """``jax.lax.psum`` over ``axis`` (a name or a tuple of names) of
    stacked ranks: every rank of a group gets the group's sum."""
    _count("all-reduce", x, mesh)
    return x.sum(dim=_axis_dims(mesh, axis), keepdim=True).expand(x.shape)


def pmax(x: torch.Tensor, axis, mesh: Mesh) -> torch.Tensor:
    """``jax.lax.pmax`` over ``axis`` of stacked ranks."""
    _count("all-reduce", x, mesh)
    return x.amax(dim=_axis_dims(mesh, axis), keepdim=True).expand(x.shape)


def pmean(x: torch.Tensor, axis, mesh: Mesh) -> torch.Tensor:
    """``jax.lax.pmean`` over ``axis``: the group's sum over its size."""
    n = math.prod(x.shape[d] for d in _axis_dims(mesh, axis))
    return psum(x, axis, mesh) / n


def all_to_all(x: torch.Tensor, axis: str, mesh: Mesh, split_axis: int, concat_axis: int,
               tiled: bool = True) -> torch.Tensor:
    """``jax.lax.all_to_all(..., tiled=True)`` over ``axis`` of stacked
    ranks: rank ``j`` of a group gets chunk ``j`` (along the local dim
    ``split_axis``) of every rank ``i`` of the group, concatenated along
    the local dim ``concat_axis`` in the order of ``i``."""
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
    return y.permute([src.index(t) for t in dst]).reshape(shape)


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
        per_rank = x.numel() // mesh.size * x.element_size()
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
def use_mesh(mesh, rules: Optional[ShardingRules] = None):
    """Activate ``mesh``/``rules`` for every ``shard`` call and mesh
    branch in scope (this thread)."""
    rules = rules or default_rules(multi_pod="pod" in mesh.axis_names)
    _stack().append((mesh, rules))
    try:
        yield mesh
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
    """The reference's layout constraint for ``logical`` axes, recorded and
    not applied: returns ``x`` unchanged.

    Without an active mesh it returns at once.  With one, it resolves the
    rules, clamps the spec with :func:`_valid_spec` and records it (see
    :func:`recording`).  The reference's ``with_sharding_constraint`` only
    steers GSPMD's layout and never changes a value; the port has no
    sharding propagation (DTensor needs a process per rank), so the
    layout is recorded for the dry run and the value passes through."""
    mesh = active_mesh()
    if mesh is None:
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
