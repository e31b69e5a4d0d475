"""Meshes of ranks and sharded tensors (port of the stencil half of
``repro.dist.sharding``).

One process drives every rank, as ``jax.shard_map`` drives every device
of a mesh from one program: a rank is a coordinate of a :class:`Mesh`
and the device its shard lives on.  Devices may repeat, so four ranks can
share one card (each exchange then is a copy on that card) or sit on
four cards of a node (each exchange a device-to-device copy).

- :class:`Mesh` — an ndarray of ``torch.device``, one per rank, with named
  axes; ``.shape`` maps each axis name to its size, as
  ``jax.sharding.Mesh.shape`` does.
- :class:`PartitionSpec` (``P``) — per array dim, one mesh axis name or
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

The LM half of the reference module (``ShardingRules``, ``shard``,
``kv_cache_layout``) is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

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
    """Per array dim, the mesh axis that splits it or ``None``:
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


def _local_slices(shape: tuple, mesh: Mesh, spec: Sequence, rank: int) -> tuple:
    """The index of rank ``rank``'s block in a global array of ``shape``."""
    coords = mesh.coords(rank)
    out = []
    for d, n in enumerate(shape):
        axis = spec[d] if d < len(spec) else None
        if axis is None:
            out.append(slice(None))
            continue
        g = mesh.shape[axis]
        out.append(slice(coords[axis] * (n // g), (coords[axis] + 1) * (n // g)))
    return tuple(out)


def _check_spec(shape: tuple, mesh: Mesh, spec: Sequence) -> None:
    if len(spec) > len(shape):
        raise ValueError(f"spec {tuple(spec)} has more entries than the shape {shape} has dims")
    named = [a for a in spec if a is not None]
    if len(set(named)) != len(named):
        raise ValueError(f"spec {tuple(spec)} names a mesh axis twice")
    for d, axis in enumerate(spec):
        if axis is None:
            continue
        if axis not in mesh.shape:
            raise ValueError(f"spec {tuple(spec)} names {axis!r}, not an axis of {mesh.axis_names}")
        if shape[d] % mesh.shape[axis]:
            raise ValueError(
                f"dim {d} extent {shape[d]} not divisible by mesh axis {axis!r} "
                f"of size {mesh.shape[axis]}"
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
    for r, local in enumerate(x.shards):
        coords = mesh.coords(r)
        # one copy per block: the rank at coordinate 0 of every axis the
        # spec does not name
        if any(coords[a] for a in mesh.axis_names if a not in x.spec):
            continue
        out[_local_slices(x.shape, mesh, x.spec, r)].copy_(local)
    return out


def _global_shape(local_shape: Sequence[int], mesh: Mesh, spec: Sequence) -> tuple:
    return tuple(
        n * (mesh.shape[spec[d]] if d < len(spec) and spec[d] is not None else 1)
        for d, n in enumerate(local_shape)
    )


def shard_map(f: Callable, *, mesh: Mesh, in_specs: Sequence, out_specs: Sequence) -> Callable:
    """The single-controller counterpart of ``jax.shard_map``.

    ``f(local)`` gets, for every rank in mesh order, the tuple of that
    rank's local tensors, runs all ranks (exchanging between them as it
    goes) and returns, per rank, a tuple of local outputs.  The returned
    function takes global arrays or :class:`ShardedTensor` s, lays each
    out by ``in_specs`` and returns a tuple of :class:`ShardedTensor` s
    laid out by ``out_specs``."""
    in_specs, out_specs = tuple(in_specs), tuple(out_specs)

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
        if any(x.mesh.coords(r)[a] for a in x.mesh.axis_names if a not in x.spec):
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
