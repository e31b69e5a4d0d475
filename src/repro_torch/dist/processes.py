"""One process per rank over ``torch.distributed`` (the port's side of
JAX's multi-device runtime).

    world = processes.init()                       # torchrun's environment
    mesh = processes.process_mesh((2, 2), ("x", "y"))
    step = compile(prog, Target(mesh=mesh, strategy=make_strategy_2d((2, 2)),
                                backend="cuda"))
    out = step.time_loop(state, 100)               # every process: the global result
    processes.shutdown()

Each process owns one rank and one device: on the card ``cuda:LOCAL_RANK``
over ``nccl`` (the default), with ``device="cpu"`` the CPU over ``gloo``.
Rank ``r`` of a process mesh is process ``r`` of the world; its
coordinates are ``np.unravel_index(r, shape)`` as on a single-controller
:class:`~repro_torch.dist.Mesh`.

- :func:`init` — join the world from ``torchrun``'s environment (``RANK``,
  ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``) or from
  explicit arguments, and run one collective so that the communicator
  exists before anything is captured into a CUDA graph;
- :func:`process_mesh` — a :class:`Mesh` over the world's processes that
  knows which rank is this process (or over one block of them, where the
  mesh is smaller than the world);
- :func:`axis_group` — the process group of the ranks that differ only
  along some mesh axes (one per mesh and axes, created on every process
  in the same order);
- :func:`all_gather` — every process's tensor of a group, in rank order;
- :func:`broadcast_object` — process 0's value (a path, a decision) on
  every process;
- :func:`barrier`, :func:`shutdown`.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.dist.sharding import Mesh


@dataclasses.dataclass(frozen=True)
class World:
    """This process's place in the world: its rank, the number of
    processes, its device and the backend between them."""

    rank: int
    size: int
    device: torch.device
    backend: str


_WORLD: Optional[World] = None
# (mesh shape, axis names, the axes of a group) -> (this process's group,
# its ranks): every process creates them in one order, once per world
_GROUPS: dict = {}


def _env_int(name: str, given: Optional[int]) -> int:
    if given is not None:
        return int(given)
    if name not in os.environ:
        raise RuntimeError(
            f"processes.init: {name} is not set; start the processes with torchrun "
            "(python -m torch.distributed.run) or pass rank and world_size"
        )
    return int(os.environ[name])


def init(device=None, *, rank: Optional[int] = None, world_size: Optional[int] = None,
         local_rank: Optional[int] = None, init_method: Optional[str] = None,
         timeout_s: float = 300.0) -> World:
    """Join the world as one rank and return it.

    ``device=None`` (the default) takes the card ``cuda:LOCAL_RANK`` and
    the ``nccl`` backend; ``device="cpu"`` takes the CPU and ``gloo``.
    ``rank``/``world_size``/``local_rank`` default to torchrun's
    ``RANK``/``WORLD_SIZE``/``LOCAL_RANK`` (``local_rank`` to ``rank``);
    ``init_method`` to ``env://`` (``MASTER_ADDR``/``MASTER_PORT``).
    One collective runs before this returns, so the communicator exists
    before the first exchange, which may be captured into a CUDA graph."""
    global _WORLD
    if _WORLD is not None:
        raise RuntimeError(f"processes.init: this process is already rank {_WORLD.rank}")
    rank = _env_int("RANK", rank)
    size = _env_int("WORLD_SIZE", world_size)
    local = int(os.environ.get("LOCAL_RANK", rank)) if local_rank is None else int(local_rank)
    if not 0 <= rank < size:
        raise ValueError(f"rank {rank} outside a world of {size}")
    if device is None or torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "processes.init: no CUDA device is available; pass device='cpu' for "
                "processes on the CPU (gloo)"
            )
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
        backend = "nccl"
    elif torch.device(device).type == "cpu":
        dev, backend = torch.device("cpu"), "gloo"
    else:
        raise ValueError(f"processes.init: device must be a card or 'cpu', got {device!r}")
    kwargs = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(
        backend, init_method=init_method or "env://", rank=rank, world_size=size,
        timeout=datetime.timedelta(seconds=timeout_s), **kwargs,
    )
    # the default group's communicator, made now and not inside a capture
    one = torch.ones(1, device=dev)
    dist.all_reduce(one)
    if int(one.item()) != size:
        raise RuntimeError(f"processes.init: a world of {size} summed ones to {one.item()}")
    from repro_torch.obs import trace as _obs

    _obs.set_rank(rank)
    _WORLD = World(rank, size, dev, backend)
    return _WORLD


def initialized() -> bool:
    """Whether this process has joined a world through :func:`init`."""
    return _WORLD is not None


def world() -> World:
    if _WORLD is None:
        raise RuntimeError("no world: call repro_torch.dist.processes.init() first")
    return _WORLD


def process_mesh(shape: Sequence[int], axis_names: Sequence[str]) -> Mesh:
    """A :class:`Mesh` of ``shape`` over the world's processes: rank ``r``
    is process ``r`` on that process's device; this process is
    ``mesh.process_rank``.

    A mesh smaller than the world (its size dividing the world's) is a
    *block* of it: the world splits into blocks of consecutive processes,
    this process holds rank ``world.rank % size`` of block ``world.rank //
    size`` (``mesh.process_base`` is the block's first process), and every
    block runs the same ranks on the same inputs, each on its own
    processes.  A slot axis factored out of the world
    (``dist.sharding.factor_slot_mesh``) lays the blocks side by side."""
    w = world()
    shape = tuple(int(n) for n in shape)
    n = int(np.prod(shape))
    if n < 1 or w.size % n:
        raise ValueError(f"a process mesh of {shape} needs {n} processes, or a number that "
                         f"divides the world's; the world has {w.size}")
    names: list = [None] * w.size
    dist.all_gather_object(names, str(w.device))
    base = w.rank - w.rank % n
    devices = np.empty(n, dtype=object)
    for r, d in enumerate(names[base:base + n]):
        devices[r] = torch.device(d)
    return Mesh(devices.reshape(shape), axis_names, process_rank=w.rank - base,
                process_base=base)


def broadcast_object(obj):
    """Process 0's ``obj`` (any picklable value) on every process; the
    value itself outside a world."""
    if _WORLD is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def axis_group(mesh: Mesh, axes) -> tuple:
    """``(group, ranks)`` of this process along ``axes`` (a name or a
    tuple of names) of process mesh ``mesh``: the processes whose
    coordinates differ only along those axes, in rank order (which is
    row-major order over ``axes`` in the mesh's axis order), ``ranks``
    their mesh ranks.  Every process creates every group of the
    partition, of every block of the world, in the same order, the first
    time any of them asks; meshes of one shape and axes share them."""
    if not mesh.processes:
        raise ValueError("axis_group takes a process mesh")
    axes = tuple(axes) if isinstance(axes, (tuple, list)) else (axes,)
    key = tuple(a for a in mesh.axis_names if a in axes)
    if len(key) != len(set(axes)):
        raise ValueError(f"axes {axes} are not distinct axes of {mesh.axis_names}")
    cache_key = (mesh.devices.shape, mesh.axis_names, key)
    if cache_key not in _GROUPS:
        parts: dict = {}
        for r in range(mesh.size):
            c = mesh.coords(r)
            parts.setdefault(tuple(c[a] for a in mesh.axis_names if a not in key), []).append(r)
        ranks = sorted(parts.values())
        blocks = world().size // mesh.size
        mine, _ = dist.new_subgroups_by_enumeration(
            [[b * mesh.size + r for r in g] for b in range(blocks) for g in ranks])
        _GROUPS[cache_key] = (mine, next(g for g in ranks if mesh.process_rank in g))
    return _GROUPS[cache_key]


def _block(mesh: Mesh, axes):
    """``(group, mesh ranks)`` of ``axes`` (``None``: every axis): the
    default group where that is the whole world."""
    if axes is None:
        if mesh.size == world().size:
            return None, list(range(mesh.size))
        axes = mesh.axis_names
    return axis_group(mesh, axes)


def all_gather(x: torch.Tensor, mesh: Mesh, axes=None) -> list:
    """Every process's ``x`` (one shape and dtype on all) of this
    process's group along ``axes`` (``None``: the whole world), in rank
    order; this process's own entry is ``x`` itself."""
    x = x.contiguous()
    group, ranks = _block(mesh, axes)
    out = [torch.empty_like(x) for _ in ranks]
    dist.all_gather(out, x, group=group)
    out[ranks.index(mesh.process_rank)] = x
    return out


def gather_to(x: torch.Tensor, mesh: Mesh, dst: int = 0) -> Optional[list]:
    """Every process's ``x`` (one shape and dtype on all) on the process
    of rank ``dst`` (of each block), in rank order (its own entry is ``x``
    itself); ``None`` on the other processes, which only send."""
    x = x.contiguous()
    out = [torch.empty_like(x) for _ in range(mesh.size)] if mesh.process_rank == dst else None
    group, _ = _block(mesh, None)
    dist.gather(x, out, dst=mesh.process_base + dst, group=group)
    if out is not None:
        out[dst] = x
    return out


def barrier() -> None:
    """Wait until every process of the world gets here."""
    w = world()
    if w.backend == "nccl":
        dist.barrier(device_ids=[w.device.index])
    else:
        dist.barrier()


def shutdown() -> None:
    """Leave the world (destroys every process group).  The graphs of the
    compile cache's steps are released first (NCCL destroys no
    communicator while a graph that captured its work lives); graphs the
    caller still holds must be released before (``release_graphs``)."""
    global _WORLD
    if _WORLD is not None:
        import gc

        from repro_torch import api

        api.release_all_graphs()
        gc.collect()
        if _WORLD.device.type == "cuda":
            torch.cuda.synchronize(_WORLD.device)
        dist.destroy_process_group()
        _GROUPS.clear()
        from repro_torch.obs import trace as _obs

        _obs.set_rank(None)
        _WORLD = None
