"""One compile surface: ``Program`` / ``Target`` / ``compile`` (port of
``repro.api``).

    prog   = oec_like.ProgramBuilder(...).finish(boundary="periodic")
    step   = compile(prog, Target(backend="cuda"))   # CompiledStencil
    state  = step.time_loop((u0,), 100)              # tensors on the card
    step.pipeline_report                             # per-pass timings
    step.local_ir                                    # the comm-lowered IR

    mesh   = Mesh(np.array([dev] * 4, dtype=object).reshape(2, 2), ("x", "y"))
    step   = compile(prog, Target(mesh=mesh, strategy=make_strategy_2d((2, 2)),
                                  backend="cuda"))   # four ranks
    state  = step.time_loop((u0,), 100)              # sharded once, gathered once

- ``Program``  — the frontend-neutral IR artifact every frontend
  produces, with the same fingerprint as ``repro.api.Program`` for the
  same IR and metadata.
- ``Target``   — a frozen description of how to compile: mesh of ranks
  and decomposition strategy (both ``None``: one device), compute backend
  (``"torch"`` ≙ the reference's ``"jnp"``, ``"cuda"`` ≙ ``"pallas"``),
  pass-pipeline spec and flags, epoch depth, and the device.  Mismatches
  are rejected at construction.
- ``compile(program, target) -> CompiledStencil`` — runs the shared pass
  pipeline and wraps the tensor interpreter; over a mesh, one rank-local
  function runs on every rank (``dist.sharding.shard_map``).  Results are
  cached process-wide on ``(program.fingerprint, target.fingerprint)``.

Everything runs on the card unless the target says ``device="cpu"`` or
its mesh's devices are CPUs.  Not ported yet (ROADMAP Queue 1):
``slot_axis``, ``donate``/``jit``, ``cost()``, ``Target.auto``/``tuned``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import threading
from collections import OrderedDict
from typing import Any, Callable, Optional, Sequence

import torch

from repro_torch.core import ir
from repro_torch.core.dialects import stencil
from repro_torch.core.lowering import StencilInterpreter
from repro_torch.core.passes import PassManager, PipelineContext, build_pipeline
from repro_torch.core.passes.decompose import SlicingStrategy
from repro_torch.dist.sharding import (
    Mesh,
    PartitionSpec,
    ShardedTensor,
    gather,
    reshard,
    shard_map,
)
from repro_torch.kernels import has_cuda


class TargetError(ValueError):
    """A target description that can never compile (bad backend, missing
    device, epoch depth the program cannot take)."""


# --------------------------------------------------------------------------
# Program — the frontend-neutral IR artifact
# --------------------------------------------------------------------------


class Program:
    """A verified stencil program plus the metadata compilation needs.

    The fingerprint is taken at construction (stable textual IR +
    boundary + name + field names), so mutate the ``FuncOp`` *before*
    wrapping it.
    """

    def __init__(
        self,
        func: ir.FuncOp,
        boundary: str = "zero",
        field_names: Optional[Sequence[str]] = None,
        name: Optional[str] = None,
    ) -> None:
        if boundary not in ("zero", "periodic"):
            raise ValueError(f"unknown boundary condition {boundary!r}")
        ir.verify_module(func)
        self.func = func
        self.boundary = boundary
        self.name = name or func.sym_name
        self.field_args = [
            a for a in func.body.args if isinstance(a.type, stencil.FieldType)
        ]
        self.field_names = tuple(
            field_names
            if field_names is not None
            else (f"field{i}" for i in range(len(self.field_args)))
        )
        if len(self.field_names) != len(self.field_args):
            raise ValueError(
                f"{len(self.field_names)} field names for "
                f"{len(self.field_args)} field arguments"
            )
        # metadata is part of the identity: a cache hit must hand back an
        # artifact whose .program matches in name/fields, not just in IR
        self._salt = (
            f"boundary={boundary}",
            f"name={self.name}",
            "fields=" + ",".join(self.field_names),
        )
        self.fingerprint = ir.fingerprint(func, *self._salt)

    @property
    def rank(self) -> int:
        return self.field_args[0].type.bounds.rank if self.field_args else 0

    @property
    def output_fields(self) -> list:
        """Field arguments that are stored to, in first-store order."""
        return _stored_fields(self.func)

    @property
    def input_fields(self) -> list:
        """Field arguments never stored to: the time-loop state, oldest →
        newest."""
        outs = set(self.output_fields)
        return [f for f in self.field_args if f not in outs]

    def ir_text(self) -> str:
        """The stable textual IR (what the fingerprint hashes)."""
        return ir.print_module(self.func)

    def global_zeros(self, dtype=torch.float32, device="cuda") -> list:
        return [
            torch.zeros(f.type.bounds.shape, dtype=dtype, device=device)
            for f in self.field_args
        ]

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"Program({self.name!r}, rank={self.rank}, "
            f"fields={list(self.field_names)}, boundary={self.boundary!r}, "
            f"fingerprint={self.fingerprint})"
        )


# --------------------------------------------------------------------------
# Target — how and where to compile
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Target:
    """Frozen bundle of everything 'backend' about a compile.

    ``mesh``/``strategy`` describe the decomposition (both ``None``: one
    device): the strategy splits array dims over mesh axes of the same
    sizes, and the mesh's devices say where each rank's shard lives.
    ``backend`` picks the compute lowering (``"torch"``: plain tensor ops;
    ``"cuda"``: full and interior applies through kernel K1, fused epochs
    through kernel K2); ``pipeline`` is an explicit pass spec (DESIGN.md
    §2 grammar) overriding the ``fuse``/``cse``/``diagonal``/``overlap``
    flags; ``exchange_every=k`` makes one call a k-step deep-halo epoch;
    ``fused_epoch`` runs each epoch as one K2 launch; ``tile`` is K2's
    tile (the counterpart of the reference's ``pallas_tile``; K1 has no
    tiles and ignores it); ``device`` is where the tensors live (with a
    mesh: its devices' type, which ``device`` may only repeat).
    Validation happens here, at construction.
    """

    mesh: Optional[Mesh] = None
    strategy: Optional[SlicingStrategy] = None
    backend: str = "torch"  # "torch" | "cuda"
    pipeline: Optional[str] = None
    fuse: bool = True
    cse: bool = True
    overlap: bool = False
    diagonal: bool = False
    # Deep-halo temporal tiling (temporal-tile pass): exchange a depth-k
    # halo once, then run k stencil steps with redundant boundary compute.
    # One call of the compiled artifact is one *epoch* of k time steps;
    # ``time_loop`` keeps counting single steps and iterates in epochs.
    exchange_every: int = 1
    # Fuse each epoch's apply chain into ONE launch of kernel K2
    # (fuse-epoch-kernel pass + kernels/epoch_kernel.py): the k sub-steps'
    # frames stay in shared memory.  Requires backend="cuda"; incompatible
    # with overlap (split frame applies cannot fuse into one kernel).
    fused_epoch: bool = False
    # K2's tile over the epoch's core (None: kernels/epoch_kernel.py
    # choose_tile).  K1 picks its own tile (stencil_apply.SLICE_TILE) and ignores it.
    tile: Optional[tuple] = None
    # None: the mesh's device type, else "cuda"
    device: Optional[str] = None

    def __post_init__(self) -> None:
        if self.backend not in ("torch", "cuda"):
            raise TargetError(
                f"unknown backend {self.backend!r}; expected 'torch' or 'cuda'"
            )
        if self.tile is not None:
            tile = tuple(self.tile)
            if any(int(t) != t or t < 1 for t in tile):
                raise TargetError(f"tile {tile} must be positive integers")
            object.__setattr__(self, "tile", tuple(int(t) for t in tile))
        if self.fused_epoch:
            if self.backend != "cuda":
                raise TargetError(
                    f"Target(fused_epoch=True) requires backend='cuda' (the "
                    f"epoch kernel K2 is a CUDA kernel), got "
                    f"backend={self.backend!r}"
                )
            if self.overlap:
                raise TargetError(
                    "Target(fused_epoch=True) is incompatible with "
                    "overlap=True: split interior/frame applies cannot fuse "
                    "into one epoch kernel"
                )
        if self.mesh is not None and not isinstance(self.mesh, Mesh):
            raise TargetError(
                f"mesh must be a repro_torch.dist.Mesh, got {type(self.mesh).__name__}"
            )
        if self.device is None:
            object.__setattr__(
                self, "device", self.mesh.device_type if self.mesh is not None else "cuda"
            )
        dev = torch.device(self.device)
        if dev.type not in ("cuda", "cpu"):
            raise TargetError(f"device must be a CUDA device or 'cpu', got {self.device!r}")
        if self.mesh is not None and dev.type != self.mesh.device_type:
            raise TargetError(
                f"Target(device={self.device!r}) but the mesh's devices are "
                f"{self.mesh.device_type}: with a mesh, its devices decide where "
                "tensors live"
            )
        object.__setattr__(self, "device", str(dev))
        if int(self.exchange_every) != self.exchange_every or self.exchange_every < 1:
            raise TargetError(
                f"exchange_every must be a positive integer (1 = exchange "
                f"every step), got {self.exchange_every!r}"
            )
        object.__setattr__(self, "exchange_every", int(self.exchange_every))
        if self.pipeline is not None:
            from repro_torch.core.passes import parse_pipeline

            stages = parse_pipeline(self.pipeline)  # raises if malformed
            has_fuse_stage = any(name == "fuse-epoch-kernel" for name, _ in stages)
            if has_fuse_stage != self.fused_epoch:
                raise TargetError(
                    f"explicit pipeline "
                    f"{'contains' if has_fuse_stage else 'lacks'} the "
                    f"fuse-epoch-kernel stage but "
                    f"Target(fused_epoch={self.fused_epoch}); set both "
                    "consistently (the kernel routing is driven by the "
                    "Target knob)"
                )
            # an explicit pipeline must agree with exchange_every: the
            # time_loop epoch arithmetic is driven by the Target knob
            k_spec = 1
            for name, opts in stages:
                if name == "temporal-tile":
                    try:
                        k_spec = int(opts.get("k", self.exchange_every))
                    except ValueError:
                        raise TargetError(
                            f"pipeline stage temporal-tile: k must be an "
                            f"integer, got {opts.get('k')!r}"
                        )
            if k_spec != self.exchange_every:
                raise TargetError(
                    f"pipeline stage temporal-tile{{k={k_spec}}} disagrees "
                    f"with Target(exchange_every={self.exchange_every}); "
                    "set both to the same epoch depth"
                )

        s = self.strategy
        if s is not None:
            decomposed = [
                (g, ax) for g, ax in zip(s.grid_shape, s.axis_names) if g > 1
            ]
            if decomposed and self.mesh is None:
                raise TargetError(
                    f"strategy decomposes over {[ax for _, ax in decomposed]} "
                    "but no mesh was given"
                )
            for g, ax in decomposed:
                if ax not in self.mesh.axis_names:
                    raise TargetError(
                        f"strategy axis {ax!r} not in mesh axes "
                        f"{tuple(self.mesh.axis_names)}"
                    )
                if self.mesh.shape[ax] != g:
                    raise TargetError(
                        f"strategy grid size {g} on axis {ax!r} != mesh size "
                        f"{self.mesh.shape[ax]}"
                    )

    @property
    def distributed(self) -> bool:
        """True when the compiled step runs over a mesh of ranks: a
        spatial decomposition with more than one rank."""
        return self.mesh is not None and self.strategy is not None and any(
            g > 1 for g in self.strategy.grid_shape
        )

    @property
    def spatial_ranks(self) -> int:
        """Ranks of the spatial decomposition grid (1 when undecomposed)."""
        if self.strategy is None:
            return 1
        out = 1
        for g in self.strategy.grid_shape:
            out *= int(g)
        return out

    def pipeline_spec(self) -> str:
        """The pass-pipeline spec this target denotes (explicit ``pipeline``
        or the canonical flag expansion, fig. 4): [fuse,cse] → decompose →
        swap-elim → [temporal-tile] → [diagonal] → [overlap] → lower-comm."""
        if self.pipeline is not None:
            return self.pipeline
        stages: list[str] = []
        if self.fuse:
            stages.append("fuse")
        if self.cse:
            stages += ["cse", "dce"]
        stages += ["decompose", "swap-elim"]
        if self.exchange_every > 1:
            stages.append(f"temporal-tile{{k={self.exchange_every}}}")
        if self.diagonal:
            stages.append("diagonal")
        if self.overlap:
            stages.append("overlap")
        stages.append("lower-comm")
        if self.fused_epoch:
            # after lower-comm: the fused region holds only apply +
            # boundary_mask ops; exchanges stay outside the kernel
            stages.append("fuse-epoch-kernel")
        return ",".join(stages)

    @property
    def fingerprint(self) -> str:
        mesh_desc = "none" if self.mesh is None else self.mesh.describe()
        s = self.strategy
        strat_desc = (
            "none" if s is None
            else f"grid={tuple(s.grid_shape)}axes={tuple(s.axis_names)}dims={tuple(s.dims)}"
        )
        text = "\n".join(
            [
                f"mesh={mesh_desc}",
                f"strategy={strat_desc}",
                f"backend={self.backend}",
                f"pipeline={self.pipeline_spec()}",
                # explicit even though the default spec carries it: an
                # explicit ``pipeline`` must still produce distinct cached
                # artifacts per epoch depth (time_loop arithmetic differs)
                f"exchange_every={self.exchange_every}",
                f"fused_epoch={self.fused_epoch}",
                f"tile={self.tile}",
                f"device={self.device}",
            ]
        )
        return hashlib.sha256(text.encode()).hexdigest()[:16]


# --------------------------------------------------------------------------
# CompiledStencil — the reusable artifact
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PipelineReport:
    """What the pass pipeline did for one compile: the resolved spec and
    per-pass wall-clock timings."""

    spec: str
    timings: tuple  # ((pass name, seconds), ...)

    def __str__(self) -> str:
        lines = [f"pipeline: {self.spec}"]
        for name, sec in self.timings:
            lines.append(f"  {name:<16} {sec * 1e3:8.2f} ms")
        return "\n".join(lines)


class CompiledStencil:
    """A compiled stencil step: callable over whole-domain tensors, plus
    the artifacts a user inspects — the comm-lowered rank-local IR, the
    pipeline report and the partition specs.

    Two calling conventions: ``__call__`` and ``step()`` take and return
    global tensors (over a mesh: shard once, run every rank, gather once);
    ``advance`` takes and returns the time-loop state as it lives between
    epochs (over a mesh: :class:`~repro_torch.dist.ShardedTensor` s, see
    :meth:`shard_state`).  ``time_loop`` shards once, keeps the state
    sharded across every epoch and gathers once at the end."""

    def __init__(
        self,
        program: Program,
        target: Target,
        strategy: SlicingStrategy,
        local_ir: ir.FuncOp,
        pipeline_report: PipelineReport,
        interp: StencilInterpreter,
        ret_indices: tuple,
        partition_specs: tuple,
    ) -> None:
        self.program = program
        self.target = target
        self.strategy = strategy
        self.local_ir = local_ir
        self.pipeline_report = pipeline_report
        self.partition_specs = partition_specs
        self._interp = interp
        # buffers step() allocates internally: the program's stored fields
        self._out_indices = tuple(
            program.field_args.index(f) for f in program.output_fields
        )
        # field-arg positions of the values a call RETURNS (first-store
        # order of the local IR) — equals _out_indices except for epoched
        # carried-state programs (wave, p > q), whose epochs also hand
        # back the rotated-through intermediate buffers
        self._ret_indices = ret_indices
        self._local_fields = [
            a for a in local_ir.body.args if isinstance(a.type, stencil.FieldType)
        ]
        # output buffers whose first store covers the whole field are
        # never read, so step() need not zero them
        first_store: dict = {}
        for op in local_ir.body.ops:
            if isinstance(op, stencil.StoreOp):
                first_store.setdefault(op.field, op.bounds == op.field.type.bounds)
        self._overwritten = {
            i for i, f in enumerate(self._local_fields) if first_store.get(f, False)
        }
        self._mesh = target.mesh if target.distributed else None
        if self._mesh is None:
            self._fn = interp
        else:
            mesh = self._mesh
            coords = [mesh.coords(r) for r in range(mesh.size)]
            self._fn = shard_map(
                lambda local: interp.run_ranks(local, coords),
                mesh=mesh,
                in_specs=partition_specs,
                out_specs=tuple(partition_specs[i] for i in ret_indices),
            )

    # -- execution -------------------------------------------------------
    def __call__(self, *arrays):
        """One call over every field (global tensors in and out)."""
        return tuple(gather(x) for x in self._fn(*arrays))

    @property
    def input_indices(self) -> tuple:
        """Field-arg positions ``step()`` consumes (the time-loop state,
        oldest → newest); the complement of the internally-allocated
        output buffers."""
        outs = set(self._out_indices)
        return tuple(
            i for i in range(len(self.program.field_args)) if i not in outs
        )

    @property
    def ret_indices(self) -> tuple:
        """Field-arg positions of the values one call RETURNS (first-store
        order of the local IR)."""
        return self._ret_indices

    def _alloc(self, i: int, dtype):
        """Output buffer of field ``i``: one local tensor per rank over a
        mesh (never a global one), else a tensor on the target's device."""
        shape = tuple(self._local_fields[i].type.bounds.shape)
        alloc = torch.empty if i in self._overwritten else torch.zeros
        if self._mesh is None:
            return alloc(shape, dtype=dtype, device=self.target.device)
        mesh, spec = self._mesh, self.partition_specs[i]
        return ShardedTensor(
            mesh, spec,
            tuple(alloc(shape, dtype=dtype, device=mesh.device(r)) for r in range(mesh.size)),
            tuple(self.program.field_args[i].type.bounds.shape),
        )

    def _step_over(self, dtype=None) -> Callable:
        """The input-only calling convention: output buffers are allocated
        here, results come back as the artifact holds them (sharded over a
        mesh)."""
        outs = set(self._out_indices)

        def fn(*inputs):
            it = iter(inputs)
            dt = dtype or (inputs[0].dtype if inputs else torch.float32)
            args = [
                self._alloc(i, dt) if i in outs else next(it)
                for i in range(len(self.program.field_args))
            ]
            rest = list(it)
            if rest:
                raise ValueError(f"{len(rest)} extra input tensors")
            return self._fn(*args)

        return fn

    def step(self, dtype=None) -> Callable:
        """A step over the *input* fields only (global tensors in and out):
        output buffers are allocated internally — the shape ``time_loop``
        rotation wants.  With ``Target(exchange_every=k)`` one call
        advances a k-step epoch."""
        inner = self._step_over(dtype)
        return lambda *inputs: tuple(gather(x) for x in inner(*inputs))

    def epochs(self, n_steps: int) -> int:
        """``n_steps`` time steps as a whole number of epochs of this
        artifact: a depth-k artifact advances k steps per call, so
        ``n_steps`` must divide evenly."""
        k = self.target.exchange_every
        if n_steps % k != 0:
            raise ValueError(
                f"n_steps={n_steps} with "
                f"Target(exchange_every={k}): n_steps must be a multiple of "
                f"the epoch depth (each call advances {k} steps)"
            )
        return n_steps // k

    def shard_state(self, state: Sequence[Any]) -> tuple:
        """The time-loop state (oldest → newest; tensors, float32 numpy
        arrays or sharded tensors) as :meth:`advance` keeps it: one
        ``ShardedTensor`` per buffer over a mesh, else plain tensors."""
        specs = [self.partition_specs[i] for i in self.input_indices]
        return reshard(state, self._mesh, specs)

    def advance(self, state: Sequence[Any]) -> tuple:
        """One epoch with time-buffer rotation applied: consume ``state``
        (oldest → newest), return the rotated state after
        ``exchange_every`` time steps — one iteration of ``time_loop``.
        Over a mesh the state stays sharded (global tensors are sharded
        first, see :meth:`shard_state`)."""
        state = self.shard_state(state)
        return _rotate(state, self._step_over()(*state))

    def time_loop(self, state: Sequence[Any], n_steps: int) -> tuple:
        """Iterate ``n_steps`` *time steps* with time-buffer rotation
        (``state`` ordered oldest→newest); runs ``self.epochs(n_steps)``
        epochs.  Over a mesh the state is sharded once, stays sharded
        across every epoch and is gathered once at the end."""
        n_epochs = self.epochs(n_steps)
        state = self.shard_state(state)
        for _ in range(n_epochs):
            state = self.advance(state)
        return tuple(gather(x) for x in state)

    # -- inspection ------------------------------------------------------
    def kernel_applies(self) -> list:
        """The applies one call hands to kernel K1 on each rank, in
        execution order."""
        return self._interp.kernel_applies()

    def kernel_epochs(self) -> list:
        """The fused epochs one call hands to kernel K2 on each rank, in
        execution order (empty for the ``torch`` backend)."""
        return self._interp.kernel_epochs()

    @property
    def kernel_dispatches(self) -> dict:
        """Static kernel-op census of one epoch of the compiled program on
        each rank: with ``Target(fused_epoch=True)`` an epoched program
        reads ``{"fused_epoch": 1, "apply": 0, "total": 1}``."""
        fused = sum(
            1 for op in self.local_ir.body.ops if isinstance(op, stencil.FusedEpochOp)
        )
        applies = sum(
            1 for op in self.local_ir.body.ops if isinstance(op, stencil.ApplyOp)
        )
        return {"fused_epoch": fused, "apply": applies, "total": fused + applies}

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"CompiledStencil({self.program.name!r}, "
            f"backend={self.target.backend!r}, device={self.target.device!r}, "
            f"distributed={self.target.distributed}, "
            f"pipeline={self.pipeline_report.spec!r})"
        )


# --------------------------------------------------------------------------
# compile + the process-wide cache
# --------------------------------------------------------------------------


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


# LRU-bounded, as in the reference: a long-lived process compiles an
# open-ended stream of (program, target) pairs.  Override the capacity
# with REPRO_COMPILE_CACHE_CAP.
_DEFAULT_CAPACITY = 256
_CACHE: "OrderedDict[tuple, Any]" = OrderedDict()
_CAPACITY = max(1, int(os.environ.get("REPRO_COMPILE_CACHE_CAP", _DEFAULT_CAPACITY)))
_STATS = CacheStats()
# The global lock guards the dicts only; builds run under a per-key lock,
# so concurrent compiles of the SAME key return the same artifact while
# unrelated compiles stay parallel.
_LOCK = threading.RLock()
_KEY_LOCKS: dict[tuple, threading.Lock] = {}


def cache_stats() -> CacheStats:
    """Process-wide compile-cache counters."""
    return _STATS


def clear_cache() -> None:
    with _LOCK:
        _CACHE.clear()
        _KEY_LOCKS.clear()
        _STATS.hits = 0
        _STATS.misses = 0
        _STATS.evictions = 0


def _cached(key: tuple, build: Callable[[], Any]) -> Any:
    with _LOCK:
        if key in _CACHE:
            _STATS.hits += 1
            _CACHE.move_to_end(key)  # LRU freshness
            return _CACHE[key]
        key_lock = _KEY_LOCKS.setdefault(key, threading.Lock())
    with key_lock:
        with _LOCK:
            if key in _CACHE:  # built by the thread we waited on
                _STATS.hits += 1
                _CACHE.move_to_end(key)
                return _CACHE[key]
        out = build()
        with _LOCK:
            _STATS.misses += 1
            _CACHE[key] = out
            while len(_CACHE) > _CAPACITY:
                old, _ = _CACHE.popitem(last=False)
                _KEY_LOCKS.pop(old, None)
                _STATS.evictions += 1
        return out


def trivial_strategy(rank: int) -> SlicingStrategy:
    names = ("x", "y", "z", "w")[:rank]
    return SlicingStrategy((1,) * rank, names, tuple(range(rank)))


def compile(program: Program, target: Optional[Target] = None) -> CompiledStencil:
    """Compile ``program`` for ``target`` (default: the torch backend on
    the card).  Cached process-wide on ``(program.fingerprint,
    target.fingerprint)``."""
    target = target or Target()
    if target.device.startswith("cuda") and not has_cuda():
        raise TargetError(
            f"Target(device={target.device!r}) but no CUDA device is "
            "available; pass device='cpu' to run on the CPU"
        )
    _validate_for_program(program, target)
    # the fingerprint is taken at Program construction; a func mutated
    # afterwards would poison the cache under a stale key — refuse it
    if ir.fingerprint(program.func, *program._salt) != program.fingerprint:
        raise ValueError(
            f"Program {program.name!r}: IR was mutated after construction; "
            "run rewrites on the FuncOp first, then wrap it in a Program"
        )
    key = ("compile", program.fingerprint, target.fingerprint)
    return _cached(key, lambda: _build(program, target))


def _validate_for_program(program: Program, target: Target) -> None:
    s = target.strategy
    if s is not None:
        for g, d in zip(s.grid_shape, s.dims):
            if d >= program.rank:
                raise TargetError(
                    f"strategy decomposes dim {d} of a rank-{program.rank} "
                    f"program {program.name!r}"
                )
            if g > 1:
                for f in program.field_args:
                    extent = f.type.bounds.shape[d]
                    if extent % g != 0:
                        raise TargetError(
                            f"dim {d} extent {extent} of {program.name!r} not "
                            f"divisible by grid size {g}"
                        )
    if target.tile is not None:
        _validate_tile(program, target)
    if target.exchange_every > 1:
        _validate_exchange_every(program, target)


def _grid_of_dim(target: Target) -> dict:
    """``{dim: (grid size, mesh axis)}`` of the target's decomposition."""
    s = target.strategy
    if s is None:
        return {}
    return {d: (g, ax) for g, ax, d in zip(s.grid_shape, s.axis_names, s.dims)}


def _where(g: int, ax: Optional[str]) -> str:
    return f"mesh axis {ax!r}" if ax is not None and g > 1 else "undecomposed"


def _validate_exchange_every(program: Program, target: Target) -> None:
    """A depth-k epoch exchanges a k-times-accumulated halo in one shot;
    the send slab must come out of the neighbour's core, so the deep width
    cannot exceed the local shard extent on any axis."""
    from repro_torch.core.passes.temporal import TemporalTilingError, epoch_halo

    k = target.exchange_every
    try:
        lo1, hi1 = epoch_halo(program.func, 1)
        lok, hik = epoch_halo(program.func, k)
    except TemporalTilingError as e:
        raise TargetError(
            f"Target(exchange_every={k}) cannot epoch program "
            f"{program.name!r}: {e}"
        )
    if not program.field_args:
        return
    grid_of_dim = _grid_of_dim(target)
    shape = program.field_args[0].type.bounds.shape
    for d in range(program.rank):
        g, ax = grid_of_dim.get(d, (1, None))
        local_n = shape[d] // g
        deep = max(lok[d], hik[d])
        step = max(lo1[d], hi1[d])
        if deep > local_n:
            max_k = local_n // step if step else k
            raise TargetError(
                f"Target(exchange_every={k}) on {program.name!r}: deep halo "
                f"{deep} (inferred per-step depth {step}, accumulated over "
                f"{k} steps) along dim {d} ({_where(g, ax)}) exceeds the local "
                f"shard extent {local_n}; use exchange_every <= {max_k} or "
                f"decompose dim {d} over fewer ranks"
            )


def _validate_tile(program: Program, target: Target) -> None:
    """A tile must have the program's rank and divide the *local shard*
    (the core of every epoch K2 sees on a rank) — named here, with the
    shard shape and the mesh axis, not deep in the kernel."""
    tile = target.tile
    if not program.field_args:
        return
    rank = program.rank
    if len(tile) != rank:
        raise TargetError(
            f"tile {tile} has {len(tile)} dims but program {program.name!r} "
            f"is rank-{rank}"
        )
    grid_of_dim = _grid_of_dim(target)
    shape = program.field_args[0].type.bounds.shape
    local = tuple(shape[d] // grid_of_dim.get(d, (1, None))[0] for d in range(rank))
    for d in range(rank):
        if local[d] % tile[d]:
            g, ax = grid_of_dim.get(d, (1, None))
            raise TargetError(
                f"tile {tile} does not divide the local shard shape {local} of "
                f"program {program.name!r}: dim {d} extent {local[d]} is not a "
                f"multiple of {tile[d]} ({_where(g, ax)}); pick a dividing "
                "tile or drop it for K2's own"
            )


def partition_specs(program: Program, strategy: SlicingStrategy) -> list:
    """PartitionSpec per field argument, from the decomposition map."""
    specs = []
    for f in program.field_args:
        rank = f.type.bounds.rank
        entries: list = [None] * rank
        for gax, d in enumerate(strategy.dims):
            if d < rank and strategy.grid_shape[gax] > 1:
                entries[d] = strategy.axis_names[gax]
        specs.append(PartitionSpec(*entries))
    return specs


def _build(program: Program, target: Target) -> CompiledStencil:
    strategy = target.strategy or trivial_strategy(program.rank)
    spec = target.pipeline_spec()
    ctx = PipelineContext(
        strategy=strategy,
        boundary=program.boundary,
        exchange_every=target.exchange_every,
    )
    pm = PassManager(build_pipeline(spec, ctx))
    local = pm.run(_clone_func(program.func))
    report = PipelineReport(spec=spec, timings=tuple(pm.timings))
    interp = StencilInterpreter(
        local,
        axis_sizes=dict(target.mesh.shape) if target.mesh is not None else {},
        distributed=target.distributed,
        backend=target.backend,
        tile=target.tile,
    )
    # return arity/order comes from the LOCAL IR (first-store order): an
    # epoched carried-state program (wave, p > q) stores — and returns —
    # more buffers per call than the single-step program does
    local_fields = [
        a for a in local.body.args if isinstance(a.type, stencil.FieldType)
    ]
    ret_indices = tuple(local_fields.index(f) for f in _stored_fields(local))
    return CompiledStencil(
        program=program,
        target=target,
        strategy=strategy,
        local_ir=local,
        pipeline_report=report,
        interp=interp,
        ret_indices=ret_indices,
        partition_specs=tuple(partition_specs(program, strategy)),
    )


# --------------------------------------------------------------------------
# Shared helpers
# --------------------------------------------------------------------------


def _stored_fields(func: ir.FuncOp) -> list:
    out = []
    for op in func.body.ops:
        if isinstance(op, stencil.StoreOp) and op.field not in out:
            out.append(op.field)
    return out


def _clone_func(func: ir.FuncOp) -> ir.FuncOp:
    new = ir.FuncOp(func.sym_name, [a.type for a in func.body.args])
    vmap: dict[ir.SSAValue, ir.SSAValue] = {}
    for oa, na in zip(func.body.args, new.body.args):
        vmap[oa] = na
    for op in func.body.ops:
        new.body.add_op(op.clone_into(vmap))
    return new


def _rotate(state: tuple, outs) -> tuple:
    outs = outs if isinstance(outs, tuple) else (outs,)
    return tuple(state[len(outs):]) + outs


# --------------------------------------------------------------------------
# Time-loop driver (paper benchmarks iterate stencils over timesteps)
# --------------------------------------------------------------------------


def time_loop(step: Callable, state: Sequence[Any], n_steps: int) -> tuple:
    """Iterate ``step`` with time-buffer rotation.

    ``state`` is ordered oldest→newest; each call consumes the full state
    and produces the newest buffer(s), which rotate in:
    ``state' = state[k:] + outs``.  A Python loop: each call enqueues its
    kernels on the current stream without waiting for the card.
    """
    state = tuple(state)
    for _ in range(n_steps):
        state = _rotate(state, step(*state))
    return state
