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
its mesh's devices are CPUs.

One process per rank (``dist.processes``, started by ``torchrun``): over
a process mesh every process compiles the same target and calls the
same methods with the same global tensors; each runs its own rank, its
exchanges are NCCL sends and receives (gloo on the CPU), and every
process gets the global results.  ``Target(jit=True)`` captures each
process's epoch, its sends and receives included, as one CUDA graph.
A single-controller mesh over several cards still runs op by op.

``Target(jit=True)`` (the default, as in the reference) is the compiled
step.  On the card each call of the artifact is one replay of a captured
``torch.cuda.CUDAGraph`` that holds every op of the epoch on every rank,
every K1 and K2 launch included; the first call with a signature runs
once eagerly (building every kernel), then captures and replays.  On the
CPU ``jit`` changes nothing: the plain route runs op by op.  With
``donate=True`` the caller hands its buffers over (``donate_argnums``
names every field argument, as ``jax.jit`` is given them): ``advance``
and ``time_loop`` keep the state in a fixed ring of buffers with one
graph per rotation phase, and a call replays with no copy; with
``donate=False`` inputs are copied into the graph's buffers and results
come back as copies.  Each graph's own kernel nodes are counted after its
capture (:mod:`repro_torch.kernels.graphs`), and each replay adds them to
``dispatch_stats()``.

``CompiledStencil.cost()`` is the roofline of one call with an H100's
terms (:mod:`repro_torch.launch.roofline`, counted from the local IR);
``Target.auto`` decomposes 1-D over the cards (or ranks repeated on one
device); ``Target.tuned`` and ``compile(program, tune=...)`` search the
``Target`` space (:mod:`repro_torch.tune`).  ``resilient_loop`` and
``resume`` are the checkpointing time loop of
:mod:`repro_torch.resilience`.  With tracing on (:mod:`repro_torch.obs`)
``advance`` and ``time_loop`` record one ``epoch`` span per epoch.

Slot pools (the serving engine, :mod:`repro_torch.serve.stencil`): a call
may give every field one leading slot dim, ``[B, *shape]``, and then
advances ``B`` independent simulations at once, each bitwise as a call of
its own (the port's counterpart of the reference's ``jax.vmap`` over the
step: K1 and K2 take the slot count as a launch argument).  Over a mesh,
``Target(slot_axis=...)`` names a mesh axis that carries that dim
(``pooled_target`` factors one out of the device inventory, or out of
the world's processes), so one call runs every slot block of ``(slot,
*spatial)`` ranks.  Over a process mesh each process holds ``[B / slots,
*its spatial block]`` of every field and exchanges with the processes of
its own slot block.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import math
import os
import threading
import weakref
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
    _global_shape,
    gather,
    reshard,
    shard_map,
)
from repro_torch.kernels import _DISPATCH, has_cuda
from repro_torch.kernels.graphs import census as _census
from repro_torch.obs import trace as _obs


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
    mesh: its devices' type, which ``device`` may only repeat); ``jit``
    runs each call on the card as one CUDA graph replay (nothing changes
    on the CPU) and ``donate`` hands the caller's buffers over to it.
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
    # Slot mesh axis (serving / ensemble batching): the name of a mesh axis
    # that carries a leading *batch* ("slot") dimension instead of an array
    # dimension.  The compiled step then takes tensors of shape
    # ``[B, *field_shape]`` and runs over ``(slot, *spatial)`` ranks: the
    # batch dim is split over the slot axis and each rank advances its rows
    # in one launch per kernel, so exchanges stay per-slot correct (they
    # only ever run over the spatial axes).  ``B`` must divide by the
    # slot axis's size.  Factored out of the device inventory with
    # ``pooled_target`` / ``dist.sharding.factor_slot_mesh``: how the serve
    # engine dispatches a whole distributed slot pool as one call.  Over a
    # process mesh every process holds its slot block's rows of its
    # spatial block and exchanges with its own slot block's processes.
    slot_axis: Optional[str] = None
    # K2's tile over the epoch's core (None: kernels/epoch_kernel.py
    # choose_tile).  K1 picks its own tile (stencil_apply.SLICE_TILE) and ignores it.
    tile: Optional[tuple] = None
    # None: the mesh's device type, else "cuda"
    device: Optional[str] = None
    # Donate every field buffer to the compiled step (the caller hands
    # over ownership; inputs are invalid after the call).  Off by default,
    # as in the reference: only safe when the caller rotates buffers.
    donate: bool = False
    # The compiled step: on the card one call is one CUDA graph replay
    # over every rank; on the CPU the plain route runs as it is.
    jit: bool = True

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
        processes = self.mesh is not None and self.mesh.processes
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
        if processes:
            # the device type alone, the same on every process (so are the
            # fingerprints): "cuda" is this process's current card
            own = self.mesh.device(self.mesh.process_rank)
            if dev.type == "cuda" and dev.index is not None and dev != own:
                raise TargetError(
                    f"Target(device={self.device!r}) over a process mesh whose rank "
                    f"{self.mesh.process_rank} (this process) is on {own}"
                )
            dev = torch.device(dev.type)
        object.__setattr__(self, "device", str(dev))
        if self.jit and self.mesh is not None and not processes and self.mesh.device_type == "cuda":
            cards = {str(d) for d in self.mesh.devices.flat}
            if len(cards) > 1:
                raise TargetError(
                    f"Target(jit=True) over a mesh on {len(cards)} CUDA devices "
                    f"({sorted(cards)}): one captured graph runs on one device; for ranks "
                    "on several cards use a process mesh (dist.processes.process_mesh, "
                    "one process per card), or pass jit=False to run them op by op "
                    "from one thread"
                )
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

        if self.slot_axis is not None:
            # validated here like exchange_every: a slot-axis target either
            # compiles or names the mismatch at construction
            if not isinstance(self.slot_axis, str) or not self.slot_axis:
                raise TargetError(f"slot_axis must be a mesh axis name, got {self.slot_axis!r}")
            if self.mesh is None:
                raise TargetError(
                    f"Target(slot_axis={self.slot_axis!r}) needs a mesh carrying that axis; "
                    "factor one out of the device inventory with api.pooled_target / "
                    "dist.sharding.factor_slot_mesh"
                )
            if self.slot_axis not in self.mesh.axis_names:
                raise TargetError(
                    f"slot_axis {self.slot_axis!r} not in mesh axes {tuple(self.mesh.axis_names)}"
                )
            if self.strategy is not None and self.slot_axis in tuple(self.strategy.axis_names):
                raise TargetError(
                    f"slot_axis {self.slot_axis!r} is already a spatial decomposition axis of "
                    f"the strategy {tuple(self.strategy.axis_names)}; the slot axis carries "
                    "the batch dimension, not an array dimension"
                )
        s = self.strategy
        if processes:
            # one rank a process: the strategy decomposes every axis but the
            # slot axis (which splits the pool's rows over slot blocks)
            grid = {} if s is None else {
                ax: g for g, ax in zip(s.grid_shape, s.axis_names) if g > 1
            }
            want = {a: n for a, n in self.mesh.shape.items() if n > 1 and a != self.slot_axis}
            if s is None or grid != want:
                raise TargetError(
                    f"a process mesh of {dict(self.mesh.shape)} needs a strategy that "
                    "decomposes over every axis of it but the slot axis, with the mesh's "
                    "sizes (one rank a process); got "
                    f"{None if s is None else dict(zip(s.axis_names, s.grid_shape))}"
                )
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
        spatial decomposition with more than one rank, a slot mesh axis,
        both, or a process mesh (of any size)."""
        if self.mesh is not None and (self.slot_axis is not None or self.mesh.processes):
            return True
        return self.mesh is not None and self.strategy is not None and any(
            g > 1 for g in self.strategy.grid_shape
        )

    @property
    def spatial_ranks(self) -> int:
        """Ranks per slot: the product of the spatial decomposition grid
        (1 when undecomposed)."""
        if self.strategy is None:
            return 1
        out = 1
        for g in self.strategy.grid_shape:
            out *= int(g)
        return out

    @classmethod
    def auto(cls, ranks: Optional[int] = None, **overrides) -> "Target":
        """Device discovery: decompose 1-D over the CUDA devices (or the
        first ``ranks`` of them); a single-device target when one rank is
        asked for or one card exists.  A ``device`` among ``overrides``
        pins every rank to that one device (``device="cpu"``: ``ranks``
        virtual ranks on the CPU, one by default).  Ranks on several cards
        run op by op (``jit=False``; one captured graph runs on one card).
        Without a ``device`` and without a card, or with more ranks than
        cards, raises ``TargetError``.

        Inside a world (``dist.processes.init``) it decomposes 1-D over the
        world's processes instead, one rank a process, with ``jit=True``
        (``ranks``, if given, must be the world's size)."""
        from repro_torch.dist import processes

        device = overrides.get("device")
        if processes.initialized():
            w = processes.world()
            if ranks is not None and int(ranks) != w.size:
                raise TargetError(f"Target.auto: {ranks} ranks in a world of {w.size} processes")
            from repro_torch.core.passes.decompose import make_strategy_1d

            kw = {"jit": True, **overrides}
            return Target(mesh=processes.process_mesh((w.size,), ("x",)),
                          strategy=make_strategy_1d(w.size), **kw)
        if device is not None:
            devices = [torch.device(device)] * (1 if ranks is None else max(int(ranks), 1))
        elif not has_cuda():
            raise TargetError(
                "Target.auto: no CUDA device is available; pass device='cpu' "
                "for ranks on the CPU"
            )
        else:
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        return auto_target(devices, ranks, **overrides)

    @classmethod
    def tuned(
        cls,
        program: "Program",
        ranks: Optional[int] = None,
        *,
        measure: bool = True,
        cache: bool = True,
        **tune_kwargs,
    ) -> "Target":
        """The autotuned target for ``program`` on this machine
        (``repro_torch.tune``): enumerate the mesh/overlap/exchange_every/
        backend/tile space, score it with the roofline model, optionally
        measure the survivors, and return the winner — persisted on disk
        so a second call (any process, same hardware) is a cache hit."""
        from repro_torch.tune import tune

        return tune(
            program, ranks=ranks, measure=measure, cache=cache, **tune_kwargs
        ).target

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
                # explicit even though the mesh desc carries the axis: a
                # slot-axis artifact has another calling convention
                # ([B, *shape] tensors), so it must never collide with its
                # spatial-only sibling in the compile cache
                f"slot_axis={self.slot_axis}",
                f"fused_epoch={self.fused_epoch}",
                f"tile={self.tile}",
                f"device={self.device}",
                f"jit={self.jit}",
                f"donate={self.donate}",
            ]
        )
        return hashlib.sha256(text.encode()).hexdigest()[:16]


def several_cards(devices: Sequence) -> bool:
    """Whether ``devices`` hold more than one CUDA device: ranks there run
    op by op (``jit=False``), since one captured graph runs on one card."""
    return len({str(torch.device(d)) for d in devices if torch.device(d).type == "cuda"}) > 1


def auto_target(devices: Sequence, ranks: Optional[int] = None, **overrides) -> Target:
    """:meth:`Target.auto` over ``devices`` (``torch.device`` s; they may
    repeat): the first ``ranks`` of them (default all) as a 1-D mesh
    decomposing dim 0, or one device.  Over several cards the target
    runs op by op (``jit=False``) unless ``overrides`` say otherwise."""
    devices = [torch.device(d) for d in devices]
    n = len(devices) if ranks is None else int(ranks)
    if n > len(devices):
        raise TargetError(f"requested {n} ranks, have {len(devices)} devices")
    if n <= 1:
        return Target(**{"device": str(devices[0]), **overrides})
    from repro_torch.core.passes.decompose import make_strategy_1d

    kw = {"jit": not several_cards(devices[:n]), **overrides}
    return Target(mesh=Mesh(devices[:n], ("x",)), strategy=make_strategy_1d(n), **kw)


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


@dataclasses.dataclass(frozen=True)
class LoweredCall:
    """What :meth:`CompiledStencil.lower` gives in place of XLA's
    ``Lowered``: one rank's arguments of one call (meta tensors of the
    local shapes), each argument's spec over the mesh, and one rank's
    argument bytes."""

    args: tuple
    specs: tuple
    argument_bytes: int


class CompiledStencil:
    """A compiled stencil step: callable over whole-domain tensors, plus
    the artifacts a user inspects — the comm-lowered rank-local IR, the
    pipeline report and the partition specs.

    Two calling conventions: ``__call__`` and ``step()`` take and return
    global tensors (over a mesh: shard once, run every rank, gather once);
    ``advance`` takes and returns the time-loop state as it lives between
    epochs (over a mesh: :class:`~repro_torch.dist.ShardedTensor` s, see
    :meth:`shard_state`).  ``time_loop`` shards once, keeps the state
    sharded across every epoch and gathers once at the end.

    Each of them also takes slot pools: every tensor ``[B, *field_shape]``
    (the reference's ``jax.vmap`` of the step).  On one device any ``B``
    goes; over a mesh only a slot-axis target (``Target(slot_axis=...)``)
    takes them, with ``B`` split over the slot axis, and it takes nothing
    else.  Each pool width has its own ring of the compiled step."""

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
            self._coords = [{}]
            self._fn = interp
        else:
            mesh = self._mesh
            coords = self._coords = [mesh.coords(r) for r in mesh.local_ranks]
            self._fn = shard_map(
                lambda local: interp.run_ranks(local, coords),
                mesh=mesh,
                in_specs=partition_specs,
                out_specs=tuple(partition_specs[i] for i in ret_indices),
            )
        # every field argument when the step is compiled with donation, as
        # the reference hands jax.jit its donate_argnums
        self.donate_argnums = (
            tuple(range(len(program.field_args))) if target.donate and target.jit else ()
        )
        self._ring: Optional[_Ring] = None
        self._jit_on_card = target.jit and torch.device(target.device).type == "cuda"

    # -- the compiled step (CUDA graphs) -----------------------------------
    def _graphed(self) -> bool:
        """Whether this call runs as a graph replay: ``jit`` on the card,
        untraced (with ``repro_torch.obs`` tracing on, the call runs op by
        op, as the reference's traced loop runs its unjitted function)."""
        return self._jit_on_card and not _obs.enabled()

    def _enter(self, state: tuple) -> tuple:
        """``(ring, phase)`` of a graphed call on ``state`` (as
        :meth:`shard_state` gives it).  With donation, a state that is the
        ring's live phase runs in place, and one that holds a buffer of the
        ring the last call did not return raises; any other state is
        copied into phase 0 of the ring (a new ring where the caller may
        still hold what the current one handed out, or where the state's
        pool width is not the ring's)."""
        ring = self._ring
        lead = self._local_lead(state)
        if ring is None or ring.lead != lead:
            ring = self._ring = _Ring(self, lead)
        if self.target.donate:
            if ring.stale(state):
                raise RuntimeError(
                    "this state holds a buffer donated to an earlier call of the "
                    "compiled step (Target(donate=True)), which newer results may "
                    "have overwritten; pass only what the last call returned"
                )
            p = ring.exact_phase(state)
            if p is not None and not ring.held(state):
                return ring, p  # the last call's results, in place: no copy
        if ring.held(state):
            ring = self._ring = _Ring(self, lead)
        ring.fill(state, 0)
        return ring, 0

    # -- execution -------------------------------------------------------
    def __call__(self, *arrays):
        """One call over every field (global tensors in and out)."""
        if not self._graphed():
            return tuple(gather(x) for x in self._fn(*arrays))
        n = len(self.program.field_args)
        if len(arrays) != n:
            raise ValueError(f"{len(arrays)} tensors for {n} field arguments")
        outs_init = {
            i: reshard([arrays[i]], self._mesh, [self.partition_specs[i]])[0]
            for i in self._out_indices if i not in self._overwritten
        }
        return self._graph_call([arrays[i] for i in self.input_indices], outs_init)

    def _graph_call(self, inputs: Sequence[Any], outs_init: Optional[dict] = None) -> tuple:
        """One graph replay over the input fields (global tensors or, over
        a mesh, sharded ones); returns global tensors."""
        ring, p = self._enter(self.shard_state(inputs))
        ring.replay(p, outs_init)
        return tuple(self._give(x) for x in ring.results(p))

    def _give(self, x):
        """A result of the ring as the caller gets it: over a mesh
        gathered (a new tensor); on one device the ring's own buffer with
        donation (handed out), else a copy."""
        if isinstance(x, ShardedTensor):
            return gather(x)
        if self.target.donate:
            return self._ring.hand_out([x])[0]
        return x.clone()

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

    def _lead(self, tensors: Sequence[Any]) -> tuple:
        """The slot dim (``()`` or ``(B,)``, global) that the call's tensors
        (global or sharded) carry; a slot-axis target takes only pools, and
        a target over a mesh without a slot axis takes none."""
        if not tensors:
            return ()
        x = tensors[0]
        lead = tuple(x.shape[: max(len(x.shape) - self.program.rank, 0)])
        if self.target.slot_axis is not None and len(lead) != 1:
            raise ValueError(
                f"Target(slot_axis={self.target.slot_axis!r}) takes [B, *field_shape] slot "
                f"pools; got a tensor of shape {tuple(x.shape)}"
            )
        if lead and self._mesh is not None and self.target.slot_axis is None:
            raise ValueError(
                "a slot pool over a mesh needs a slot-axis target (api.pooled_target); "
                f"got a tensor of shape {tuple(x.shape)}"
            )
        return lead

    def _local_lead(self, state: Sequence[Any]) -> tuple:
        """Each rank's slot dim of a state as :meth:`shard_state` gives it."""
        self._lead(state)
        if not state:
            return ()
        t = _shards(state[0])[0]
        return tuple(t.shape[: t.ndim - self.program.rank])

    def _alloc(self, i: int, dtype, lead: tuple = ()):
        """Output buffer of field ``i`` (with the global slot dim ``lead``):
        one local tensor per rank over a mesh (never a global one), else a
        tensor on the target's device."""
        shape = tuple(self._local_fields[i].type.bounds.shape)
        alloc = torch.empty if i in self._overwritten else torch.zeros
        if self._mesh is None:
            return alloc(tuple(lead) + shape, dtype=dtype, device=self.target.device)
        mesh, spec = self._mesh, self.partition_specs[i]
        local_lead = tuple(n // mesh.shape[spec[0]] for n in lead)
        return ShardedTensor(
            mesh, spec,
            tuple(alloc(local_lead + shape, dtype=dtype, device=mesh.device(r))
                  for r in mesh.local_ranks),
            tuple(lead) + tuple(self.program.field_args[i].type.bounds.shape),
        )

    def _step_over(self, dtype=None) -> Callable:
        """The input-only calling convention: output buffers are allocated
        here, results come back as the artifact holds them (sharded over a
        mesh)."""
        outs = set(self._out_indices)

        def fn(*inputs):
            it = iter(inputs)
            dt = dtype or (inputs[0].dtype if inputs else torch.float32)
            lead = self._lead(inputs)
            args = [
                self._alloc(i, dt, lead) if i in outs else next(it)
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

        def fn(*inputs):
            if self._graphed():
                if dtype not in (None, torch.float32):
                    raise TypeError(f"stencil tensors must be float32, got {dtype} (no implicit cast)")
                return self._graph_call(inputs)
            return tuple(gather(x) for x in inner(*inputs))

        return fn

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
        arrays or sharded tensors, on any device or mesh) as
        :meth:`advance` keeps it: one ``ShardedTensor`` per buffer over a
        mesh, else plain tensors on the target's device."""
        self._lead(state)  # names a misplaced slot dim before resharding
        specs = [self.partition_specs[i] for i in self.input_indices]
        out = reshard(state, self._mesh, specs)
        if self._mesh is None:
            out = tuple(x.to(self.target.device) for x in out)
        return out

    @property
    def _n_ranks(self) -> int:
        """Ranks per slot block: the spatial ranks (a slot axis not
        counted)."""
        slots = self._mesh.shape[self.target.slot_axis] if self.target.slot_axis else 1
        return (self._mesh.size if self._mesh is not None else 1) // slots

    def sync(self) -> None:
        """Wait for the card(s) the step runs on (nothing on the CPU)."""
        devices = [torch.device(self.target.device)] if self._mesh is None else [
            self._mesh.device(r) for r in self._mesh.local_ranks
        ]
        for d in dict.fromkeys(d for d in devices if d.type == "cuda"):
            torch.cuda.synchronize(d)

    def advance(self, state: Sequence[Any], *, epoch: Optional[int] = None,
                step_begin: Optional[int] = None) -> tuple:
        """One epoch with time-buffer rotation applied: consume ``state``
        (oldest → newest), return the rotated state after
        ``exchange_every`` time steps — one iteration of ``time_loop``.
        Over a mesh the state stays sharded (global tensors are sharded
        first, see :meth:`shard_state`).  With tracing on, one ``epoch``
        span (DESIGN.md §12; tagged ``epoch`` and ``step_begin`` where
        given), closed once the card has finished the epoch."""
        span = contextlib.nullcontext()
        if _obs.enabled():
            tags = {n: v for n, v in (("epoch", epoch), ("step_begin", step_begin))
                    if v is not None}
            span = _obs.span("epoch", cat="dispatch", rank=None, program=self.program.name,
                             **tags, k=self.target.exchange_every, ranks=self._n_ranks)
        with span:
            state = self.shard_state(state)
            if not self._graphed():
                state = _rotate(state, self._step_over()(*state))
            else:
                ring, p = self._enter(state)
                ring.replay(p)
                if self.target.donate:
                    state = ring.hand_out(ring.state(ring.rotate(p)))
                else:
                    state = tuple(state[ring.n_ret:]) + tuple(_copy(x) for x in ring.results(p))
            if _obs.enabled():
                self.sync()
        return state

    def time_loop(self, state: Sequence[Any], n_steps: int) -> tuple:
        """Iterate ``n_steps`` *time steps* with time-buffer rotation
        (``state`` ordered oldest→newest); runs ``self.epochs(n_steps)``
        epochs.  Over a mesh the state is sharded once, stays sharded
        across every epoch and is gathered once at the end.  Compiled
        (``jit`` on the card), the state is copied into the ring once,
        every epoch is one graph replay and the result is copied out once
        (handed out as it is, on one device with donation).

        With tracing on (``repro_torch.obs``) every epoch runs op by op
        in a host loop, as the reference's traced loop runs its unjitted
        step: one ``epoch`` span per epoch (tagged ``epoch`` and
        ``step_begin``), closed once the card has finished it, with the
        epoch's exchange windows and apply spans inside.  Same
        arithmetic; benchmark numbers should be taken untraced.  For a
        checkpointing loop with the same arithmetic, see
        ``repro_torch.resilience.ResilientLoop``."""
        n_epochs = self.epochs(n_steps)
        state = self.shard_state(state)
        if not self._graphed():
            k = self.target.exchange_every
            for e in range(n_epochs):
                state = self.advance(state, epoch=e, step_begin=e * k)
            return tuple(gather(x) for x in state)
        ring, p = self._enter(state)
        for _ in range(n_epochs):
            ring.replay(p)
            p = ring.rotate(p)
        if self.target.donate and self._mesh is None:
            return ring.hand_out(ring.state(p))
        return tuple(_copy(x) for x in ring.state(p))

    # -- inspection ------------------------------------------------------
    def kernel_applies(self) -> list:
        """The applies one call hands to kernel K1 on each rank, in
        execution order."""
        return self._interp.kernel_applies()

    def kernel_out_strides(self, apply_op) -> Optional[tuple]:
        """Per result of one of :meth:`kernel_applies`, the strides of the
        view K1 writes it into (its slice of an in-place ``stencil.combine``),
        or ``None`` where K1 writes contiguous results: the ``out_strides``
        its source is emitted with."""
        return self._interp.out_strides(apply_op)

    def release_graphs(self) -> None:
        """Drop the compiled step's graphs and ring buffers (their device
        memory goes back once nothing else holds it); the next graphed call
        captures anew."""
        self._ring = None

    def for_pool(self) -> "CompiledStencil":
        """A new artifact of this one's lowered program for a serving slot
        pool: its target donates (``donate=True``), so under ``jit`` the
        pool lives in the artifact's own ring and each :meth:`advance`
        advances it in place, copying no pool in or out, and rotates it
        through the ring's phases as :meth:`time_loop` does.  Nothing is
        lowered again; each call gives an artifact with a ring of its own,
        released with :meth:`release_graphs`."""
        return CompiledStencil(
            program=self.program,
            target=dataclasses.replace(self.target, donate=True),
            strategy=self.strategy,
            local_ir=self.local_ir,
            pipeline_report=self.pipeline_report,
            interp=self._interp,
            ret_indices=self._ret_indices,
            partition_specs=self.partition_specs,
        )

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

    def kernel_sources(self) -> list:
        """The CUDA sources of the K1 and K2 launches one call makes on
        16-byte-aligned operands (each rank's launches share them), so that
        they can be built together before the first call
        (``kernels.stencil_apply.build``)."""
        from repro_torch.kernels import epoch_kernel, stencil_apply

        out = [
            stencil_apply.emit_apply_cuda(
                a, [tuple(o.type.bounds.shape) for o in a.operands],
                [tuple(o.type.bounds.lb) for o in a.operands], a.result_bounds,
                out_strides=self.kernel_out_strides(a),
            )
            for a in self.kernel_applies()
        ]
        out += [epoch_kernel.emit_epoch_cuda(e, self.target.tile) for e in self.kernel_epochs()]
        return list(dict.fromkeys(out))

    def lower(self, dtype=torch.float32) -> "LoweredCall":
        """The dry run's stand-in for the reference's ``jax.jit(...).lower``
        with ``ShapeDtypeStruct`` inputs: one rank's arguments of one call
        as meta tensors (nothing is allocated), their specs and their
        bytes.  The port compiles nothing ahead of time, so there is no
        XLA ``Lowered`` (no ``.compile()``, no ``memory_analysis()``):
        ``argument_bytes`` is the one number of it that the arguments
        decide.  A slot-axis target is lowered at one row per slot-axis
        rank, as the reference lowers it."""
        mesh = self._mesh
        slot = self.target.slot_axis
        lead = (int(mesh.shape[slot]),) if slot is not None else ()
        args, specs = [], []
        for f, spec in zip(self.program.field_args, self.partition_specs):
            shape = lead + tuple(f.type.bounds.shape)
            spec = PartitionSpec(*(((slot,) if slot is not None else ()) + tuple(spec)))
            local = tuple(
                n // math.prod(mesh.shape[a] for a in (() if e is None else (e,)))
                if mesh is not None else n
                for n, e in zip(shape, tuple(spec) + (None,) * len(shape))
            )
            args.append(torch.empty(local, dtype=dtype, device="meta"))
            specs.append(spec)
        return LoweredCall(
            tuple(args), tuple(specs), sum(a.numel() * a.element_size() for a in args)
        )

    def cost(self, dtype=torch.float32):
        """Roofline terms of one call (``launch.roofline``): per-rank
        operations / device-memory bytes / collective bytes, counted from
        the local IR (``launch.roofline.count_ir``: the least each op must
        do) → seconds per term on an H100, the dominant bottleneck,
        overlapped/serial time — plus the temporal-tiling tradeoff terms
        (message count per epoch, per-step halo widths, shard extents) so
        ``.cost().recommend_exchange_every()`` can pick the epoch depth that
        balances amortized exchange latency against redundant boundary
        compute.  Nothing runs: no card is needed."""
        from repro_torch.core.dialects import comm
        from repro_torch.core.passes.temporal import TemporalTilingError, epoch_halo
        from repro_torch.launch.roofline import RooflineTerms, count_ir

        counts = count_ir(
            self.local_ir,
            dict(self.target.mesh.shape) if self.target.distributed else {},
            itemsize=torch.empty((), dtype=dtype).element_size(),
        )
        step_halo: tuple = ()
        try:
            lo1, hi1 = epoch_halo(self.program.func, 1)
            step_halo = tuple(max(l, h) for l, h in zip(lo1, hi1))
        except TemporalTilingError:
            pass  # non-epochable program shapes carry no tiling terms
        local_shape: tuple = ()
        if self.program.field_args:
            local_shape = self.strategy.local_bounds(
                self.program.field_args[0].type.bounds
            ).shape
        messages = sum(
            1
            for op in self.local_ir.body.ops
            if isinstance(op, comm.ExchangeStartOp)
        )
        return RooflineTerms(
            flops=counts.flops,
            bytes_accessed=counts.bytes_accessed,
            collectives=counts.collectives,
            exchange_every=self.target.exchange_every,
            messages_per_epoch=messages,
            step_halo=step_halo,
            local_shape=local_shape,
        )

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"CompiledStencil({self.program.name!r}, "
            f"backend={self.target.backend!r}, device={self.target.device!r}, "
            f"distributed={self.target.distributed}, jit={self.target.jit}, "
            f"donate={self.target.donate}, pipeline={self.pipeline_report.spec!r})"
        )


# --------------------------------------------------------------------------
# The compiled step on the card: a ring of buffers, one CUDA graph a phase
# --------------------------------------------------------------------------


@dataclasses.dataclass
class GraphStats:
    """Counts of CUDA graph captures and replays since the last reset, and
    the kernel nodes the replays ran, by kernel name (as
    :func:`repro_torch.kernels.graphs.census` reads them from each graph)."""

    captures: int = 0  # one per rotation phase of a ring, at its first call
    replays: int = 0   # one per graphed call (an epoch)
    kernel_nodes: dict = dataclasses.field(default_factory=dict)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


_GRAPHS = GraphStats()


def graph_stats() -> GraphStats:
    return _GRAPHS


def reset_graph_stats() -> None:
    _GRAPHS.captures = _GRAPHS.replays = 0
    _GRAPHS.kernel_nodes = {}


def _copy(x):
    """A copy of a ring buffer that shares nothing with it: a global
    tensor over a mesh (gathered), else a clone."""
    return gather(x) if isinstance(x, ShardedTensor) else x.clone()


def _shards(x) -> tuple:
    return x.shards if isinstance(x, ShardedTensor) else (x,)


class _Ring:
    """The buffers and graphs of one compiled step on the card.

    The time-loop state rotates: a call consumes ``n_in`` buffers (oldest
    → newest) and returns ``n_ret``, and the next state is the last
    ``n_in - n_ret`` inputs followed by the results.  The ring holds
    ``n = n_in + n_ret`` float32 buffers (per rank), one per slot.  Where
    every slot has one local shape and layout, the state rotates through
    the ring: phase ``p`` reads slots ``(p * n_ret + i) % n`` and stores
    its results into the slots after them, so phase ``p + 1`` reads what
    phase ``p`` left; after ``n / gcd(n, n_ret)`` phases the ring is where
    it began (heat: 2 phases, wave: 3, wave's epochs with carried state:
    2).  Otherwise (fields of differing shapes) the ring has one phase, and
    :meth:`rotate` copies the next state into its input slots.  Each phase is one
    ``torch.cuda.CUDAGraph`` of ``StencilInterpreter.run_ranks`` over
    every rank, with the phase's result slots as the interpreter's
    destinations, so the graph's results land in the ring; all the phases
    capture into one memory pool, which holds the intermediates of one
    phase at a time.  A graph is captured at the first replay of its
    phase, after the phase has run once eagerly on a side stream (that
    builds and loads every kernel: no build, library load or occupancy
    query may happen inside a capture).  A capture that fails raises.

    A ring on the CPU runs each phase op by op instead, with the same
    buffers, destinations and rotation.

    After a capture the graph's own nodes are counted
    (:func:`repro_torch.kernels.graphs.census`): it must hold one K1 or K2
    kernel node for every launch the wrappers made while it was captured,
    or the capture raises.  Each replay then adds the graph's K1 and K2
    nodes to ``dispatch_stats()``'s launches, and every kernel node to
    ``graph_stats().kernel_nodes``."""

    def __init__(self, stencil: CompiledStencil, lead: tuple = ()) -> None:
        self.st = stencil
        self.capture = torch.device(stencil.target.device).type == "cuda"
        self.n_in = len(stencil.input_indices)
        self.n_ret = len(stencil.ret_indices)
        self.n = self.n_in + self.n_ret
        self.lead = tuple(lead)  # each rank's slot dim: a ring holds one pool width
        fields = stencil._local_fields
        slots = list(stencil.input_indices) + list(stencil.ret_indices)
        self.kinds = [
            (self.lead + tuple(fields[f].type.bounds.shape), tuple(stencil.partition_specs[f]))
            for f in slots
        ]
        rotates = len(set(self.kinds)) == 1 and self.n_ret > 0
        self.phases = self.n // math.gcd(self.n, self.n_ret) if rotates else 1
        mesh = stencil._mesh
        self.devices = (
            [torch.device(stencil.target.device)] if mesh is None
            else [mesh.device(r) for r in mesh.local_ranks]
        )
        self.bufs = [
            tuple(torch.empty(shape, dtype=torch.float32, device=d) for d in self.devices)
            for shape, _ in self.kinds
        ]
        self.storages = {b.untyped_storage().data_ptr() for bufs in self.bufs for b in bufs}
        # each phase's input slots by their data pointers: the state a call
        # returned is found by one lookup
        self.keys = {
            tuple(b.data_ptr() for i in range(self.n_in) for b in self.bufs[self._slot(p, i)]): p
            for p in range(self.phases)
        }
        # phase -> (CUDAGraph, its census, the wrapper calls its capture made)
        self.graphs: dict = {}
        self.pool = torch.cuda.graph_pool_handle() if self.capture else None
        self.live: Optional[int] = None  # phase of the state last handed out
        self.handed: list = []  # weak references to what was handed out
        # output fields whose first store leaves points unwritten: zeroed
        # (or set from the caller's tensor) before each replay, as step()
        # allocates them zeroed
        self.partial = [i for i in stencil._out_indices if i not in stencil._overwritten]

    # -- slots -------------------------------------------------------------
    def _slot(self, p: int, i: int) -> int:
        """Ring slot of phase ``p``'s state position ``i`` (results at
        ``n_in + j``)."""
        return (p * self.n_ret + i) % self.n

    def _wrap(self, slot: int):
        shards = self.bufs[slot]
        mesh = self.st._mesh
        if mesh is None:
            return shards[0]
        shape, spec = self.kinds[slot]
        spec = PartitionSpec(*spec)
        return ShardedTensor(mesh, spec, shards, _global_shape(shape, mesh, spec))

    def state(self, p: int) -> tuple:
        """Phase ``p``'s input state, the ring's own buffers."""
        return tuple(self._wrap(self._slot(p, i)) for i in range(self.n_in))

    def results(self, p: int) -> tuple:
        """What a replay of phase ``p`` returns, in the ring."""
        return tuple(self._wrap(self._slot(p, self.n_in + j)) for j in range(self.n_ret))

    def exact_phase(self, state: Sequence[Any]) -> Optional[int]:
        """The phase whose input slots ``state`` is, tensor for tensor."""
        return self.keys.get(tuple(t.data_ptr() for x in state for t in _shards(x)))

    def stale(self, state: Sequence[Any]) -> bool:
        """Whether ``state`` holds a buffer of the ring that the last call
        did not hand out (one donated to an earlier call)."""
        last = {id(r()) for r in self.handed}
        return any(
            id(x) not in last
            and any(t.untyped_storage().data_ptr() in self.storages for t in _shards(x))
            for x in state
        )

    def held(self, state: Sequence[Any]) -> bool:
        """Whether anything handed out is still alive outside ``state``."""
        mine = {id(x) for x in state}
        return any(r() is not None and id(r()) not in mine for r in self.handed)

    def hand_out(self, xs: Sequence[Any]) -> tuple:
        """``xs`` (ring buffers, as :meth:`state` or :meth:`results` give
        them: new objects) to the caller, remembered weakly, so that a later
        foreign state can tell whether they are still held; on one device
        each is a new view of its buffer."""
        out = tuple(x if isinstance(x, ShardedTensor) else x.view(x.shape) for x in xs)
        self.handed += [weakref.ref(x) for x in out]
        return out

    def fill(self, state: Sequence[Any], p: int) -> None:
        """Copy each tensor of ``state`` that is not already there into its
        input slot of phase ``p`` (a source that lies in the ring is copied
        first)."""
        if len(state) != self.n_in:
            raise ValueError(f"{len(state)} state tensors for a step of {self.n_in} inputs")
        ours = self.storages
        moves = []
        for i, x in enumerate(state):
            shards = _shards(x)
            if len(shards) != len(self.devices):
                raise ValueError(f"state {i}: {len(shards)} shards for {len(self.devices)} ranks")
            for src, dst in zip(shards, self.bufs[self._slot(p, i)]):
                if src.dtype != torch.float32:
                    raise TypeError(
                        f"stencil tensors must be float32, got {src.dtype} (no implicit cast)"
                    )
                if src.shape != dst.shape:
                    raise ValueError(
                        f"state {i}: a tensor of shape {tuple(src.shape)}, expected "
                        f"{tuple(dst.shape)}"
                    )
                if src.data_ptr() == dst.data_ptr():
                    continue
                moves.append((dst, src.clone() if src.untyped_storage().data_ptr() in ours else src))
        for dst, src in moves:
            dst.copy_(src)
        self.live = p

    # -- running -------------------------------------------------------------
    def _run(self, p: int) -> None:
        """Phase ``p`` op by op on every rank, its results stored into its
        result slots."""
        st = self.st
        per_rank, dests = [], []
        for r in range(len(self.devices)):
            d = {f: self.bufs[self._slot(p, self.n_in + j)][r]
                 for j, f in enumerate(st.ret_indices)}
            args = [None] * len(st._local_fields)
            for i, f in enumerate(st.input_indices):
                args[f] = self.bufs[self._slot(p, i)][r]
            for f in st._out_indices:
                args[f] = d[f]
            per_rank.append(args)
            dests.append(d)
        outs = st._interp.run_ranks(per_rank, st._coords, dests)
        for o, d in zip(outs, dests):
            if any(t is not d[f] for t, f in zip(o, st.ret_indices)):
                raise AssertionError("a result of the compiled step missed its ring slot")

    def _graph(self, p: int) -> tuple:
        if p in self.graphs:
            return self.graphs[p]
        dev = self.devices[0]
        name = f"phase {p} of the compiled step of {self.st.program.name!r}"
        with torch.cuda.device(dev):
            main = torch.cuda.current_stream(dev)
            side = torch.cuda.Stream(dev)
            side.wait_stream(main)
            with torch.cuda.stream(side):
                self._run(p)  # eager: builds, loads and first-launches every kernel
            main.wait_stream(side)
            before = _DISPATCH.as_dict()
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            # over processes the NCCL watchdog thread polls its events while
            # this thread captures: only this thread's calls must be safe
            mode = "thread_local" if self.st._mesh is not None and self.st._mesh.processes else "global"
            try:
                with torch.cuda.graph(graph, pool=self.pool, capture_error_mode=mode):
                    self._run(p)
                nodes = _census(graph)
                graph.instantiate()
            except Exception as e:
                raise RuntimeError(f"capturing {name} as a CUDA graph failed: {e}") from e
            finally:
                after = _DISPATCH.as_dict()
                for k, v in before.items():
                    setattr(_DISPATCH, k, v)
        made = {k: after[k] - before[k] for k in before}
        if (nodes.k1, nodes.k2) != (made["apply_launches"], made["fused_epoch_launches"]):
            raise RuntimeError(
                f"the CUDA graph of {name} holds {nodes.k1} K1 and {nodes.k2} K2 kernel "
                f"nodes, but its capture launched K1 {made['apply_launches']} and K2 "
                f"{made['fused_epoch_launches']} times"
            )
        _GRAPHS.captures += 1
        calls = {k: v for k, v in made.items() if k.endswith("_calls")}
        self.graphs[p] = (graph, nodes, calls)
        return self.graphs[p]

    def replay(self, p: int, outs_init: Optional[dict] = None) -> None:
        """Replay phase ``p`` (capturing it first if it is new); the output
        fields a store leaves partly unwritten start from ``outs_init``'s
        tensors (by field position) or zeros."""
        captured = self._graph(p) if self.capture else None
        for f in self.partial:
            j = self.st.ret_indices.index(f)
            src = (outs_init or {}).get(f)
            for r, dst in enumerate(self.bufs[self._slot(p, self.n_in + j)]):
                if src is None:
                    dst.zero_()
                else:
                    dst.copy_(_shards(src)[r])
        if captured is None:
            self._run(p)
        else:
            graph, nodes, calls = captured
            with torch.cuda.device(self.devices[0]):
                graph.replay()
            for k, v in calls.items():
                setattr(_DISPATCH, k, getattr(_DISPATCH, k) + v)
            _DISPATCH.apply_launches += nodes.k1
            _DISPATCH.fused_epoch_launches += nodes.k2
            for name, v in nodes.kernels.items():
                _GRAPHS.kernel_nodes[name] = _GRAPHS.kernel_nodes.get(name, 0) + v
            _GRAPHS.replays += 1
        self.live = (p + 1) % self.phases
        self.handed = []

    def rotate(self, p: int) -> int:
        """After a replay of phase ``p``: the phase whose input slots hold
        the next state (in a ring of one phase, copied there)."""
        if self.phases == 1:
            self.fill(self.state(0)[self.n_ret:] + self.results(0), 0)
        return self.live


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
    """Process-wide compile-cache counters (shared by ``compile``,
    ``lower_ir`` and ``cached_callable``): truthful hit/miss/eviction
    counts of the LRU-bounded cache."""
    return _STATS


def cache_capacity() -> int:
    return _CAPACITY


def set_cache_capacity(n: int) -> int:
    """Bound the process-wide compile cache to ``n`` entries (LRU
    eviction; evicting frees the artifact once nothing else holds it).
    Returns the previous capacity.  ``n`` must be >= 1: a serving process
    needs at least the artifact it is dispatching."""
    global _CAPACITY
    if int(n) < 1:
        raise ValueError(f"cache capacity must be >= 1, got {n!r}")
    with _LOCK:
        prev, _CAPACITY = _CAPACITY, int(n)
        _evict_over_capacity()
    return prev


def _evict_over_capacity() -> None:
    # caller holds _LOCK
    while len(_CACHE) > _CAPACITY:
        old, _ = _CACHE.popitem(last=False)
        _KEY_LOCKS.pop(old, None)
        _STATS.evictions += 1


def release_all_graphs() -> None:
    """Drop the graphs and ring buffers of every compiled step in the
    compile cache (each captures anew at its next graphed call).  Before a
    process leaves its world: NCCL waits for the graphs that captured its
    sends and receives to be destroyed before it destroys a communicator."""
    with _LOCK:
        steps = [v for v in _CACHE.values() if isinstance(v, CompiledStencil)]
    for step in steps:
        step.release_graphs()


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
            _evict_over_capacity()
        return out


def _key(program: Program, target: Target) -> tuple:
    return ("compile", program.fingerprint, target.fingerprint)


def is_cached(program: Program, target: Target) -> bool:
    """Whether the compile cache holds ``program`` compiled for ``target``."""
    with _LOCK:
        return _key(program, target) in _CACHE


def forget(program: Program, target: Target) -> None:
    """Release ``program`` compiled for ``target``: its compiled step's
    graphs are dropped and it leaves the compile cache (a later
    :func:`compile` builds it anew)."""
    with _LOCK:
        out = _CACHE.pop(_key(program, target), None)
        _KEY_LOCKS.pop(_key(program, target), None)
    if out is not None:
        out.release_graphs()


def lower_ir(
    func: ir.FuncOp,
    pipeline: str,
    strategy: Optional[SlicingStrategy] = None,
    boundary: str = "zero",
) -> ir.FuncOp:
    """Run a pass-pipeline spec over generated IR through the process-wide
    cache (keyed on the IR fingerprint and the spec)."""
    s = strategy
    strat_desc = "none" if s is None else f"{tuple(s.grid_shape)}{tuple(s.axis_names)}{tuple(s.dims)}"
    key = ("lower_ir", ir.fingerprint(func, f"boundary={boundary}"), pipeline, strat_desc)

    def build() -> ir.FuncOp:
        pm = PassManager(build_pipeline(pipeline, PipelineContext(strategy=s, boundary=boundary)))
        return pm.run(_clone_func(func))

    return _cached(key, build)


def cached_callable(key: tuple, build: Callable[[], Callable]) -> Callable:
    """Process-wide cache for compiled callables keyed by explicit
    fingerprints, built once per key.  Every caller of a key gets the same
    object, so it suits stateless callables: a compiled step run under
    ``jit`` on the card holds its ring (the serve engine memoizes its pool
    executables per bucket instead)."""
    return _cached(("callable",) + tuple(key), build)


def trivial_strategy(rank: int) -> SlicingStrategy:
    names = ("x", "y", "z", "w")[:rank]
    return SlicingStrategy((1,) * rank, names, tuple(range(rank)))


def compile(
    program: Program,
    target: Optional[Target] = None,
    *,
    tune=None,
) -> CompiledStencil:
    """Compile ``program`` for ``target`` (default: the torch backend on
    the card).

    ``tune=True`` (or a dict of ``repro_torch.tune.tune`` keyword
    arguments) picks the target with the autotuner instead — mutually
    exclusive with an explicit ``target``.

    Cached process-wide on ``(program.fingerprint, target.fingerprint)``."""
    if tune:
        if target is not None:
            raise ValueError(
                "pass either target= or tune=, not both (tune selects "
                "the target)"
            )
        target = Target.tuned(
            program, **(tune if isinstance(tune, dict) else {})
        )
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
    key = _key(program, target)
    span = contextlib.nullcontext()
    if _obs.enabled():
        with _LOCK:
            hit = key in _CACHE
        span = _obs.span("api.compile", cat="compile", program=program.name,
                         cache="hit" if hit else "miss")
    with span:
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
    elif any(g > 1 for g, _ in _grid_of_dim(target).values()):
        _validate_step_halo(program, target)


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


def _validate_step_halo(program: Program, target: Target) -> None:
    """At ``exchange_every=1`` a step still exchanges its chain's whole
    accumulated halo in one shot, and the send slab must come out of the
    immediate neighbour's core: on every decomposed dim the per-step depth
    may not exceed the local shard extent (the reference accepts such a
    target and returns wrong numbers; the port refuses it)."""
    from repro_torch.core.passes.temporal import TemporalTilingError, epoch_halo

    if not program.field_args:
        return
    grid_of_dim = _grid_of_dim(target)
    shape = program.field_args[0].type.bounds.shape
    local = {d: shape[d] // g for d, (g, _) in grid_of_dim.items() if g > 1}
    try:
        lo, hi = epoch_halo(program.func, 1)
        depth = {d: max(lo[d], hi[d]) for d in local}
    except TemporalTilingError:
        depth = {}
    if depth and all(depth[d] <= n for d, n in local.items()):
        return
    # what the pipeline really exchanges (also where epoch_halo cannot
    # analyse the program): the widths of the emitted swaps and exchanges
    from repro_torch.core.dialects import comm, dmp

    dim_of_axis = {ax: d for d, (_, ax) in grid_of_dim.items()}
    depth = dict.fromkeys(local, 0)
    ir_local, _ = lower_local(program, target)
    for op in ir_local.body.ops:
        if isinstance(op, dmp.SwapOp):
            lo, hi = op.halo_widths()
            for d in depth:
                depth[d] = max(depth[d], lo[d], hi[d])
        elif isinstance(op, comm.ExchangeStartOp):
            size = [a.value for a in op.attributes["size"]]
            for ax, step in op.axis_shifts:
                d = dim_of_axis.get(ax)
                if step and d in depth:
                    depth[d] = max(depth[d], size[d])
    for d, n in sorted(local.items()):
        if depth[d] > n:
            g, ax = grid_of_dim[d]
            raise TargetError(
                f"Target(exchange_every=1) on {program.name!r}: per-step halo "
                f"{depth[d]} along dim {d} ({_where(g, ax)}) exceeds the local "
                f"shard extent {n}; a rank takes its halo from its immediate "
                f"neighbour's core only: decompose dim {d} over fewer ranks"
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


def pooled_target(
    target: Target,
    slots: int = 1,
    axis: str = "slot",
    devices: Optional[Sequence] = None,
) -> Target:
    """The slot-axis sibling of a distributed ``target``: the same spatial
    decomposition plus a leading slot mesh axis of size ``slots`` factored
    out of the device inventory (``dist.sharding.factor_slot_mesh``;
    ``devices`` default to every card, and may repeat).

    The sibling's compiled step takes ``[B, *field_shape]`` tensors
    (``B % slots == 0``) and advances every row in one call over
    ``(slot, *spatial)`` ranks: the serve engine's pooled distributed
    dispatch, and an ensemble axis (one compiled stencil over ``B``
    perturbed initial conditions).  Over a process mesh the slot axis is
    factored out of the world's processes, whose number ``slots ×
    spatial`` must divide.  An inventory that cannot hold the slot axis
    raises ``TargetError``."""
    from repro_torch.dist.sharding import factor_slot_mesh

    if target.mesh is None:
        raise TargetError(
            "pooled_target needs a distributed target (mesh + strategy); a "
            "single-device pool is the compiled step called on [B, *shape] tensors"
        )
    if target.slot_axis is not None:
        raise TargetError(f"target already carries slot axis {target.slot_axis!r}")
    try:
        mesh = factor_slot_mesh(target.mesh, slots, axis=axis, devices=devices)
    except ValueError as e:
        raise TargetError(f"pooled_target: {e}") from e
    return dataclasses.replace(target, mesh=mesh, slot_axis=axis)


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


def lower_local(program: Program, target: Target) -> tuple:
    """``(local IR, PipelineReport)``: the target's pass pipeline run on a
    copy of ``program``'s function, as :func:`compile` runs it (nothing is
    cached and no device is touched)."""
    strategy = target.strategy or trivial_strategy(program.rank)
    spec = target.pipeline_spec()
    ctx = PipelineContext(
        strategy=strategy,
        boundary=program.boundary,
        exchange_every=target.exchange_every,
    )
    pm = PassManager(build_pipeline(spec, ctx))
    local = pm.run(_clone_func(program.func))
    return local, PipelineReport(spec=spec, timings=tuple(pm.timings))


def _build(program: Program, target: Target) -> CompiledStencil:
    with _obs.span("api.build", cat="compile", program=program.name,
                   backend=target.backend, k=target.exchange_every):
        return _build_inner(program, target)


def _build_inner(program: Program, target: Target) -> CompiledStencil:
    strategy = target.strategy or trivial_strategy(program.rank)
    local, report = lower_local(program, target)
    interp = StencilInterpreter(
        local,
        axis_sizes=dict(target.mesh.shape) if target.mesh is not None else {},
        distributed=target.distributed,
        backend=target.backend,
        tile=target.tile,
        mesh=target.mesh,
    )
    # return arity/order comes from the LOCAL IR (first-store order): an
    # epoched carried-state program (wave, p > q) stores — and returns —
    # more buffers per call than the single-step program does
    local_fields = [
        a for a in local.body.args if isinstance(a.type, stencil.FieldType)
    ]
    ret_indices = tuple(local_fields.index(f) for f in _stored_fields(local))
    specs = partition_specs(program, strategy)
    if target.slot_axis is not None:
        # slot-axis calling convention: every field carries a leading batch
        # dim split over the slot axis; exchanges bind the spatial axis
        # names only, so each slot block runs the solo exchange pattern
        specs = [PartitionSpec(target.slot_axis, *tuple(sp)) for sp in specs]
    return CompiledStencil(
        program=program,
        target=target,
        strategy=strategy,
        local_ir=local,
        pipeline_report=report,
        interp=interp,
        ret_indices=ret_indices,
        partition_specs=tuple(specs),
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


# --------------------------------------------------------------------------
# Resilience entry points (repro_torch.resilience)
# --------------------------------------------------------------------------


def resilient_loop(program, target=None, state=(), n_steps=0, **kwargs):
    """A checkpointing, fault-tolerant ``time_loop``: epoch-aligned
    snapshots every ``checkpoint_every`` epochs, killable and resumable —
    see ``repro_torch.resilience.ResilientLoop``."""
    from repro_torch.resilience import ResilientLoop

    return ResilientLoop(program, target, state, n_steps, **kwargs)


def resume(program, directory: str, target=None, **kwargs):
    """Resume a checkpointed run from ``directory`` onto ``target`` — a
    *different* mesh factorization / rank count is allowed: the restored
    host arrays are resharded through ``dist/sharding`` and the program
    recompiled.  See ``repro_torch.resilience.resume``."""
    from repro_torch.resilience import resume as _resume

    return _resume(program, directory, target, **kwargs)
