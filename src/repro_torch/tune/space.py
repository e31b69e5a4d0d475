"""Search-space enumeration: ``Program`` + device inventory → candidate
``Target``s (port of ``repro.tune.space``).

The space is the cross product of every knob the compile surface
exposes, filtered down to configurations that can actually compile:

- **mesh factorizations** of the rank count over the program's array
  dims (8 ranks, rank-2 program → 8×1 slabs on dim 0 or 1, 4×2, 2×4,
  2×2×2 is dropped — more mesh dims than array dims), keeping only
  grids that divide every field extent;
- **overlap** on/off (IR-level comm/compute overlap);
- **exchange_every** ∈ ``ks`` filtered by
  ``RooflineTerms.feasible_exchange_every`` on the program's per-step
  halo and shard extents (deep halo must fit the neighbour's core);
- **backend** torch/cuda (the reference's jnp/pallas); on cuda,
  ``fused_epoch`` (one K2 launch per epoch) and, for fused candidates
  only, K2's ``tile`` (:func:`tile_candidates`: K1 reads no tile, so a
  tile on an unfused candidate would only duplicate it).

``jit`` is not an axis (the reference does not vary it): every candidate
keeps the compiled step, ``jit=True``, except over several cards of one
controller, where ranks run op by op (``jit=False``, as ``Target.auto``
decomposes them).  The devices may repeat (ranks sharing one card, or
virtual ranks on the CPU).  Inside a world (``dist.processes.init``) the
ranks are the world's processes, one each: every candidate's mesh is a
process mesh and keeps ``jit=True``, and every process enumerates the
same candidates in the same order.

Every candidate is validated through ``api._validate_for_program`` —
what comes out of ``enumerate_candidates`` either compiles or was never
offered.  The baseline ``Target.auto(ranks)`` configuration is always
candidate #0 and is never pruned, so a tuned result can be compared
against the default it replaces.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Optional, Sequence

import numpy as np
import torch

AXIS_NAMES = ("x", "y", "z", "w")


@dataclasses.dataclass
class Candidate:
    """One point of the search space, with its scores as they accrue:
    ``modeled_s`` from the roofline stage, ``measured_s`` from the
    on-device stage (``None`` when pruned before measurement)."""

    target: object  # repro_torch.api.Target
    origin: str = "enumerated"  # "baseline" | "enumerated" | "cached" | "transfer"
    modeled_s: Optional[float] = None
    measured_s: Optional[float] = None
    pruned: bool = False
    note: str = ""

    @property
    def fingerprint(self) -> str:
        return self.target.fingerprint

    def describe(self) -> str:
        t = self.target
        if t.strategy is not None and any(g > 1 for g in t.strategy.grid_shape):
            grid = "x".join(
                f"{g}@d{d}"
                for g, d in zip(t.strategy.grid_shape, t.strategy.dims)
                if g > 1
            )
        else:
            grid = "1"
        parts = [f"grid={grid}", f"backend={t.backend}", f"k={t.exchange_every}"]
        if t.overlap:
            parts.append("overlap")
        if t.fused_epoch:
            parts.append("fused")
        if t.tile:
            parts.append("tile=" + "x".join(str(x) for x in t.tile))
        return " ".join(parts)

    def as_dict(self) -> dict:
        return {
            "describe": self.describe(),
            "fingerprint": self.fingerprint,
            "origin": self.origin,
            "modeled_s": self.modeled_s,
            "measured_s": self.measured_s,
            "pruned": self.pruned,
            "note": self.note,
        }


def default_devices() -> list:
    """Every CUDA device, one rank each; raises ``TargetError`` without a
    card (pass ``devices=`` for ranks on the CPU or repeated on a card).
    Inside a world: each process's device, in rank order."""
    from repro_torch import api
    from repro_torch.dist import processes

    if processes.initialized():
        return list(processes.process_mesh((processes.world().size,), ("x",)).devices.flat)

    if not torch.cuda.is_available():
        raise api.TargetError(
            "no CUDA device is available; pass devices=[torch.device('cpu')] * ranks "
            "for ranks on the CPU"
        )
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


# --------------------------------------------------------------------------
# mesh factorizations
# --------------------------------------------------------------------------


def factorizations(n: int) -> list:
    """Ordered tuples of factors ≥ 2 with product ``n`` (``8 → (8,),
    (2,4), (4,2), (2,2,2)``); ``(())`` for n=1."""
    if n <= 1:
        return [()]
    out: list[tuple] = []

    def rec(rem: int, cur: list) -> None:
        if rem == 1:
            out.append(tuple(cur))
            return
        for f in range(2, rem + 1):
            if rem % f == 0:
                rec(rem // f, cur + [f])

    rec(n, [])
    return out


def mesh_assignments(n_ranks: int, rank: int) -> list:
    """Every way to decompose ``n_ranks`` over a rank-``rank`` program:
    tuples of (grid size, array dim), deduplicated (a 2×2 grid on dims
    (0,1) equals the same grid on dims (1,0))."""
    seen = set()
    out = []
    for factors in factorizations(n_ranks):
        if len(factors) > rank:
            continue
        for dims in itertools.permutations(range(rank), len(factors)):
            key = frozenset(zip(factors, dims))
            if len(key) != len(factors) or key in seen:
                continue
            seen.add(key)
            out.append(tuple(sorted(zip(factors, dims), key=lambda fd: fd[1])))
    return out


def strategy_candidates(program, n_ranks: int) -> list:
    """``SlicingStrategy`` per feasible mesh assignment (every field
    extent divisible by its dim's grid size); ``[None]`` at 1 rank."""
    from repro_torch.core.passes.decompose import SlicingStrategy

    if n_ranks <= 1:
        return [None]
    out = []
    for assignment in mesh_assignments(n_ranks, program.rank):
        if not assignment:
            continue
        ok = True
        for g, d in assignment:
            for f in program.field_args:
                if f.type.bounds.shape[d] % g != 0:
                    ok = False
        if not ok:
            continue
        grid = tuple(g for g, _ in assignment)
        dims = tuple(d for _, d in assignment)
        axes = tuple(AXIS_NAMES[i] for i in range(len(grid)))
        out.append(SlicingStrategy(grid, axes, dims))
    return out


def mesh_for_strategy(strategy, devices):
    """A ``repro_torch.dist.Mesh`` matching ``strategy``'s grid over the
    first ranks of ``devices`` (which may repeat a device); inside a world,
    a process mesh over its processes."""
    from repro_torch.dist import Mesh, processes

    if strategy is None:
        return None
    if processes.initialized():
        return processes.process_mesh(strategy.grid_shape, strategy.axis_names)
    n = int(np.prod(strategy.grid_shape))
    return Mesh(
        np.array(list(devices)[:n], dtype=object).reshape(strategy.grid_shape),
        strategy.axis_names,
    )


# --------------------------------------------------------------------------
# per-strategy knob candidates
# --------------------------------------------------------------------------


def exchange_every_candidates(
    program, strategy, ks: Sequence[int] = (1, 2, 4, 8)
) -> list:
    """Epoch depths from ``ks`` that are feasible for this program +
    decomposition, via ``RooflineTerms.feasible_exchange_every`` on the
    per-step halo and shard extents; non-epochable programs (e.g.
    time_order=2 state that does not rotate closed) keep only k=1."""
    from repro_torch.core.passes.temporal import TemporalTilingError, epoch_halo
    from repro_torch.launch.roofline import RooflineTerms

    ks = sorted(set(int(k) for k in ks))
    if not program.field_args:
        return [k for k in ks if k == 1]
    try:
        lo1, hi1 = epoch_halo(program.func, 1)
    except TemporalTilingError:
        return [k for k in ks if k == 1] or [1]
    step_halo = tuple(max(l, h) for l, h in zip(lo1, hi1))
    local_shape = _local_shape(program, strategy)
    probe = RooflineTerms(
        flops=0.0,
        bytes_accessed=0.0,
        step_halo=step_halo,
        local_shape=local_shape,
    )
    out = [k for k in ks if k == 1 or probe.feasible_exchange_every(k)]
    return out or [1]


def tile_candidates(program, target) -> list:
    """K2's tiles for a fused candidate: ``None`` (K2's own
    ``choose_tile``), then the next two tiles by K2's ``tile_cost`` of
    those that divide the local core and fit the shared memory one CTA
    may use (``SMEM_PER_BLOCK``), the larger on a tie, as ``choose_tile``
    orders them.  The fused epochs are built on the host by running
    ``target``'s pipeline; a tile must suit every epoch of the program,
    so a tile K2 cannot take is never offered."""
    from repro_torch import api
    from repro_torch.core.dialects import stencil
    from repro_torch.kernels import epoch_kernel as k2

    local, _ = api.lower_local(program, dataclasses.replace(target, tile=None))
    epochs = [op for op in local.body.ops if isinstance(op, stencil.FusedEpochOp)]
    if not epochs:
        return [None]
    first = epochs[0]
    core = k2._core(first)
    chosen = k2.choose_tile(first)
    cands = itertools.product(*(
        k2._divisors_at_most(n, cap) for n, cap in zip(core.shape, k2.TILE_LIMIT[core.rank])
    ))

    def fits(t) -> bool:
        try:
            for e in epochs:
                k2.plan_epoch(e, t)
        except ValueError:
            return False
        return True

    def key(t):
        return (k2.tile_cost(first, k2._plan(core, t)), -int(np.prod(t)), t)

    ranked = sorted((tuple(t) for t in cands if tuple(t) != chosen), key=key)
    return [None] + [t for t in ranked if fits(t)][:2]


def _local_shape(program, strategy) -> tuple:
    if not program.field_args:
        return ()
    bounds = program.field_args[0].type.bounds
    if strategy is None:
        return tuple(bounds.shape)
    return tuple(strategy.local_bounds(bounds).shape)


# --------------------------------------------------------------------------
# pool widths (slot mesh axis: serving / ensemble batching)
# --------------------------------------------------------------------------


def slot_width_candidates(n_devices: int, spatial_ranks: int, capacity: int) -> list:
    """Feasible slot-axis widths for a pool of ``capacity`` slots over a
    ``spatial_ranks``-rank decomposition: every ``s`` that divides the
    pool (the slot axis splits it evenly) and fits the inventory
    (``s * spatial_ranks <= n_devices``), widest first.  Never empty:
    width 1 (every slot in each spatial rank's leading dim) is feasible
    whenever the spatial mesh itself is."""
    cap = max(1, int(capacity))
    spatial = max(1, int(spatial_ranks))
    hi = max(1, min(cap, int(n_devices) // spatial))
    out = [s for s in range(hi, 0, -1) if cap % s == 0]
    return out or [1]


def enumerate_pool_candidates(
    program,
    capacity: int,
    devices: Optional[Sequence] = None,
    backends: Sequence[str] = ("torch",),
    exchange_every: Sequence[int] = (1,),
    slot_axis: str = "slot",
) -> list:
    """An ensemble axis as a search space: every way to trade pool
    (ensemble) width against mesh factorization on this inventory
    (default: every card, ``default_devices``; devices may repeat).  For
    each slot width ``s`` dividing ``capacity``, the remaining
    ``n_devices // s`` devices enumerate spatial strategies
    (``strategy_candidates``), and each feasible pair becomes a slot-axis
    ``Target`` whose compiled step advances ``capacity`` same-fingerprint
    simulations in one call over ``(slot, *spatial)`` ranks.

    Candidates carry ``origin="pool"`` and the note ``slots=s``.  The
    widest slot axis enumerates first: the serve engine takes the head as
    its default factorization."""
    from repro_torch import api
    from repro_torch.dist import Mesh, factor_slot_mesh

    devices = [torch.device(d) for d in devices] if devices is not None else default_devices()
    cap = max(1, int(capacity))
    out: list = []
    seen: set = set()
    widths = sorted({s for s in range(1, min(cap, len(devices)) + 1) if cap % s == 0}, reverse=True)
    jit = not api.several_cards(devices)
    for s in widths:
        n_spatial = len(devices) // s
        for strategy in strategy_candidates(program, n_spatial):
            spatial_mesh = mesh_for_strategy(strategy, devices)
            if spatial_mesh is None:
                # a pure-ensemble pool: no spatial decomposition.  The
                # lowered IR still binds spatial axis names for its
                # (trivial) exchanges, so the mesh carries them at size 1
                # beside the slot axis
                strategy = api.trivial_strategy(program.rank)
                devs = np.empty(s, dtype=object)
                for i, d in enumerate(devices[:s]):
                    devs[i] = d
                mesh = Mesh(devs.reshape((s,) + (1,) * program.rank),
                            (slot_axis,) + tuple(strategy.axis_names))
            else:
                mesh = factor_slot_mesh(spatial_mesh, s, axis=slot_axis, devices=devices)
            kw = dict(mesh=mesh, strategy=strategy, slot_axis=slot_axis, jit=jit)
            for k in exchange_every_candidates(program, strategy, exchange_every):
                for backend in backends:
                    try:
                        t = api.Target(backend=backend, exchange_every=k, **kw)
                        api._validate_for_program(program, t)
                    except api.TargetError:
                        continue
                    if t.fingerprint in seen:
                        continue
                    seen.add(t.fingerprint)
                    out.append(Candidate(target=t, origin="pool", note=f"slots={s}"))
    return out


# --------------------------------------------------------------------------
# the full space
# --------------------------------------------------------------------------


def enumerate_candidates(
    program,
    devices: Optional[Sequence] = None,
    ranks: Optional[int] = None,
    backends: Sequence[str] = ("torch", "cuda"),
    exchange_every: Sequence[int] = (1, 2, 4, 8),
    overlap: Sequence[bool] = (False, True),
    fused_epoch: Sequence[bool] = (False, True),
) -> list:
    """The candidate list for ``program`` on ``devices`` (default: every
    card, ``default_devices``), baseline first.  Simple configurations
    enumerate first (no overlap, shallow epochs, torch, no tile,
    per-step dispatch), so stable min-by-score tie-breaks prefer the
    least exotic winner.  cuda candidates additionally vary
    ``fused_epoch`` (one K2 launch per epoch), and fused ones K2's tile."""
    from repro_torch import api
    from repro_torch.dist import processes

    devices = [torch.device(d) for d in devices] if devices is not None else default_devices()
    n_ranks = len(devices) if ranks is None else int(ranks)
    if n_ranks > len(devices):
        raise api.TargetError(
            f"requested {n_ranks} ranks, have {len(devices)} devices"
        )
    world = processes.initialized()
    if world and n_ranks != processes.world().size:
        raise api.TargetError(
            f"requested {n_ranks} ranks in a world of {processes.world().size} processes"
        )
    devices = devices[:n_ranks]
    one = str(processes.world().device) if world else str(devices[0])

    try:
        auto = api.Target.auto() if world else api.auto_target(devices, n_ranks)
        baseline = Candidate(target=auto, origin="baseline")
        api._validate_for_program(program, baseline.target)
    except api.TargetError as e:
        # e.g. extents not divisible by the device count 1-D: fall back
        # to single-device as the reference configuration
        baseline = Candidate(
            target=api.Target(device=one), origin="baseline", note=f"auto invalid: {e}"
        )

    seen = {baseline.fingerprint}
    out = [baseline]
    jit = world or not api.several_cards(devices)
    for strategy in strategy_candidates(program, n_ranks):
        mesh = mesh_for_strategy(strategy, devices)
        where = {"mesh": mesh, "strategy": strategy} if mesh is not None else {"device": one}
        ks = exchange_every_candidates(program, strategy, exchange_every)
        for ov in overlap:
            for k in ks:
                for backend in backends:
                    # fused_epoch only varies on the cuda backend (invalid
                    # on torch), and never with overlap
                    fused = [fe for fe in fused_epoch if not (fe and ov)] if backend == "cuda" else [False]
                    for fe in fused:
                        try:
                            t = api.Target(
                                backend=backend,
                                overlap=bool(ov),
                                exchange_every=k,
                                fused_epoch=bool(fe),
                                jit=jit,
                                **where,
                            )
                            api._validate_for_program(program, t)
                            # K2 is the only reader of a tile
                            fused_tiles = tile_candidates(program, t) if fe else [None]
                        except api.TargetError:
                            continue
                        except ValueError:  # K2 cannot tile this epoch at all
                            continue
                        for tile in fused_tiles:
                            if tile is not None:
                                t_tile = dataclasses.replace(t, tile=tile)
                                api._validate_for_program(program, t_tile)
                            else:
                                t_tile = t
                            if t_tile.fingerprint in seen:
                                continue
                            seen.add(t_tile.fingerprint)
                            out.append(Candidate(target=t_tile))
    return out
