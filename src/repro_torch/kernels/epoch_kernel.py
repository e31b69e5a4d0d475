"""Kernel K2: one ``stencil.fused_epoch`` as a hand-written CUDA kernel for Hopper.

Replaces the Pallas TPU kernel ``repro/kernels/epoch_kernel.py:
build_epoch_kernel`` (its whole-shard and tiled ``pl.pallas_call``s; entry
``run_epoch_pallas``).  It computes what that kernel computes: the k
unrolled applies of a deep-halo epoch with ``comm.boundary_mask``
re-zeroing between them, returning the region's escapes, while every
intermediate frame stays on chip.

Design: three kinds of plan (:class:`TilePlan`), one launch an epoch.

- The *core* is the intersection of the escapes' bounds (the rank's core
  on fig 7).  Every region value has a *window* per tile: the tile grown
  by the value's overhang beyond the core (the reference's
  ``_rel_bounds``).  Only escapes reach device memory.  An escape larger
  than the core, such as wave's carried state over [-r, n+r), is written
  by the edge tiles: each writes the overhang on its own side from the
  window it already holds, so every point is written by exactly one CTA.
  An apply result that escapes and is read by nothing else in the region
  is written to device memory straight from the apply.
  ``stencil.index`` reads the tile's global origin.
- Tiled (overlapped temporal blocking; every rank): one CTA per tile of
  the core.  The CTA loads each operand's window into shared memory;
  each sub-step computes its shrinking frame from shared memory into
  shared memory, then its mask zeroes the points outside the box.
  Shared memory is given out by liveness: a buffer is reused once its
  last reader has run, and a mask works in place when its input dies
  with it.
- Streaming (2.5-D blocking; rank 3): the tile covers dims 1 and 2 and
  takes the core along dim 0 whole (or in a few segments, where the
  minor tiles alone give too few CTAs).  Each CTA walks its planes along
  dim 0: every value keeps a ring of planes in shared memory, each
  sub-step computes its plane at its lag behind the operands' front
  (:func:`_lags`), and no frame leaves the chip or is computed twice
  along dim 0; the recompute is only the minor dims' halo.  A ring is as
  deep as its readers' dim-0 taps need at their lags (:func:`_rings`;
  wave's older field, read at the centre a sub-step later, deeper than
  its taps).  Each thread keeps its column of a star stencil's dim-0
  taps in registers (:func:`_queues`), so a star operand's ring holds
  ``hi + 1`` planes, not ``hi - lo + 1``.  The operands' next planes load
  by ``cp.async`` while the CTA computes (a prefetch plane, where it
  fits); one ``__syncthreads`` follows each sub-step's plane.
- Scratch (rank 3, where neither fits: heat and wave so8 k=8 at 1024³):
  buffers move out of shared memory, the largest first, until the rest
  fits: an operand's window is read in place from the operand, a frame
  goes to a scratch area of device memory private to its CTA (64-bit
  offsets).  The scratch is sized for the CTAs the plan lets reside
  (``ctas``: one or two an SM, the whole capped at ``SCRATCH_CAP``), not
  for the tiles, so such a kernel's CTAs loop over their (slot, tile)
  pairs, and the wrapper allocates the scratch per launch
  (``torch.empty``; under a CUDA graph from the graph's pool).
  ``__syncthreads`` between phases orders the block's own device-memory
  writes and reads as it does shared memory's; one more at the end of
  each tile keeps the next tile's writes behind the last reads.  Such a
  kernel re-reads every frame through L1 and L2, so it is the slowest
  per point.

Rejected: the reference's whole-shard mode (which the reference took
whenever the escapes differ in bounds, as wave's do, or a sub-step uses
``stencil.index``: a Pallas block has no logical coordinates); a whole
shard has no one-block analogue at 16384².  A cooperative kernel with a
grid-wide sync between sub-steps: each sub-step's whole frame would go
to device memory and back (the k round trips of the unfused path), and a
cooperative launch caps the grid at the CTAs that fit on the card at
once.  For streaming plans, a skew of one more plane a sub-step (one
barrier a plane): its deeper rings forced smaller tiles and measured
slower (PERF.md).

Masks: the keep mask of a ``boundary_mask`` is a box, which depends on
the rank's mesh coordinate (``core.lowering.keep_box``).  The kernel
tests each point's coordinates against that box, whose ``lo``/``hi``
along each masked dim are ``int`` arguments of the launch
(:func:`box_args`), so one build serves every rank of a mesh; the plain
version reads keep arrays built outside the kernel (:func:`region_masks`),
as the reference's kernel reads 0/1 arrays.

Walking a frame: each thread computes ``R`` consecutive points along dim
0 (8 in 2D, 4 in 3D, 1 in 1D), one column of a frame's minor dims; a
warp's threads sit on consecutive columns, padded to whole warps, so its
shared-memory accesses fall on consecutive banks.  For every operand the
taps that differ only along dim 0 are read once per column into
registers (the union of the column's rows), so heat so4 reads about 5.5
floats of shared memory a point instead of 9.  Column coordinates are
computed once per column; a ragged last chunk is predicated.  A
streaming plan walks each plane the same way with dim 1 as the rows, as
many rows a thread as let one round of the CTA's threads cover the plane
(:func:`_plane_r`), its columns not padded.

Window loads: ``cp.async`` copies (16 bytes where the array's rows, the
window's rows, the tile and the operand pointers allow it, else 8 or 4),
one wait and one barrier for all operands (a streaming plan: for each
plane).

Choosing a plan: :func:`plan_epoch` replaces the reference's 4 MiB VMEM
budget.  Of the tiles that divide the core, it takes those whose shared
memory lets two CTAs share one SM (else one, 227 KB at most), for a
rank-3 epoch also every streaming plan whose rings fit 227 KB, and of
those the one that spends least work per owned point (:func:`tile_cost`:
frame walks including idle lanes, plus window loads) among those giving
at least two CTAs per SM of the card: 64×128 for heat so4 k=4 at 16384²
(an 80×144 window, 1.41× the input), 32×128 for wave, a 32×16 stream for
heat so4 k=8 at 1024³.  The kernel is built with ``__launch_bounds__``
for the CTAs its shared memory lets reside, which caps the registers
ptxas may use.  If nothing fits, the plan keeps buffers in device memory
(above); if even that needs more scratch than ``SCRATCH_CAP``, the
wrapper raises; it never falls back to something else.

What bounds it on an H100: device-memory bytes, for the least work (read
each operand once, write each escape once: heat so4 k=4 at 16384² 2.15
GB, 0.64 ms at 3.35 TB/s), or float32 operations for deep 3-D epochs.
Here a tile re-reads its neighbours' halo and recomputes their frame
overlap, and the loads and the sub-steps are phases separated by
``__syncthreads`` (the second CTA on an SM overlaps one's loads with the
other's compute; no TMA yet).  A persistent variant that loads the next
tile's windows while computing one was slower on the card (PERF.md) and
is not kept.  What bounds the kernel now is instruction issue and
shared-memory traffic: the walk's loads and the point function's
operations (one instruction each under ``-fmad=false``), with the idle
lanes of padded columns and, in 3-D, the recomputed halo.

Slot pools: as K1 does, the launch takes a slot count ``B``; the grid is
``B`` times the tiles, the slot is ``blockIdx.x``'s slowest index, and
every operand and escape pointer moves by that slot's size (all are
contiguous ``[B, *bounds]`` pools), so one launch advances a serving
pool's every slot and one build serves every pool width.

Bitwise: the point function is emitted by K1's ``emit_body`` (one float32
statement per IR op in body order, constants as bit patterns) and built
with ``-fmad=false``, so K2 equals its plain version, the unfused K1
route and the torch backend bit for bit.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import itertools
import weakref
from typing import Callable, Optional, Sequence

import torch

from repro_torch.core.dialects import comm, stencil
from repro_torch.kernels import _DISPATCH
from repro_torch.kernels import graphs as _graphs
from repro_torch.kernels import stencil_apply as _k1
from repro_torch.obs import trace as _obs

THREADS = 256
SMEM_PER_BLOCK = 232448  # 227 KB: the most one CTA may opt in to on an H100
SMEM_PER_SM = 233472     # 228 KB per SM, of which each resident CTA reserves 1 KB
SMEM_TWO_BLOCKS = SMEM_PER_SM // 2 - 1024  # the budget for two CTAs on one SM
TILE_LIMIT = {1: (8192,), 2: (256, 256), 3: (64, 64, 64)}  # choose_tile's largest sides
SMS = 132  # an H100 SXM's SMs
MIN_CTAS = 2 * SMS  # two CTAs on each of an H100's SMs
SCRATCH_CAP = 1 << 30  # the most device memory a scratch plan's launch may take
SCRATCH_ALIGN = 32  # floats: each buffer in scratch starts on a 128-byte line
STREAM_LIMIT = (64, 128)  # a streaming plan's largest minor sides (dims 1 and 2)
STREAM_SEGMENTS = (1, 2, 4, 8)  # the dim-0 segments a streaming plan may cut the core into
STREAM_ROWS = 16  # the most rows along dim 1 a thread computes in a plane walk
STREAM_REGS = 280  # registers a thread's queues and one column's loads may take (_queues)
# a thread-point of a streaming plan at one CTA an SM against one of a
# scratch plan: the card's ms per tile_cost unit of the two (PERF.md,
# phase 20 at 1024^3) were 1.59-1.71 times apart
STREAM_WEIGHT = 1.6
# points per thread along dim 0 in a frame walk (a warp spans columns of
# the minor dims; rank 1 has none, so its threads take one point each)
R_BY_RANK = {1: 1, 2: 8, 3: 4}
_LAUNCHER = "k2_epoch_launch"
_OCCUPANCY = "k2_epoch_occupancy"


# --------------------------------------------------------------------------
# The plain version
# --------------------------------------------------------------------------


def _mask_ops(fused_op: stencil.FusedEpochOp) -> list:
    return [op for op in fused_op.body.ops if isinstance(op, comm.BoundaryMaskOp)]


def _emit_region(fused_op, inputs, masks, bounds_of) -> list:
    """Evaluate the fused region over tensors: K2's plain version.
    ``bounds_of`` maps a region value to the logical bounds its tensor
    covers (the value's own bounds for a whole shard, a tile's window for
    one tile); ``masks`` holds one keep tensor (boolean, or 0/1) per
    boundary_mask, in region order, over the masked tensor.  A value is
    dropped after its last reader, so a deep epoch holds a few frames at
    once, not all of them."""
    from repro_torch.core.lowering import eval_apply_body

    env = dict(zip(fused_op.body.args, inputs))
    device = inputs[0].device if inputs else None
    last = {o: i for i, op in enumerate(fused_op.body.ops) for o in op.operands}
    mask_idx = 0
    for i, op in enumerate(fused_op.body.ops):
        if isinstance(op, stencil.ApplyOp):
            origins = [bounds_of(o).lb for o in op.operands]
            env.update(zip(op.results, eval_apply_body(
                op, [env[o] for o in op.operands], origins, bounds_of(op.results[0]),
                device=device)))
        elif isinstance(op, comm.BoundaryMaskOp):
            mask = masks[mask_idx]
            mask_idx += 1
            keep = mask if mask.dtype == torch.bool else mask != 0
            zero = torch.zeros((), dtype=torch.float32, device=mask.device)
            env[op.results[0]] = torch.where(keep, env[op.temp], zero)
            del keep
        elif isinstance(op, stencil.FusedYieldOp):
            return [env[o] for o in op.operands]
        else:  # pragma: no cover - FusedEpochOp.verify_ rejects these
            raise NotImplementedError(f"fused region op {op.name}")
        for o in op.operands:
            if last[o] == i:
                env.pop(o, None)
    raise AssertionError("fused_epoch region missing stencil.fused_yield")


def region_masks(fused_op: stencil.FusedEpochOp, device, coords=None) -> list:
    """One boolean keep-mask per boundary_mask of the region, in region
    order, over the masked value's whole bounds, at mesh coordinate
    ``coords`` (all zeros by default): the plain version's mask inputs.
    Boolean and broadcast where the box allows: at 1024³ a deep epoch's
    masks in float32 would take tens of GB."""
    from repro_torch.core.lowering import boundary_keep

    out = []
    for op in _mask_ops(fused_op):
        shape = tuple(op.temp.type.bounds.shape)
        keep = boundary_keep(op, shape, device, coords)
        if keep is None:
            keep = torch.ones((1,) * len(shape), dtype=torch.bool, device=device)
        out.append(torch.broadcast_to(keep, shape))
    return out


def _box_keys(fused_op: stencil.FusedEpochOp) -> dict:
    """The box bounds K2 takes as arguments: ``{(mask, dim): j}``, where
    arguments ``2j`` and ``2j + 1`` are the ``lo`` and ``hi`` of mask
    ``mask``'s box along ``dim``; masks whose box along a dim is the same
    at every coordinate share one pair."""
    from repro_torch.core.lowering import keep_box

    shared: dict = {}
    out: dict = {}
    for op in _mask_ops(fused_op):
        grid, core = op.grid, op.core
        for d in keep_box(op):
            gax = grid.axis_of_dim(d)
            extent = grid.shape[gax] if gax is not None else 1
            axis = grid.axis_names[gax] if extent > 1 else None
            key = (d, axis, extent, core.lb[d], core.ub[d])
            out[(op, d)] = shared.setdefault(key, len(shared))
    return out


def box_args(fused_op: stencil.FusedEpochOp, coords=None) -> list:
    """K2's box arguments at mesh coordinate ``coords`` (all zeros by
    default): ``lo, hi`` of each pair of :func:`_box_keys`, in order."""
    from repro_torch.core.lowering import keep_box

    keys = _box_keys(fused_op)
    out = [0] * (2 * len(set(keys.values())))
    for (op, d), j in keys.items():
        out[2 * j], out[2 * j + 1] = keep_box(op, coords)[d]
    return out


# --------------------------------------------------------------------------
# The tile plan
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """How K2 cuts one fused epoch into CTAs.  ``core`` is the intersection
    of the escapes' bounds, ``tile`` divides it, ``grid`` counts tiles per
    dim (CTA ``blockIdx.x`` walks them row-major, the last dim fastest).

    A scratch plan (``ctas`` > 0) keeps buffers in device memory: at most
    ``ctas`` CTAs (``ctas / SMS`` an SM) loop over the tiles, each with a
    scratch of its own, and buffers leave shared memory, the largest
    first, until the rest takes at most ``budget`` bytes (0: all leave).

    A streaming plan (``stream``, rank 3) walks its tile plane by plane
    along dim 0: the tile's dim-0 side is a segment of the core (all of
    it, or a few segments where the minor tiles alone give too few CTAs),
    and each value keeps a ring of planes in shared memory
    (:func:`_rings`); with ``prefetch`` the operands' rings hold one more
    plane, loaded while the CTA computes the current one."""

    core: stencil.Bounds
    tile: tuple
    grid: tuple
    ctas: int = 0
    budget: int = 0
    stream: bool = False
    prefetch: bool = False

    @property
    def n_tiles(self) -> int:
        n = 1
        for g in self.grid:
            n *= g
        return n

    def tiles(self):
        """Every tile index, in ``blockIdx.x`` order."""
        return itertools.product(*(range(g) for g in self.grid))

    def origin(self, idx: tuple) -> tuple:
        """The tile's lower corner, relative to the core's."""
        return tuple(i * t for i, t in zip(idx, self.tile))

    def window_shape(self, bounds: stencil.Bounds) -> tuple:
        return tuple(
            t + s - c for t, s, c in zip(self.tile, bounds.shape, self.core.shape)
        )

    def window(self, bounds: stencil.Bounds, idx: tuple) -> stencil.Bounds:
        """The logical bounds of a value's window in tile ``idx``: the tile
        grown by the value's overhang beyond the core."""
        lb = tuple(l + t for l, t in zip(bounds.lb, self.origin(idx)))
        return stencil.Bounds(
            lb, tuple(l + w for l, w in zip(lb, self.window_shape(bounds)))
        )

    def owned(self, bounds: stencil.Bounds, idx: tuple) -> stencil.Bounds:
        """The part of an escape of ``bounds`` that tile ``idx`` writes: its
        core tile, plus the overhang on each side where it is an edge
        tile.  The owned parts of all tiles partition ``bounds``."""
        lb, ub = [], []
        for d, (i, t0) in enumerate(zip(idx, self.origin(idx))):
            start = self.core.lb[d] + t0
            lb.append(bounds.lb[d] if i == 0 else start)
            ub.append(bounds.ub[d] if i == self.grid[d] - 1 else start + self.tile[d])
        return stencil.Bounds(tuple(lb), tuple(ub))


def _temp_values(fused_op: stencil.FusedEpochOp) -> list:
    vals = list(fused_op.body.args)
    for op in fused_op.body.ops:
        vals.extend(op.results)
    return [v for v in vals if isinstance(v.type, stencil.TempType)]


def _escapes(fused_op: stencil.FusedEpochOp) -> list:
    return list(fused_op.body.ops[-1].operands)


def _core(fused_op: stencil.FusedEpochOp) -> stencil.Bounds:
    """The intersection of the escapes' bounds; every region value must
    contain it, and every apply must read inside its operands."""
    escapes = [e.type.bounds for e in _escapes(fused_op)]
    if not escapes:
        raise ValueError("a fused epoch without escapes has nothing to tile")
    rank = escapes[0].rank
    lb = tuple(max(b.lb[d] for b in escapes) for d in range(rank))
    ub = tuple(min(b.ub[d] for b in escapes) for d in range(rank))
    if any(u <= l for l, u in zip(lb, ub)):
        raise ValueError(f"the escapes' bounds {escapes} do not overlap")
    core = stencil.Bounds(lb, ub)
    for v in _temp_values(fused_op):
        if not v.type.bounds.contains(core):
            raise ValueError(
                f"region value of bounds {v.type.bounds} does not cover the "
                f"core {core}: K2 cannot tile this epoch"
            )
    for op in fused_op.body.ops:
        if isinstance(op, stencil.ApplyOp):
            _k1.check_windows(
                op,
                [o.type.bounds.shape for o in op.operands],
                [o.type.bounds.lb for o in op.operands],
                op.result_bounds,
            )
    return core


def _divisors_at_most(n: int, limit: int) -> list:
    return [d for d in range(1, min(n, limit) + 1) if n % d == 0]


def _lanes(shape: tuple) -> int:
    """Thread-points a walk over a frame of ``shape`` spends: whole chunks
    of ``R`` rows along dim 0 times the columns padded to whole warps."""
    rows = -(-shape[0] // R_BY_RANK[len(shape)]) * R_BY_RANK[len(shape)]
    return rows * _padded_columns(shape)


def _points(shape: tuple) -> int:
    n = 1
    for w in shape:
        n *= w
    return n


def _plane_r(shape: tuple) -> int:
    """Rows along dim 1 one thread computes in a streaming plan's walk of
    a plane of ``shape``: as few as let one round of the CTA's threads
    cover the plane (a plane holds a few hundred columns' worth of work,
    so a fixed ``R`` would leave most of a last round idle), at most
    ``STREAM_ROWS``."""
    groups = max(1, THREADS // shape[1])
    return max(1, min(STREAM_ROWS, -(-shape[0] // groups)))


def _plane_lanes(shape: tuple) -> int:
    """Thread-points a streaming plan's walk of one plane of ``shape``
    spends: its chunks of :func:`_plane_r` rows times its columns (not
    padded to whole warps), in whole rounds of the CTA's threads."""
    r = _plane_r(shape)
    items = -(-shape[0] // r) * shape[1]
    return -(-items // THREADS) * THREADS * r


def tile_cost(fused_op: stencil.FusedEpochOp, plan: TilePlan) -> float:
    """The work of one tile per point it owns, in thread-points: every
    sub-step frame as the register-blocked walk covers it (ragged chunks
    and idle lanes included) plus every operand window it loads; for a
    scratch plan also every frame in device memory, written once and
    read once by each op that reads it; for a streaming plan every
    sub-step's plane walked once per plane of its window (the segment
    and its warm-up planes, :func:`_plane_lanes`) plus every operand plane
    loaded once."""
    if plan.stream:
        work = 0
        for op in fused_op.body.ops:
            if isinstance(op, stencil.ApplyOp):
                shape = plan.window_shape(op.results[0].type.bounds)
                work += _plane_lanes(shape[1:]) * shape[0]
        for a in fused_op.body.args:
            work += _points(plan.window_shape(a.type.bounds))
        return work / _points(plan.tile)
    work = sum(_lanes(plan.window_shape(op.results[0].type.bounds))
               for op in fused_op.body.ops if isinstance(op, stencil.ApplyOp))
    for a in fused_op.body.args:
        work += _points(plan.window_shape(a.type.bounds))
    if plan.ctas:
        st = _storage(fused_op, plan)
        for v in _temp_values(fused_op):
            if st.slot_of.get(v) in st.device and v not in st.in_place:
                readers = len({id(u.operation) for u in v.uses})
                work += _points(plan.window_shape(v.type.bounds)) * (1 + readers)
    return work / _points(plan.tile)


def _candidates(core: stencil.Bounds) -> list:
    """Every tile whose sides divide the core and stay within ``TILE_LIMIT``."""
    return [
        tuple(t) for t in itertools.product(*(
            _divisors_at_most(n, cap) for n, cap in zip(core.shape, TILE_LIMIT[core.rank])
        ))
    ]


def _least_cost(fused_op: stencil.FusedEpochOp, plans: list) -> TilePlan:
    """Of ``plans``, those giving at least ``MIN_CTAS`` tiles where any do,
    and of those the one of least :func:`tile_cost` (the larger tile on a
    tie)."""
    pool = [p for p in plans if p.n_tiles >= MIN_CTAS] or plans
    return min(pool, key=lambda p: (tile_cost(fused_op, p), -_points(p.tile), p.tile))


def choose_tile(fused_op: stencil.FusedEpochOp) -> tuple:
    """The tile of K2's default plan (:func:`plan_epoch`)."""
    return plan_epoch(fused_op).tile


def _choose_plan(fused_op: stencil.FusedEpochOp, core: stencil.Bounds,
                 streams: bool = True) -> TilePlan:
    """K2's default plan, from every tile of :func:`_candidates`: those
    whose shared memory lets two CTAs share an SM (else those one CTA can
    hold, 227 KB), of those the ones giving at least ``MIN_CTAS`` CTAs
    where any do, and of those the one of least :func:`tile_cost` (the
    larger tile on a tie).  A tile may so grow as well as shrink with the
    epoch.  Registers follow the choice: the kernel is built for the CTAs
    per SM that its shared memory allows (``__launch_bounds__``), so ptxas
    keeps each thread within 65,536 / (256 × CTAs) registers.  Where even
    one point per tile needs more than 227 KB, the same choice among the
    scratch plans of every tile (:func:`_scratch_plan`).

    A rank-3 epoch (with ``streams``) also has the streaming plans that
    fit 227 KB (:func:`_stream_plans`) in that choice, beside the tiles
    of shared memory.  Scratch plans are left for epochs where no tile
    fits: there the least costly scratch plan wins over a streaming plan
    that runs one CTA an SM unless the stream's cost, weighed by
    ``STREAM_WEIGHT``, is lower."""
    cands = _candidates(core)
    smem = {t: _storage(fused_op, _plan(core, t)).smem_bytes for t in cands}
    pool = [t for t in cands if smem[t] <= SMEM_TWO_BLOCKS] or [
        t for t in cands if smem[t] <= SMEM_PER_BLOCK
    ]
    plans = [_plan(core, t) for t in pool]
    if streams:
        plans += _stream_plans(fused_op, core)
    best = _least_cost(fused_op, plans) if plans else None
    if pool or (best and _storage(fused_op, best).smem_bytes <= SMEM_TWO_BLOCKS):
        return best
    scratch = _least_cost(fused_op, _scratch_plans(fused_op, core, cands, forced=False))
    if best and STREAM_WEIGHT * tile_cost(fused_op, best) < tile_cost(fused_op, scratch):
        return best
    return scratch


def _stream_plan(fused_op: stencil.FusedEpochOp, core: stencil.Bounds,
                 tile: tuple) -> Optional[TilePlan]:
    """The streaming plan of ``tile`` (its dim-0 side a segment of the
    core): with a prefetch plane where its rings then fit 227 KB, else
    without; None where neither fits."""
    plan = dataclasses.replace(_plan(core, tile), stream=True)
    need = _storage(fused_op, plan).smem_bytes
    if need > SMEM_PER_BLOCK:
        return None
    ahead = sum(4 * -(-_points(plan.window_shape(a.type.bounds)[1:]) // 4) * 4
                for a in fused_op.body.args)  # one more plane of each operand
    return dataclasses.replace(plan, prefetch=need + ahead <= SMEM_PER_BLOCK)


def _stream_plans(fused_op: stencil.FusedEpochOp, core: stencil.Bounds) -> list:
    """Every streaming plan of a rank-3 epoch that fits 227 KB: minor
    tiles whose sides divide the core within ``STREAM_LIMIT``, the core
    along dim 0 whole or cut into ``STREAM_SEGMENTS`` segments."""
    if core.rank != 3:
        return []
    tiles = [(core.shape[0] // n, t1, t2)
             for n in STREAM_SEGMENTS if core.shape[0] % n == 0
             for t1 in _divisors_at_most(core.shape[1], STREAM_LIMIT[0])
             for t2 in _divisors_at_most(core.shape[2], STREAM_LIMIT[1])]
    return [p for p in (_stream_plan(fused_op, core, t) for t in tiles) if p]


def _scratch_plan(fused_op: stencil.FusedEpochOp, core: stencil.Bounds, tile: tuple,
                  forced: bool) -> Optional[TilePlan]:
    """The scratch plan of ``tile``: two CTAs an SM, each leaving the other
    half of the SM's shared memory, where their scratch fits
    ``SCRATCH_CAP``, else one CTA an SM with 227 KB; every buffer in device
    memory when ``forced``; None where even one CTA an SM needs more
    scratch than the cap."""
    base = _plan(core, tile)
    for per_sm, budget in ((2, SMEM_TWO_BLOCKS), (1, SMEM_PER_BLOCK)):
        plan = dataclasses.replace(base, ctas=per_sm * SMS, budget=0 if forced else budget)
        if scratch_bytes(fused_op, plan) <= SCRATCH_CAP:
            return plan
    return None


def _scratch_plans(fused_op: stencil.FusedEpochOp, core: stencil.Bounds, tiles: list,
                   forced: bool) -> list:
    plans = [p for p in (_scratch_plan(fused_op, core, t, forced) for t in tiles) if p]
    if not plans:
        least = min(scratch_bytes(fused_op, dataclasses.replace(
            _plan(core, t), ctas=SMS, budget=0 if forced else SMEM_PER_BLOCK)) for t in tiles)
        raise ValueError(
            f"K2 needs {least} bytes of device-memory scratch for {SMS} CTAs even at its "
            f"least, more than the {SCRATCH_CAP} a launch may take"
        )
    return plans


def scratch_bytes(fused_op: stencil.FusedEpochOp, plan: TilePlan) -> int:
    """The device memory a launch of ``plan`` takes for scratch at most:
    ``plan.ctas`` CTAs' worth (0 for a plan in shared memory only)."""
    return 4 * _storage(fused_op, plan).scratch_floats * plan.ctas


def _plan(core: stencil.Bounds, tile: tuple) -> TilePlan:
    return TilePlan(core, tile, tuple(n // t for n, t in zip(core.shape, tile)))


# fused op -> its lags (_lags), and {(tile, scratch, stream): TilePlan}: a
# plan search asks for the same ones many times
_LAGS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_PLANS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def plan_epoch(fused_op: stencil.FusedEpochOp, tile: Optional[Sequence[int]] = None,
               scratch: bool = False, stream=None) -> TilePlan:
    """K2's tile plan for ``fused_op``: ``tile`` if given (it must divide
    the core and fit in 227 KB of shared memory), else the default plan
    (:func:`_choose_plan`).  ``scratch`` forces a scratch plan with every
    buffer in device memory, at ``tile`` or at the scratch plans' own
    choice: a way to run that mode on an epoch that fits shared memory.

    ``stream`` (rank 3 only) forces a streaming plan: ``True`` the least
    costly one, a minor tile ``(t1, t2)`` that tile over the whole core
    along dim 0, ``(segment, t1, t2)`` that tile with the core cut into
    segments along dim 0; ``False`` leaves streaming plans out of the
    default choice.  Plans are kept per op."""
    if tile is not None:
        tile = tuple(int(t) for t in tile)
    if stream is not None and not isinstance(stream, bool):
        stream = tuple(int(t) for t in stream)
    key = (tile, bool(scratch), stream)
    with _k1._LIBS_LOCK:
        plan = _PLANS.get(fused_op, {}).get(key)
    if plan is None:
        plan = _plan_epoch(fused_op, tile, scratch, stream)
        with _k1._LIBS_LOCK:
            _PLANS.setdefault(fused_op, {})[key] = plan
    return plan


def _plan_epoch(fused_op: stencil.FusedEpochOp, tile: Optional[tuple], scratch: bool,
                stream) -> TilePlan:
    core = _core(fused_op)
    if stream is not None and stream is not False:
        if tile is not None or scratch:
            raise ValueError("a streaming plan takes neither a tile nor scratch")
        if core.rank != 3:
            raise ValueError(f"streaming plans are for rank-3 epochs, not rank {core.rank}")
        if stream is True:
            plans = _stream_plans(fused_op, core)
            if not plans:
                raise ValueError("no streaming plan of this epoch fits shared memory")
            return _least_cost(fused_op, plans)
        side = tuple(int(t) for t in stream)
        side = (core.shape[0],) + side if len(side) == 2 else side
        if len(side) != 3 or any(t < 1 or n % t for n, t in zip(core.shape, side)):
            raise ValueError(f"streaming tile {side} does not divide the epoch's core {core.shape}")
        plan = _stream_plan(fused_op, core, side)
        if plan is None:
            need = _storage(fused_op, dataclasses.replace(_plan(core, side), stream=True)).smem_bytes
            raise ValueError(
                f"streaming tile {side} needs {need} bytes of shared memory, more than the "
                f"{SMEM_PER_BLOCK} a CTA may use"
            )
        return plan
    if tile is None:
        if scratch:
            return _least_cost(fused_op, _scratch_plans(fused_op, core, _candidates(core), True))
        return _choose_plan(fused_op, core, stream is None)
    tile = tuple(int(t) for t in tile)
    if len(tile) != core.rank or any(
        t < 1 or n % t for n, t in zip(core.shape, tile)
    ):
        raise ValueError(
            f"tile {tile} does not divide the epoch's core {core.shape}"
        )
    if scratch:
        (plan,) = _scratch_plans(fused_op, core, [tile], True)
        return plan
    plan = _plan(core, tile)
    need = _storage(fused_op, plan).smem_bytes
    if need > SMEM_PER_BLOCK:
        raise ValueError(
            f"tile {tile} needs {need} bytes of shared memory, more than the "
            f"{SMEM_PER_BLOCK} a CTA may use"
        )
    if plan.n_tiles > 0x7FFFFFFF:
        raise ValueError(f"tile {tile} gives {plan.n_tiles} CTAs, more than one grid holds")
    return plan


# --------------------------------------------------------------------------
# Shared memory, by liveness; device memory where it does not fit
# --------------------------------------------------------------------------


@dataclasses.dataclass
class _Storage:
    slot_of: dict  # region value -> buffer index
    direct: set    # escapes an apply writes straight to device memory
    slot_floats: list
    # a scratch plan's buffers in device memory -> the floats of the CTA's
    # scratch they take (0 where only operands, read in place, lived)
    device: dict = dataclasses.field(default_factory=dict)
    in_place: set = dataclasses.field(default_factory=set)  # operands read in place
    # a streaming plan's rings: buffer -> planes it holds, and the floats
    # of one plane (a multiple of 4, so each plane starts 16-byte aligned)
    depth: dict = dataclasses.field(default_factory=dict)
    plane: dict = dataclasses.field(default_factory=dict)

    @property
    def smem_bytes(self) -> int:
        return 4 * sum(-(-n // 4) * 4 for s, n in enumerate(self.slot_floats)
                       if s not in self.device)

    @property
    def scratch_floats(self) -> int:
        """The floats of one CTA's scratch."""
        return sum(-(-n // SCRATCH_ALIGN) * SCRATCH_ALIGN for n in self.device.values())

    def offsets(self) -> list:
        """Each buffer's first float, in shared memory or (a buffer of
        ``device``) in the CTA's scratch; every buffer in shared memory
        starts 16-byte aligned, as 16-byte asynchronous copies into it
        need, and every one in scratch on a 128-byte line."""
        out, acc, dacc = [], 0, 0
        for s, n in enumerate(self.slot_floats):
            if s in self.device:
                out.append(dacc)
                dacc += -(-self.device[s] // SCRATCH_ALIGN) * SCRATCH_ALIGN
            else:
                out.append(acc)
                acc += -(-n // 4) * 4
        return out


def _storage(fused_op: stencil.FusedEpochOp, plan: TilePlan) -> _Storage:
    """The buffers of ``plan``: shared memory by liveness
    (:func:`_buffers`), and for a scratch plan the buffers moved to device
    memory, the largest first, until the rest fits ``plan.budget``: an
    operand that lived in a moved buffer is read in place, a frame goes
    to the CTA's scratch."""
    if plan.stream:
        return _rings(fused_op, plan)
    st = _buffers(fused_op, plan)
    if not plan.ctas:
        return st
    args = set(fused_op.body.args)
    for s in sorted(range(len(st.slot_floats)), key=lambda k: (-st.slot_floats[k], k)):
        if st.smem_bytes <= plan.budget:
            break
        st.device[s] = 0
    for v, s in st.slot_of.items():
        if s in st.device:
            if v in args:
                st.in_place.add(v)
            else:
                st.device[s] = max(st.device[s], _points(plan.window_shape(v.type.bounds)))
    return st


def _buffers(fused_op: stencil.FusedEpochOp, plan: TilePlan) -> _Storage:
    """Give every region value held on chip a shared-memory buffer, reusing
    a buffer once its value's last reader in the region has run."""
    ops = list(fused_op.body.ops[:-1])  # without the fused_yield
    escapes = set(_escapes(fused_op))
    last_use: dict = {}
    for i, op in enumerate(ops):
        for o in op.operands:
            last_use[o] = i
    st = _Storage({}, set(), [])
    free: list = []

    def floats(v) -> int:
        n = 1
        for w in plan.window_shape(v.type.bounds):
            n *= w
        return n

    def take(v) -> None:
        n = floats(v)
        fits = [s for s in free if st.slot_floats[s] >= n]
        if fits:
            s = min(fits, key=lambda k: st.slot_floats[k])
        elif free:
            s = max(free, key=lambda k: st.slot_floats[k])
            st.slot_floats[s] = n
        else:
            s = len(st.slot_floats)
            st.slot_floats.append(n)
        if s in free:
            free.remove(s)
        st.slot_of[v] = s

    for arg in fused_op.body.args:
        take(arg)
    for i, op in enumerate(ops):
        if isinstance(op, stencil.ApplyOp):
            for r in op.results:
                if len(op.results) == 1 and r in escapes and r not in last_use:
                    st.direct.add(r)
                else:
                    take(r)
        else:  # comm.boundary_mask
            x, r = op.temp, op.results[0]
            if last_use[x] == i:
                st.slot_of[r] = st.slot_of[x]  # in place: the input dies here
            else:
                take(r)
        # free the buffers of operands read here for the last time and of
        # results nothing later reads (an escape is copied out in this
        # op's phase); a mask done in place hands its buffer on
        live = {st.slot_of.get(r) for r in op.results if r in last_use}
        for v in [*op.operands, *op.results]:
            s = st.slot_of.get(v)
            if s is not None and last_use.get(v, -1) <= i and s not in live and s not in free:
                free.append(s)
    return st


def _lags(fused_op: stencil.FusedEpochOp) -> dict:
    """Each region value's lag in a streaming plan: the planes by which
    its front (the plane it computes while the operands load plane ``z``:
    ``z - lag``) trails the operands'.  An apply trails each operand by
    that operand's highest dim-0 tap, a mask its input."""
    kept = _LAGS.get(fused_op)
    if kept is not None:
        return kept
    lag = {a: 0 for a in fused_op.body.args}
    for op in fused_op.body.ops[:-1]:
        if isinstance(op, stencil.ApplyOp):
            fronts = [lag[op.operands[k]] + hi[0] for k, (_, hi) in op.access_extents().items()]
            for r in op.results:
                lag[r] = max(fronts, default=0)
        else:  # comm.boundary_mask
            lag[op.results[0]] = lag[op.temp]
    _LAGS[fused_op] = lag
    return lag


def _readers(fused_op: stencil.FusedEpochOp) -> dict:
    """Region value -> the ops that read it, the fused_yield included."""
    readers: dict = {}
    for op in fused_op.body.ops:
        for o in op.operands:
            readers.setdefault(o, []).append(op)
    return readers


def _queue_options(op: stencil.ApplyOp, plan: TilePlan, lag: dict) -> list:
    """The register queues a streaming plan's walk of ``op`` may keep:
    ``[(kind, k, lo, top), …]``, stars first.  A queue holds, for each of a
    thread's rows, operand ``k``'s values at its column for the planes
    ``lo`` to ``top`` (relative to the plane it computes, oldest first); it
    moves one plane on an iteration and loads only its newest plane from
    the ring, so the ring holds only the planes the other taps read.
    ``top`` is the highest dim-0 tap (a star: every dim-0 tap lies on the
    point's own column), or for an operand read only on the point's column
    (wave's older field) the operand's front, so that its ring keeps a
    single plane.  None where the walk takes more than one round of the
    CTA's threads: a thread keeps its column from plane to plane only in
    one round."""
    shape = plan.window_shape(op.results[0].type.bounds)[1:]
    if -(-shape[0] // _plane_r(shape)) * shape[1] > THREADS:
        return []
    taps: dict = {}
    for x in op.body.ops:
        if isinstance(x, stencil.AccessOp):
            taps.setdefault(x.temp.index, []).append(tuple(x.offset))
    stars, columns = [], []
    for k, offs in sorted(taps.items()):
        if any(o[0] and o[1:] != (0, 0) for o in offs):
            continue  # a dim-0 tap off the point's column
        lo, hi = min(0, *(o[0] for o in offs)), max(0, *(o[0] for o in offs))
        if all(o[1:] == (0, 0) for o in offs):
            top = lag[op.results[0]] - lag[op.operands[k]]
            if top > lo:
                columns.append(("column", k, lo, top))
        elif hi > lo:
            stars.append(("star", k, lo, hi))
    return stars + columns


def _column_loads(op: stencil.ApplyOp, rows: int, queued: dict) -> int:
    """The values one column of ``op``'s plane walk reads from shared
    memory into registers, with the queues ``queued``."""
    n = 0
    for (k, (o0, o2)), rs in _plane_rows(op, rows).items():
        n += sum(1 for row in rs if not (k in queued and o2 == 0 and (o0 or 0 <= row < rows)))
    return n


def _queues(fused_op: stencil.FusedEpochOp, plan: TilePlan) -> dict:
    """A streaming plan's register queues (:func:`_queue_options`): ``{op:
    {k: (lo, top)}}``.  Queues live from plane to plane, so every op's
    count at once; they are handed out in op order, stars before
    column-only reads, while all queues plus the most values one column
    loads stay within ``STREAM_REGS`` registers a thread (past that, the
    card measured spills that cost more than the queues save)."""
    lag = _lags(fused_op)
    applies = [op for op in fused_op.body.ops if isinstance(op, stencil.ApplyOp)]
    rows = {op: _plane_r(plan.window_shape(op.results[0].type.bounds)[1:]) for op in applies}
    options = {op: _queue_options(op, plan, lag) for op in applies}
    out: dict = {op: {} for op in applies}
    loads = {op: _column_loads(op, rows[op], {}) for op in applies}
    held = 0
    for kind in ("star", "column"):
        for op in applies:
            for what, k, lo, top in options[op]:
                if what != kind:
                    continue
                trial = {**out[op], k: (lo, top)}
                mine = _column_loads(op, rows[op], trial)
                more = rows[op] * (top - lo + 1)
                most = max([mine] + [n for o, n in loads.items() if o is not op])
                if held + more + most <= STREAM_REGS:
                    out[op], loads[op] = trial, mine
                    held += more
    return out


def _ring_low(op: stencil.ApplyOp, k: int, queued: dict) -> int:
    """The lowest dim-0 offset at which ``op`` reads operand ``k`` from its
    ring: its lowest dim-0 tap, or with a queue (:func:`_queues`) the
    plane its other taps read (0), else the newest plane it loads
    (``queued``: the op's queues, :func:`_queues`)."""
    if k not in queued:
        return op.access_extents()[k][0][0]
    plane = [x.offset[0] for x in op.body.ops
             if isinstance(x, stencil.AccessOp) and x.temp.index == k and tuple(x.offset[1:]) != (0, 0)]
    return min(plane + [queued[k][1]])


def _rings(fused_op: stencil.FusedEpochOp, plan: TilePlan) -> _Storage:
    """A streaming plan's buffers: a ring of planes in shared memory for
    every value held on chip, as deep as its front minus the lowest plane
    a reader still needs (that reader's front plus the lowest dim-0 offset
    it reads from the ring, :func:`_ring_low`), plus one; with
    ``plan.prefetch`` one more for each operand.  A value
    read only at its own front (by a mask, or copied out as an escape)
    keeps one plane.  A mask works in place when it is its input's only
    reader; an escape that an apply writes and nothing else reads goes
    straight to device memory and has no ring."""
    lag = _lags(fused_op)
    queues = _queues(fused_op, plan)
    need: dict = {}
    for op in fused_op.body.ops:
        if isinstance(op, stencil.ApplyOp):
            queued = queues[op]
            for k in op.access_extents():
                o = op.operands[k]
                low = _ring_low(op, k, queued)
                need[o] = max(need.get(o, 1), lag[op.results[0]] - low - lag[o] + 1)
        for o in op.operands:
            need.setdefault(o, 1)
    escapes = set(_escapes(fused_op))
    readers = _readers(fused_op)
    st = _Storage({}, set(), [])

    def ring(v, planes: int) -> None:
        shape = plan.window_shape(v.type.bounds)
        st.slot_of[v] = s = len(st.slot_floats)
        st.plane[s] = -(-_points(shape[1:]) // 4) * 4
        st.depth[s] = planes
        st.slot_floats.append(planes * st.plane[s])

    for a in fused_op.body.args:
        ring(a, need.get(a, 1) + plan.prefetch)
    for op in fused_op.body.ops[:-1]:
        if isinstance(op, stencil.ApplyOp):
            for r in op.results:
                if len(op.results) == 1 and r in escapes and len(readers[r]) == 1:
                    st.direct.add(r)
                else:
                    ring(r, need.get(r, 1))
        else:  # comm.boundary_mask
            x, r = op.temp, op.results[0]
            if readers[x] == [op]:
                s = st.slot_of[r] = st.slot_of[x]  # in place: the mask is its only reader
                st.depth[s] = max(st.depth[s], need.get(r, 1))
                st.slot_floats[s] = st.depth[s] * st.plane[s]
            else:
                ring(r, need.get(r, 1))
    return st


# --------------------------------------------------------------------------
# Code generation
# --------------------------------------------------------------------------

def _padded_columns(shape: tuple) -> int:
    """The columns of a frame walk (every point of the minor dims), padded
    to whole warps so that a warp never spans two chunks of rows and its
    shared-memory accesses stay on consecutive banks; rank 1 has one."""
    c = 1
    for w in shape[1:]:
        c *= w
    return c if len(shape) == 1 else -(-c // 32) * 32


def _global_index(shape: tuple) -> str:
    """Flat index into a device array of ``shape`` of window point ``i`` of
    the current tile: a value's window starts at array index ``t``."""
    strides = _k1._strides(shape)
    return " + ".join(f"(t{d} + i{d}) * {st}LL" for d, st in enumerate(strides))


def _outside_owned(plan: TilePlan, bounds: stencil.Bounds) -> Optional[str]:
    """C condition true for the window points of an escape of ``bounds``
    that this tile does not write (None when it writes all of them)."""
    terms = []
    for d in range(bounds.rank):
        lo = plan.core.lb[d] - bounds.lb[d]
        hi = bounds.ub[d] - plan.core.ub[d]
        if lo:
            terms.append(f"(!first{d} && i{d} < {lo})")
        if hi:
            terms.append(f"(!last{d} && i{d} >= {lo + plan.tile[d]})")
    return " || ".join(terms) or None


def _walk(shape: tuple, column: Callable[[int], list], point: Callable[[int], list],
          skip: Optional[str] = None, first: int = 0, rows: Optional[int] = None,
          pad: bool = True) -> list:
    """A loop over the points of a frame of ``shape`` (a value's window) in
    register-blocked columns: work item ``q`` is column ``c`` of the minor
    dims (``i1``, ``i2`` once per column, no division per point) and the
    chunk of ``R`` rows from ``a``; a warp spans consecutive columns.
    ``column(a_last)`` gives the lines run once per column (``a_last``:
    the first row of the last chunk), ``point(j)`` those of point ``a + j``
    in a block of its own (``i0``, and ``p``, its index in the frame's
    buffer).  Points past a ragged last chunk and points where ``skip``
    holds are not computed.  ``first`` names the frame's dims from
    ``i{first}`` on: a streaming plan walks a plane (``first`` 1, rows
    ``i1`` and columns ``i2``) at the plane index ``i0`` around it, with
    ``rows`` points a thread (:func:`_plane_r`) in place of ``R`` and
    (``pad`` False) its columns not padded to whole warps: a warp may then
    span two chunks, which costs a few bank conflicts where padding a
    narrow plane would idle up to half its lanes."""
    rank = len(shape)
    r = rows or R_BY_RANK[rank]
    h = shape[0]
    cols = 1
    for w in shape[1:]:
        cols *= w
    cpad = _padded_columns(shape) if pad else cols
    chunks = -(-h // r)
    a_last = (chunks - 1) * r
    lines = [f"  for (int q = threadIdx.x; q < {chunks * cpad}; q += kThreads) {{"]
    if rank == 1:
        lines.append(f"    const int a = q * {r};")
    else:
        lines.append(f"    const int c = q % {cpad};" if chunks > 1 else "    const int c = q;")
        lines.append(f"    const int a = q / {cpad} * {r};" if chunks > 1 else "    const int a = 0;")
        if cpad != cols:
            lines.append(f"    if (c >= {cols}) continue;")
        if rank == 2:
            lines.append(f"    const int i{first + 1} = c;")
        else:
            lines.append(f"    const int i{first + 1} = c / {shape[2]};")
            lines.append(f"    const int i{first + 2} = c % {shape[2]};")
    lines.append(f"    const int pc = a * {cols}" + ("" if rank == 1 else " + c") + ";")
    lines += column(a_last)
    for j in range(r):
        conds = []
        if a_last + j >= h:
            conds.append(f"i{first} < {h}")
        if skip:
            conds.append(f"!({skip})")
        lines += ["    {", f"      const int i{first} = a + {j};"]
        if conds:
            lines.append(f"      if ({' && '.join(conds)}) {{")
        body = point(j)
        if any("[p]" in s or " + p]" in s for s in body):
            lines.append(f"      const int p = pc + {j * cols};")
        lines += body + (["      }"] if conds else []) + ["    }"]
    return lines + ["  }", "  __syncthreads();"]


def _tag(row: int) -> str:
    return f"m{-row}" if row < 0 else str(row)


def _plus(expr: str, n: int) -> str:
    """C expression ``expr + n``, written without ``+ -``."""
    return expr if n == 0 else f"{expr} + {n}" if n > 0 else f"{expr} - {-n}"


def _box_of(boxes: dict, mask_op) -> dict:
    """``{dim: j}``: the dims a boundary_mask tests, each against the box
    bounds ``box{j}_lo``/``box{j}_hi`` of the launch's arguments (empty
    when it keeps every point); ``boxes`` is :func:`_box_keys`."""
    return {d: j for (m, d), j in sorted(boxes.items(), key=lambda kv: kv[0][1])
            if m is mask_op}


def _fused_masks(fused_op: stencil.FusedEpochOp) -> dict:
    """apply -> the boundary_mask that is the only reader of its one
    result: such a mask is applied as the apply writes its frame, into the
    buffer the two share."""
    readers = _readers(fused_op)
    mask_of = {}
    for op in fused_op.body.ops:
        if isinstance(op, stencil.ApplyOp) and len(op.results) == 1:
            rd = readers.get(op.results[0], [])
            if len(rd) == 1 and isinstance(rd[0], comm.BoundaryMaskOp):
                mask_of[op] = rd[0]
    return mask_of


def emit_epoch_cuda(
    fused_op: stencil.FusedEpochOp,
    tile: Optional[Sequence[int]] = None,
    ptr_align: int = 16,
    scratch: bool = False,
    stream=None,
) -> str:
    """CUDA C++ source of K2 for one fused epoch at one tile: a
    ``__global__`` kernel with one CTA per tile, the C launcher
    ``k2_epoch_launch(in0, …, out0, …, box…, int slots, stream) ->
    cudaError_t`` and the occupancy query ``k2_epoch_occupancy(int*
    ctas_per_sm)``.  ``ptr_align`` is the alignment in bytes that every
    operand pointer has; it bounds the width of the window copies.  The
    launcher takes, after the output pointers, the ``int`` box bounds of
    :func:`box_args`, then the slot count (each slot's operands and
    escapes one bounds' size past the last's).  ``tile``, ``scratch`` and
    ``stream`` choose the plan as :func:`plan_epoch` does.

    A scratch plan's kernel (``plan_epoch(fused_op, tile, scratch).ctas``
    > 0) has its CTAs loop over the (slot, tile) pairs, and its launcher
    takes, after the slot count, the scratch (``ctas`` times
    ``_storage(...).scratch_floats`` floats of device memory) and ``ctas``,
    the CTAs to launch (1 to ``plan.ctas``).  A streaming plan's kernel
    has the tiled kernel's launcher; each CTA walks its tile's planes."""
    plan = plan_epoch(fused_op, tile, scratch, stream)
    st = _storage(fused_op, plan)
    offsets = st.offsets()
    rank = plan.core.rank
    args = list(fused_op.body.args)
    escapes = _escapes(fused_op)
    n_in, n_out = len(args), len(escapes)
    smem = st.smem_bytes
    looping = plan.ctas > 0
    min_ctas = plan.ctas // SMS if looping else 2 if smem <= SMEM_TWO_BLOCKS else 1

    def wshape(v) -> tuple:
        return plan.window_shape(v.type.bounds)

    walk = (f"up to {STREAM_ROWS} points per thread along dim 1, planes streamed along dim 0"
            if plan.stream else f"{R_BY_RANK[rank]} points per thread along dim 0")
    src = [
        "// Generated by repro_torch/kernels/epoch_kernel.py (kernel K2).",
        f"// core {plan.core.lb}..{plan.core.ub}, tile {plan.tile}, grid "
        f"{plan.grid} ({plan.n_tiles} CTAs), {smem} bytes of shared memory, {walk}",
    ]
    for k, a in enumerate(args):
        src.append(f"// in{k}: bounds {a.type.bounds.lb}..{a.type.bounds.ub}, window {wshape(a)}")
    for j, e in enumerate(escapes):
        src.append(f"// out{j}: bounds {e.type.bounds.lb}..{e.type.bounds.ub}")
    if looping:
        src.append(
            f"// scratch plan: at most {plan.ctas} CTAs ({min_ctas} an SM) loop over the "
            f"slots' tiles, {4 * st.scratch_floats} bytes of device-memory scratch each; "
            f"read in place: {[f'in{args.index(a)}' for a in args if a in st.in_place]}; "
            f"in scratch: {[f's{s}' for s, n in sorted(st.device.items()) if n]}"
        )
    if plan.stream:
        src.append(
            "// streaming plan: rings of " + ", ".join(
                f"s{s} {st.depth[s]} x {st.plane[s]}" for s in sorted(st.depth))
            + " floats (planes x floats a plane), "
            + ("operands one plane ahead" if plan.prefetch else "no prefetch plane")
        )
    src += [f'#include "{_k1._HEADER}"', "", "constexpr int kThreads = "
            f"K1_BLOCK_THREADS({THREADS});", ""]
    boxes = _box_keys(fused_op)
    n_box = len(set(boxes.values()))
    box_params = [f"int box{j}_{end}" for j in range(n_box) for end in ("lo", "hi")]
    params = [f"const float* __restrict__ in{k}_slots" for k in range(n_in)] + [
        f"float* __restrict__ out{j}_slots" for j in range(n_out)
    ] + box_params + (["int slots", "float* const scratch"] if looping else [])
    src.append(
        f"__global__ void __launch_bounds__({THREADS}, {min_ctas}) k2_epoch("
        + ", ".join(params) + ") {"
    )
    src.append("  K1_DYNAMIC_SMEM(smem);")
    for s, off in enumerate(offsets):
        if s not in st.device:
            src.append(f"  float* const s{s} = smem + {off};")
    top = src
    if looping:
        # this CTA's scratch (64-bit offsets), then its (slot, tile) pairs
        src.append(f"  float* const sc = scratch + static_cast<long long>(blockIdx.x) * "
                   f"{st.scratch_floats}LL;")
        for s, n in sorted(st.device.items()):
            if n:
                src.append(f"  float* const s{s} = sc + {offsets[s]};")
        src.append(f"  for (long long item = blockIdx.x; item < static_cast<long long>(slots) * "
                   f"{plan.n_tiles}LL; item += gridDim.x) {{")
        src = ["  K1_SCRATCH_TILE(sc, " f"{st.scratch_floats}LL);"]
    # this CTA's slot (slowest), its tile's index along each dim and its
    # core-relative origin (32-bit: a core extent fits; device offsets are
    # 64-bit)
    if looping:
        src.append(f"  const long long slot = item / {plan.n_tiles}LL;")
    else:
        src.append(f"  const long long slot = blockIdx.x / {plan.n_tiles}u;")
    for k, a in enumerate(args):
        src.append(f"  const float* __restrict__ const in{k} = in{k}_slots + slot * "
                   f"{_k1._numel(a.type.bounds.shape)}LL;")
    for j, e in enumerate(escapes):
        src.append(f"  float* __restrict__ const out{j} = out{j}_slots + slot * "
                   f"{_k1._numel(e.type.bounds.shape)}LL;")
    if looping:
        src.append(f"  int blk = static_cast<int>(item % {plan.n_tiles}LL);")
    else:
        src.append(f"  int blk = blockIdx.x % {plan.n_tiles}u;")
    for d in reversed(range(rank)):
        src.append(f"  const int g{d} = blk % {plan.grid[d]};")
        if d:
            src.append(f"  blk /= {plan.grid[d]};")
    for d in range(rank):
        src.append(f"  const int t{d} = g{d} * {plan.tile[d]};")
        src.append(f"  const bool first{d} = g{d} == 0;")
        src.append(f"  const bool last{d} = g{d} == {plan.grid[d] - 1};")
        src.append(f"  (void)first{d}; (void)last{d};")
    if plan.stream:
        src += _stream_body(fused_op, plan, st, boxes, ptr_align)
    else:
        src += _tile_body(fused_op, plan, st, boxes, ptr_align)
    if looping:
        # a barrier at the end keeps the next tile's writes behind this
        # tile's reads
        if src[-1] != "  __syncthreads();":
            src.append("  __syncthreads();")
        src = top + ["  " + line if line else line for line in src] + ["  }"]
    elif src[-1] == "  __syncthreads();":
        src.pop()  # nothing follows the last phase
    src += ["}", ""]

    c_params = [f"const void* in{k}" for k in range(n_in)] + [
        f"void* out{j}" for j in range(n_out)
    ] + box_params + ["int slots"] + (["void* scratch", "int ctas"] if looping else [])
    call_args = [f"static_cast<const float*>(in{k})" for k in range(n_in)] + [
        f"static_cast<float*>(out{j})" for j in range(n_out)
    ] + [p.split()[1] for p in box_params] + (
        ["slots", "static_cast<float*>(scratch)"] if looping else [])
    opt_in = []
    if smem > 48 * 1024:
        opt_in = [
            f"  const int attr = static_cast<int>(K1_OPT_IN_SMEM(k2_epoch, {smem}));",
            "  if (attr != 0) return attr;",
        ]
    src += [f"K1_EXPORT int {_LAUNCHER}(" + ", ".join(c_params + ["void* stream"]) + ") {"]
    if looping:
        # the grid is the CTAs the scratch was sized for, each looping over
        # the slots' tiles with a 64-bit index: any slot count fits
        src += [f"  if (slots < 1 || ctas < 1 || ctas > {plan.ctas}) return {_k1._INVALID_VALUE};"]
        grid = "static_cast<unsigned int>(ctas)"
    else:
        src += [f"  if (slots < 1 || slots > {_k1._MAX_GRID // plan.n_tiles}) "
                f"return {_k1._INVALID_VALUE};"]
        grid = f"static_cast<unsigned int>(slots) * {plan.n_tiles}u"
    src += opt_in
    src += [
        f"  K1_LAUNCH(k2_epoch, {grid}, kThreads, "
        f"{smem}, stream,",
        "            " + ", ".join(call_args) + ");",
        "  return k1::launch_status();",
        "}",
        "",
        f"K1_EXPORT int {_OCCUPANCY}(void* ctas_per_sm) {{",
        *opt_in,
        "  return static_cast<int>(K1_OCCUPANCY(static_cast<int*>(ctas_per_sm), k2_epoch, "
        f"kThreads, {smem}));",
        "}",
        "",
    ]
    return _graphs.name_kernel(src, _graphs.K2_KERNEL)


def _tile_body(fused_op: stencil.FusedEpochOp, plan: TilePlan, st: _Storage, boxes: dict,
               ptr_align: int) -> list:
    """The kernel lines of a tiled or scratch plan after the tile's
    indices: every operand's window loaded, then each op's frame."""
    offsets = st.offsets()
    rank = plan.core.rank
    args = list(fused_op.body.args)
    escapes = _escapes(fused_op)
    looping = plan.ctas > 0
    src: list = []

    def wshape(v) -> tuple:
        return plan.window_shape(v.type.bounds)

    def buf(v) -> str:
        return f"s{st.slot_of[v]}"

    def strides(v) -> tuple:
        """A buffer's strides: its window's, or an operand's read in place."""
        return _k1._strides(v.type.bounds.shape if v in st.in_place else wshape(v))

    def read(v, index: str) -> str:
        """Point ``index`` (flat, by :func:`strides`) of ``v``'s window."""
        if v in st.in_place:
            return f"win{args.index(v)}[{index}]"
        return f"{buf(v)}[{index}]"

    for k, a in enumerate(args):
        if a in st.in_place:
            origin = " + ".join(f"t{d} * {x}LL" for d, x in enumerate(strides(a)))
            src.append(f"  const float* __restrict__ const win{k} = in{k} + {origin};")

    # every operand's window, device memory -> shared memory, by
    # asynchronous copies; one wait and one barrier for all of them
    loaded = [a for a in args if a not in st.in_place]
    for k, a in enumerate(args):
        if a in st.in_place:
            continue
        ow = wshape(a)
        # the array's rows, the window's rows, the tile's minor side (each
        # window starts at a multiple of it) and the buffer's offset
        v = _k1.copy_width((a.type.bounds.shape[-1], ow[-1], plan.tile[-1],
                            offsets[st.slot_of[a]]), ptr_align)
        nv = ow[-1] // v
        rows = 1
        for w in ow[:-1]:
            rows *= w
        src.append(f"  // load in{k}: window {ow}, {4 * v}-byte copies")
        src.append(f"  for (int q = threadIdx.x; q < {rows * nv}; q += kThreads) {{")
        if rank == 1:
            src.append(f"    const int i0 = q * {v};")
        else:
            src.append(f"    const int row = q / {nv};")
            if rank == 2:
                src.append("    const int i0 = row;")
            else:
                src.append(f"    const int i0 = row / {ow[1]};")
                src.append(f"    const int i1 = row % {ow[1]};")
            src.append(f"    const int i{rank - 1} = q % {nv} * {v};")
        src.append(
            f"    K1_CP_ASYNC({buf(a)} + q * {v}, "
            f"in{k} + {_global_index(a.type.bounds.shape)}, {4 * v});"
        )
        src.append("  }")
    if loaded or not looping:
        src += ["  K1_CP_ASYNC_COMMIT();", "  K1_CP_ASYNC_WAIT(0);", "  __syncthreads();"]

    def box_of(mask_op) -> dict:
        return _box_of(boxes, mask_op)

    def mask_column(mask_op) -> list:
        """A mask's box test, the part computed once per column: along dim
        0 the offsets of the column's first row from the box's ``lo`` and
        ``hi`` (``m_lo``, ``m_hi``), along the minor dims whether the
        column lies inside the box (``m_in``).  Point ``j`` rows down then
        compares only against immediates (:func:`mask_point`)."""
        lb = mask_op.temp.type.bounds.lb
        lines, inside = [], []
        for d, j in box_of(mask_op).items():
            if d == 0:
                lines += [f"    const int m_lo = a + t0 + {lb[0]} - box{j}_lo;",
                          f"    const int m_hi = a + t0 + {lb[0]} - box{j}_hi;"]
            else:
                inside.append(f"t{d} + i{d} + {lb[d]} >= box{j}_lo && "
                              f"t{d} + i{d} + {lb[d]} < box{j}_hi")
        if inside:
            lines.append(f"    const bool m_in = {' && '.join(inside)};")
        return lines

    def mask_point(mask_op, row: int) -> str:
        """C condition true where a mask keeps the point ``row`` rows below
        its column's first (after :func:`mask_column`'s lines)."""
        dims = box_of(mask_op)
        terms = ["m_in"] if any(d > 0 for d in dims) else []
        if 0 in dims:
            terms += [f"m_lo >= {-row}", f"m_hi < {-row}"]
        return " && ".join(terms)

    mask_of = _fused_masks(fused_op)

    def no_column(a_last) -> list:
        return []

    def copy_out(v) -> list:
        def point(j):
            return [
                f"      out{e}[{_global_index(x.type.bounds.shape)}] = {buf(v)}[p];"
                for e, x in enumerate(escapes) if x is v
            ]

        return _walk(wshape(v), no_column, point, _outside_owned(plan, v.type.bounds))

    for n, op in enumerate(fused_op.body.ops[:-1]):
        if isinstance(op, stencil.ApplyOp):
            r0 = op.results[0]
            rb = r0.type.bounds
            rw = wshape(r0)
            mask = mask_of.get(op)
            src.append(
                f"  // op {n}: stencil.apply, window {rw}"
                + (f", then op {n + 1}'s mask" if mask is not None else "")
            )
            groups = _k1.column_rows(op, R_BY_RANK[rank])
            names: dict = {}

            def column(a_last, op=op, rb=rb, groups=groups, names=names, mask=mask) -> list:
                lines = mask_column(mask) if mask is not None else []
                for k in sorted({k for k, _ in groups}):
                    o = op.operands[k]
                    ostr = strides(o)
                    shift = [r - l for r, l in zip(rb.lb, o.type.bounds.lb)]
                    terms = [f"(a + {shift[0]}) * {ostr[0]}"] + [
                        f"(i{d} + {shift[d]}) * {ostr[d]}" for d in range(1, rank)
                    ]
                    # an operand read in place may span more than an int
                    span = sum((w - 1) * x for w, x in zip(wshape(o), ostr))
                    ctype = "int" if span < 2**31 else "long long"
                    if ctype != "int":
                        terms = [f"static_cast<long long>{t}" if i == 0 else t
                                 for i, t in enumerate(terms)]
                    lines.append(f"    const {ctype} b{k} = {' + '.join(terms)};")
                for g, ((k, rest), rows) in enumerate(groups.items()):
                    o = op.operands[k]
                    ow = wshape(o)
                    ostr = strides(o)
                    shift0 = rb.lb[0] - o.type.bounds.lb[0]
                    flat_rest = sum(x * s for x, s in zip(rest, ostr[1:]))
                    for row in rows:
                        name = f"x{k}_{g}_{_tag(row)}"
                        expr = read(o, f"b{k} + {row * ostr[0] + flat_rest}")
                        if a_last + shift0 + row >= ow[0]:  # past a ragged chunk's window
                            expr = f"(a < {ow[0] - shift0 - row}) ? {expr} : 0.0f"
                        lines.append(f"    const float {name} = {expr};")
                        names[(k, rest, row)] = name
                return lines

            def index(d, rb=rb):
                return (
                    f"static_cast<float>(t{d} + i{d}) + "
                    f"{_k1._f32_literal(float(rb.lb[d]))}"
                )

            def store(k, v, row, op=op, mask=mask):
                r = op.results[k]
                if r in st.direct:
                    return " ".join(
                        f"out{e}[{_global_index(r.type.bounds.shape)}] = {v};"
                        for e, x in enumerate(escapes) if x is r
                    )
                if mask is not None and box_of(mask):
                    return f"{buf(mask.results[0])}[p] = ({mask_point(mask, row)}) ? {v} : 0.0f;"
                return f"{buf(r)}[p] = {v};"

            def point(j, op=op, names=names, index=index, store=store) -> list:
                def load(k, offset):
                    return names[(k, tuple(offset[1:]), j + offset[0])]

                return _k1.emit_body(op, load, index, lambda k, v: store(k, v, j),
                                     indent="      ")

            skip = _outside_owned(plan, rb) if r0 in st.direct else None
            src += _walk(rw, column, point, skip)
            for r in op.results:
                if r in escapes and r not in st.direct:
                    src.append(f"  // escape of op {n}")
                    src += copy_out(r)
        else:  # comm.boundary_mask
            x, r = op.temp, op.results[0]
            fused = any(m is op for m in mask_of.values())
            if not fused:
                src.append(f"  // op {n}: comm.boundary_mask")
                xp = read(x, " + ".join(f"i{d} * {n}" for d, n in enumerate(strides(x)))
                           if x in st.in_place else "p")
                if box_of(op):
                    src += _walk(wshape(r), lambda a_last, op=op, xp=xp: mask_column(op),
                                 lambda j, op=op, xp=xp: [
                                     f"      {buf(r)}[p] = ({mask_point(op, j)}) ? {xp} : 0.0f;"])
                elif st.slot_of[r] != st.slot_of[x] or x in st.in_place:
                    line = f"      {buf(r)}[p] = {xp};"
                    src += _walk(wshape(r), no_column, lambda j, line=line: [line])
            if r in escapes:
                src.append(f"  // escape of op {n}")
                src += copy_out(r)
    return src


@functools.lru_cache(maxsize=4096)
def _plane_rows(apply_op: stencil.ApplyOp, rows: int) -> dict:
    """The register-blocked column of one apply in a plane walk:
    ``{(operand, (dim-0 offset, dim-2 offset)): [row, …]}``, each row along
    dim 1 (relative to the column's first point) read once into a
    register for the column's ``rows`` points (:func:`_k1.column_rows`
    with dim 1 as the rows; kept, as the plan search asks for the same ones
    many times: read-only)."""
    taps: dict = {}
    for x in apply_op.body.ops:
        if isinstance(x, stencil.AccessOp):
            o0, o1, o2 = x.offset
            taps.setdefault((x.temp.index, (o0, o2)), set()).add(o1)
    return {
        key: sorted({j + o1 for j in range(rows) for o1 in s1})
        for key, s1 in sorted(taps.items())
    }


def _stream_body(fused_op: stencil.FusedEpochOp, plan: TilePlan, st: _Storage, boxes: dict,
                 ptr_align: int) -> list:
    """The kernel lines of a streaming plan after the tile's indices.
    Iteration ``it`` loads the operands' window plane ``it`` into their
    rings (plane ``i`` of a value's window in slot ``i % depth``; with a
    prefetch plane, plane ``it + 1`` while the CTA computes), then every
    op computes its value's plane at its lag (:func:`_lags`): plane ``i0
    = it + c`` of its window, where ``c`` aligns the values' fronts; a
    value outside its window at that iteration is skipped.  Each plane is
    a 2-D frame walked by :func:`_walk` (rows along dim 1, the columns of
    dim 2 unpadded); a dim-0 tap reads the ring slot of its plane.  One
    ``__syncthreads`` follows each op's plane (a skew of one more plane a
    sub-step would do with one an iteration, but its deeper rings force
    smaller tiles, which measured slower: PERF.md)."""
    offsets = st.offsets()
    args = list(fused_op.body.args)
    escapes = _escapes(fused_op)
    lag = _lags(fused_op)
    mask_of = _fused_masks(fused_op)
    queues = _queues(fused_op, plan)
    values = _temp_values(fused_op)
    lb0 = {v: v.type.bounds.lb[0] for v in values}
    w0 = {v: plan.window_shape(v.type.bounds)[0] for v in values}
    zmin = min(lb0[v] + lag[v] for v in values)
    c = {v: zmin - lag[v] - lb0[v] for v in values}
    n_iter = max(w0[v] - c[v] for v in values)

    def pshape(v) -> tuple:
        return plan.window_shape(v.type.bounds)[1:]

    def buf(v) -> str:
        return f"s{st.slot_of[v]}"

    def walk(v, column, point, skip=None) -> list:
        """:func:`_walk` of ``v``'s plane, without its barrier."""
        return _walk(pshape(v), column, point, skip, first=1, rows=_plane_r(pshape(v)),
                     pad=False)[:-1]

    def ring(v, plane: str) -> str:
        """The first float of window plane ``plane`` in ``v``'s ring."""
        s = st.slot_of[v]
        return f"({plane}) % {st.depth[s]} * {st.plane[s]}"

    def box_of(mask_op) -> dict:
        return _box_of(boxes, mask_op)

    def mask_column(mask_op) -> list:
        """A mask's box test, the part computed once per column: along dim
        1 (the rows) the offsets of the column's first row from the box's
        ``lo`` and ``hi`` (``m_lo``, ``m_hi``), along dim 2 and the plane's
        dim 0 whether the column lies inside the box (``m_in``)."""
        lb = mask_op.temp.type.bounds.lb
        lines, inside = [], []
        for d, j in box_of(mask_op).items():
            if d == 1:
                lines += [f"    const int m_lo = a + t1 + {lb[1]} - box{j}_lo;",
                          f"    const int m_hi = a + t1 + {lb[1]} - box{j}_hi;"]
            else:
                inside.append(f"t{d} + i{d} + {lb[d]} >= box{j}_lo && "
                              f"t{d} + i{d} + {lb[d]} < box{j}_hi")
        if inside:
            lines.append(f"    const bool m_in = {' && '.join(inside)};")
        return lines

    def mask_point(mask_op, row: int) -> str:
        dims = box_of(mask_op)
        terms = ["m_in"] if any(d != 1 for d in dims) else []
        if 1 in dims:
            terms += [f"m_lo >= {-row}", f"m_hi < {-row}"]
        return " && ".join(terms)

    def no_column(a_last) -> list:
        return []

    def copy_out(v, w: str = "w") -> list:
        def point(j):
            return [
                f"      out{e}[{_global_index(x.type.bounds.shape)}] = {buf(v)}[{w} + p];"
                for e, x in enumerate(escapes) if x is v
            ]

        return walk(v, no_column, point, _outside_owned(plan, v.type.bounds))

    def at_plane(v, lines: list, early: int = 0) -> list:
        """``lines`` (a plane walk, without its barrier) in a block where
        ``i0`` is ``v``'s plane of this iteration, run only where that
        plane lies in ``v``'s window (or up to ``early`` planes before it,
        for the register queues); ``w`` is its slot in ``v``'s ring."""
        head = ["  {", f"    const int i0 = {_plus('it', c[v])};"]
        cond = ([f"i0 >= {-early}"] if c[v] < -early else []) + [f"i0 < {w0[v]}"]
        head.append(f"    if ({' && '.join(cond)}) {{")
        if v in st.slot_of:
            head.append(f"      const int w = {ring(v, 'i0')};")
        return head + ["    " + x for x in lines] + ["    }", "  }"]

    src = []
    # the operands' window planes of iteration it -> their rings, by
    # asynchronous copies
    src.append("  auto load = [&](const int it) {")
    for k, a in enumerate(args):
        ow = plan.window_shape(a.type.bounds)
        s = st.slot_of[a]
        v = _k1.copy_width((a.type.bounds.shape[-1], ow[-1], plan.tile[-1], offsets[s],
                            st.plane[s]), ptr_align)
        nv = ow[-1] // v
        src += [
            f"    {{  // in{k}: planes of {ow[1:]}, {4 * v}-byte copies",
            f"      const int i0 = {_plus('it', c[a])};",
            f"      if (i0 {'>= 0 && i0 ' if c[a] < 0 else ''}< {ow[0]}) {{",
            f"        float* const dst = {buf(a)} + {ring(a, 'i0')};",
            f"        for (int q = threadIdx.x; q < {ow[1] * nv}; q += kThreads) {{",
            f"          const int i1 = q / {nv};",
            f"          const int i2 = q % {nv} * {v};",
            f"          K1_CP_ASYNC(dst + q * {v}, in{k} + {_global_index(a.type.bounds.shape)}, "
            f"{4 * v});",
            "        }",
            "      }",
            "    }",
        ]
    src.append("  };")
    if plan.prefetch:
        src += ["  load(0);", "  K1_CP_ASYNC_COMMIT();"]
    loop = len(src)  # the register queues are declared here, before the loop
    src.append(f"  for (int it = 0; it < {n_iter}; ++it) {{")
    if plan.prefetch:
        # this iteration's planes have landed and the last iteration's
        # reads are done, so the next planes may take their slots
        src += ["    K1_CP_ASYNC_WAIT(0);", "    __syncthreads();", "    load(it + 1);",
                "    K1_CP_ASYNC_COMMIT();"]
    else:
        src += ["    load(it);", "    K1_CP_ASYNC_COMMIT();", "    K1_CP_ASYNC_WAIT(0);",
                "    __syncthreads();"]
    body: list = []
    decls: list = []
    for n, op in enumerate(fused_op.body.ops[:-1]):
        phase: list = []
        if isinstance(op, stencil.ApplyOp):
            r0 = op.results[0]
            rb = r0.type.bounds
            mask = mask_of.get(op)
            rows_ = _plane_r(pshape(r0))
            items = -(-pshape(r0)[0] // rows_) * pshape(r0)[1]
            groups = _plane_rows(op, rows_)
            queued = queues[op]
            names: dict = {}
            pre = []  # the plane of each ring read in its operand's ring
            early = 0  # iterations before its first plane that fill the queues
            for k in sorted({k for k, _ in groups}):
                o = op.operands[k]
                shift0 = rb.lb[0] - o.type.bounds.lb[0]
                offs = {o0 for kk, (o0, o2) in groups if kk == k
                        if k not in queued or (o0, o2) == (0, 0) or not o0}
                if k in queued:
                    offs.add(queued[k][1])
                    early = max(early, shift0 + queued[k][1])
                    for j in range(rows_):
                        for d in range(queued[k][0], queued[k][1] + 1):
                            decls.append(f"  K1_PER_THREAD(q{n}_{k}_{j}_{_tag(d)}, {items});")
                for off0 in sorted(offs):
                    pre.append(f"  const int r{k}_{_tag(off0)} = "
                               f"{ring(o, _plus('i0', shift0 + off0))};")

            def column(a_last, op=op, rb=rb, groups=groups, names=names, mask=mask, n=n,
                       queued=queued, rows_=rows_, early=early) -> list:
                lines = mask_column(mask) if mask is not None else []
                for k in sorted({k for k, _ in groups}):
                    o = op.operands[k]
                    pw = pshape(o)
                    shift = [q - l for q, l in zip(rb.lb, o.type.bounds.lb)]
                    lines.append(f"    const int b{k} = (a + {shift[1]}) * {pw[1]} + i2 + {shift[2]};")
                for k, (lo, hi) in sorted(queued.items()):
                    # each row's queue moves one plane on, then takes the
                    # newest plane from the ring
                    o = op.operands[k]
                    pw = pshape(o)
                    shift0 = rb.lb[0] - o.type.bounds.lb[0]
                    shift1 = rb.lb[1] - o.type.bounds.lb[1]
                    for j in range(rows_):
                        q = [f"K1_MINE(q{n}_{k}_{j}_{_tag(d)}, q)" for d in range(lo, hi + 1)]
                        lines += [f"    {a} = {b};" for a, b in zip(q, q[1:])]
                        expr = f"{buf(o)}[r{k}_{_tag(hi)} + b{k} + {j * pw[1]}]"
                        guards = []
                        if a_last + shift1 + j >= pw[0]:
                            guards.append(f"a < {pw[0] - shift1 - j}")
                        if shift0 + hi < early:
                            guards.append(f"i0 >= {-(shift0 + hi)}")
                        if w0[r0] - 1 + shift0 + hi >= w0[o]:  # past the operand's last plane
                            guards.append(f"i0 < {w0[o] - shift0 - hi}")
                        if guards:
                            expr = f"({' && '.join(guards)}) ? {expr} : 0.0f"
                        lines.append(f"    {q[-1]} = {expr};")
                        for d in range(lo, hi + 1):
                            names[(k, (d, 0), j)] = q[d - lo]
                if early:
                    lines.append("    if (i0 < 0) continue;  // the queues fill before the first plane")
                for g, ((k, (off0, off2)), rows) in enumerate(groups.items()):
                    o = op.operands[k]
                    pw = pshape(o)
                    shift1 = rb.lb[1] - o.type.bounds.lb[1]
                    for row in rows:
                        if (k, (off0, off2), row) in names:
                            continue
                        name = f"x{k}_{g}_{_tag(row)}"
                        expr = f"{buf(o)}[r{k}_{_tag(off0)} + b{k} + {row * pw[1] + off2}]"
                        if a_last + shift1 + row >= pw[0]:  # past a ragged chunk's plane
                            expr = f"(a < {pw[0] - shift1 - row}) ? {expr} : 0.0f"
                        lines.append(f"    const float {name} = {expr};")
                        names[(k, (off0, off2), row)] = name
                return lines

            def index(d, rb=rb):
                return (
                    f"static_cast<float>(t{d} + i{d}) + "
                    f"{_k1._f32_literal(float(rb.lb[d]))}"
                )

            def store(k, v, row, op=op, mask=mask):
                res = op.results[k]
                if res in st.direct:
                    return " ".join(
                        f"out{e}[{_global_index(res.type.bounds.shape)}] = {v};"
                        for e, x in enumerate(escapes) if x is res
                    )
                if mask is not None and box_of(mask):
                    return f"{buf(mask.results[0])}[w + p] = ({mask_point(mask, row)}) ? {v} : 0.0f;"
                return f"{buf(res)}[w{k if k else ''} + p] = {v};"

            def point(j, op=op, names=names, index=index, store=store) -> list:
                def load(k, offset):
                    return names[(k, (offset[0], offset[2]), j + offset[1])]

                return _k1.emit_body(op, load, index, lambda k, v: store(k, v, j),
                                     indent="      ")

            skip = _outside_owned(plan, rb) if r0 in st.direct else None
            extra = [f"  const int w{k} = {ring(x, 'i0')};"
                     for k, x in enumerate(op.results) if k and x in st.slot_of]
            lines = pre + extra + walk(r0, column, point, skip)
            copies = []
            for k, x in enumerate(op.results):
                if x in escapes and x not in st.direct:
                    copies += copy_out(x, f"w{k if k else ''}")
            if copies and early:
                copies = ["  if (i0 >= 0) {"] + ["  " + x for x in copies] + ["  }"]
            phase = [f"  // op {n}: stencil.apply, planes {pshape(r0)} at lag {lag[r0]}"
                     + (f", then op {n + 1}'s mask" if mask is not None else "")
                     + (f", dim-0 taps of {sorted(queued)} in registers" if queued else "")]
            phase += at_plane(r0, lines + copies, early)
        else:  # comm.boundary_mask
            x, res = op.temp, op.results[0]
            lines = []
            if not any(m is op for m in mask_of.values()):
                xp = f"{buf(x)}[wx + p]"
                if box_of(op):
                    lines = walk(res, lambda a_last, op=op: mask_column(op),
                                 lambda j, op=op, xp=xp: [
                                     f"      {buf(res)}[w + p] = ({mask_point(op, j)}) ? {xp} : 0.0f;"])
                elif st.slot_of[res] != st.slot_of[x]:
                    lines = walk(res, no_column, lambda j, xp=xp: [f"      {buf(res)}[w + p] = {xp};"])
                if lines:
                    lines = [f"  const int wx = {ring(x, 'i0')};"] + lines
            if res in escapes:
                lines += copy_out(res)
            if lines:
                phase = [f"  // op {n}: comm.boundary_mask"] + at_plane(res, lines)
        if phase:
            body += phase + ["  __syncthreads();"]
    if plan.prefetch and body:
        body.pop()  # the next iteration's barrier comes before its loads
    src[loop:loop] = decls
    src += ["  " + line for line in body]
    src += ["  }", "  K1_CP_ASYNC_WAIT(0);"]
    return src


# --------------------------------------------------------------------------
# Entry point
# --------------------------------------------------------------------------

# fused op -> {(tile, pointer alignment, scratch forced, stream): _Kernel}: a time
# loop launches the same epoch at the same tile every call, so its source
# is emitted once
_BOUND: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


@dataclasses.dataclass
class _Kernel:
    fn: Callable          # the launcher
    plan: TilePlan
    source: str
    scratch_floats: int   # floats of one CTA's scratch (scratch plans)
    per_sm: dict = dataclasses.field(default_factory=dict)  # device -> resident CTAs an SM

    def ctas(self, dev: torch.device, work: int) -> int:
        """A scratch plan's grid on ``dev``: the CTAs that can reside at
        once (the occupancy query times the SMs), at most the plan's and
        at most ``work``, the (slot, tile) pairs."""
        per_sm = self.per_sm.get(dev)
        if per_sm is None:
            with torch.cuda.device(dev):
                per_sm = self.per_sm[dev] = _k1.ctas_per_sm(self.source, _OCCUPANCY)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        return max(1, min(self.plan.ctas, per_sm * sms, work))


def _kernel_for(fused_op: stencil.FusedEpochOp, tile: Optional[tuple], ptr_align: int = 16,
                scratch: bool = False, stream=None) -> _Kernel:
    key = (tile, ptr_align, scratch, stream)
    with _k1._LIBS_LOCK:
        per_op = _BOUND.setdefault(fused_op, {})
        kernel = per_op.get(key)
    if kernel is None:
        plan = plan_epoch(fused_op, tile, scratch, stream)
        source = emit_epoch_cuda(fused_op, tile, ptr_align, scratch, stream)
        _graphs.register(source, fused_op)
        n_ptrs = len(fused_op.operands) + len(fused_op.results)
        n_ints = 2 * len(set(_box_keys(fused_op).values())) + 1  # the boxes, the slots
        argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
        if plan.ctas:
            argtypes += [ctypes.c_void_p, ctypes.c_int]  # the scratch, the CTAs
        fn = _k1._launcher(source, argtypes + [ctypes.c_void_p], _LAUNCHER)
        kernel = _Kernel(fn, plan, source, _storage(fused_op, plan).scratch_floats)
        with _k1._LIBS_LOCK:
            per_op[key] = kernel
    return kernel


def run_epoch_cuda(
    fused_op: stencil.FusedEpochOp,
    arrays: Sequence[torch.Tensor],
    masks: Optional[Sequence[torch.Tensor]],
    tile: Optional[Sequence[int]] = None,
    coords=None,
    out: Optional[Sequence[Optional[torch.Tensor]]] = None,
    scratch: bool = False,
    stream=None,
) -> list:
    """Entry point used by the lowering's ``cuda`` backend: one fused epoch
    on the rank at mesh coordinate ``coords`` (a mesh axis name → its
    coordinate; all zeros by default, as on one device).  ``out`` gives,
    per escape, a contiguous tensor to write it into (``None``: a new
    one), which must not overlap an operand.  The operands may be
    ``[B, *bounds]`` slot pools (one ``B`` for all): the escapes then are
    too, and one launch computes every slot.

    CPU tensors go through the plain version, with ``masks`` (one keep
    tensor per boundary_mask, built by :func:`region_masks` at ``coords``
    when None); CUDA tensors go through the kernel, or the call raises.
    The kernel takes each mask's box at ``coords`` as launch arguments
    (:func:`box_args`) and tests every point against it, so on the card
    ``masks`` must be None.  ``tile`` overrides the default plan;
    ``scratch`` forces a scratch plan, ``stream`` a streaming plan or
    none (:func:`plan_epoch`).  A scratch
    plan's launch takes a scratch of device memory, allocated here.  Each
    call counts in ``dispatch_stats().fused_epoch_calls``, each launch in
    ``fused_epoch_launches``."""
    _DISPATCH.fused_epoch_calls += 1
    if not fused_op.results:
        return []
    args = fused_op.body.args
    if len(arrays) != len(args):
        raise ValueError(f"{len(arrays)} tensors for a fused epoch of {len(args)} operands")
    if not arrays:
        raise ValueError("a fused epoch without operands has no device to run on")
    dev = arrays[0].device
    slots, shapes = _k1.split_slots(arrays, args[0].type.bounds.rank, "K2 operands")
    lead = () if slots is None else (slots,)
    for k, (a, shape, arg) in enumerate(zip(arrays, shapes, args)):
        if a.device != dev:
            raise ValueError(f"operand {k} on {a.device}, operand 0 on {dev}")
        if a.dtype != torch.float32:
            raise TypeError(f"operand {k} is {a.dtype}; K2 takes float32")
        if shape != tuple(arg.type.bounds.shape):
            raise ValueError(
                f"operand {k}: tensor shape {shape} != its bounds' "
                f"shape {tuple(arg.type.bounds.shape)}"
            )
    tile = None if tile is None else tuple(int(t) for t in tile)
    if stream is not None and not isinstance(stream, bool):
        stream = tuple(int(t) for t in stream)
    out = list(out) if out is not None else [None] * len(fused_op.results)
    if len(out) != len(fused_op.results):
        raise ValueError(f"{len(out)} out tensors for an epoch of {len(fused_op.results)} escapes")
    for j, (o, r) in enumerate(zip(out, fused_op.results)):
        if o is not None and (o.device != dev or o.dtype != torch.float32 or not o.is_contiguous()
                              or tuple(o.shape) != lead + tuple(r.type.bounds.shape)):
            raise ValueError(
                f"out {j}: expected a contiguous float32 tensor of shape "
                f"{lead + tuple(r.type.bounds.shape)} on {dev}"
            )
    with _obs.span("cuda:fused_epoch", cat="kernel", rank=None, device=dev.type):
        if dev.type == "cpu":
            if tile is not None or scratch or stream is not None:
                plan_epoch(fused_op, tile, scratch, stream)  # refuse what the kernel would refuse
            if masks is None:
                masks = region_masks(fused_op, dev, coords)
            if len(masks) != len(_mask_ops(fused_op)):
                raise ValueError(
                    f"{len(masks)} masks for {len(_mask_ops(fused_op))} boundary masks"
                )
            from repro_torch.core.lowering import write_into

            return write_into(_emit_region(fused_op, list(arrays), masks, lambda v: v.type.bounds),
                              out)
        if dev.type != "cuda":
            raise ValueError(f"K2 runs on CUDA or (plain version) CPU, not {dev}")
        if masks is not None:
            raise ValueError(
                "K2 takes each boundary mask's box as launch arguments: pass "
                "masks=None (and the rank's coords) for CUDA tensors"
            )
        for k, a in enumerate(arrays):
            if not a.is_contiguous():
                raise ValueError(f"operand {k} is not contiguous")
        outs = [
            torch.empty(lead + tuple(r.type.bounds.shape), dtype=torch.float32, device=dev)
            if o is None else o
            for r, o in zip(fused_op.results, out)
        ]
        kernel = _kernel_for(fused_op, tile, _k1.ptr_alignment(arrays, len(shapes[0])), scratch,
                             stream)
        grid = []
        if kernel.plan.ctas:
            ctas = kernel.ctas(dev, (slots or 1) * kernel.plan.n_tiles)
            # stream-ordered: the allocator reuses it only after this launch
            buf = torch.empty(max(1, ctas * kernel.scratch_floats), dtype=torch.float32,
                              device=dev)
            grid = [buf.data_ptr(), ctas]
        with torch.cuda.device(dev):
            cuda_stream = torch.cuda.current_stream(dev).cuda_stream
            status = kernel.fn(
                *[a.data_ptr() for a in arrays], *[o.data_ptr() for o in outs],
                *box_args(fused_op, coords), slots or 1, *grid, cuda_stream,
            )
        if status != 0:
            raise RuntimeError(f"K2 launch failed with CUDA error {status}")
        _DISPATCH.fused_epoch_launches += 1
    return outs
