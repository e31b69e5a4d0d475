"""Kernel K2: one ``stencil.fused_epoch`` as a hand-written CUDA kernel for Hopper.

Replaces the Pallas TPU kernel ``repro/kernels/epoch_kernel.py:
build_epoch_kernel`` (its whole-shard and tiled ``pl.pallas_call``s; entry
``run_epoch_pallas``).  It computes what that kernel computes: the k
unrolled applies of a deep-halo epoch with ``comm.boundary_mask``
re-zeroing between them, returning the region's escapes, while every
intermediate frame stays on chip.

Design: one mode, tiled (overlapped temporal blocking).

- The *core* is the intersection of the escapes' bounds (the rank's core
  on fig 7).  The grid runs over tiles of the core, one CTA per tile; the
  tile divides the core.
- Every region value has a *window* per tile: the tile grown by the
  value's overhang beyond the core (the reference's ``_rel_bounds``).  The
  CTA loads each operand's window from device memory into shared memory;
  each sub-step computes its shrinking frame from shared memory into
  shared memory, then its mask zeroes the points outside the box.  Shared
  memory is given out by liveness: a buffer is reused once its last
  reader has run, and a mask works in place when its input dies with it.
- Only escapes reach device memory.  An escape larger than the core, such
  as wave's carried state over [-r, n+r), is written by the edge tiles:
  each writes the overhang on its own side from the window it already
  holds, so every point is written by exactly one CTA.  An apply result
  that escapes and is read by nothing else in the region is written to
  device memory straight from the apply.
- ``stencil.index`` reads the tile's global origin.

This one mode replaces the reference's whole-shard mode, which the
reference took whenever the escapes differ in bounds (wave) or a sub-step
uses ``stencil.index`` (a Pallas block has no logical coordinates); a
whole shard has no one-block analogue at 16384².  Rejected: a cooperative
kernel with a grid-wide sync between sub-steps.  Each sub-step's whole
frame would go to device memory and back (the k round trips of the
unfused path), and a cooperative launch caps the grid at the CTAs that fit
on the card at once.

Masks: on one device the keep mask of a ``boundary_mask`` is a box
(``core.lowering.keep_box``).  The kernel tests that box from coordinates;
the plain version reads 0/1 arrays built outside the kernel
(:func:`region_masks`), as the reference's kernel does.

Tile size: :func:`choose_tile` replaces the reference's 4 MiB VMEM budget.
It takes the largest tile (from 4096, 64×64 or 8×8×32, cut to divisors of
the core) whose shared memory lets two CTAs share one SM, and shrinks the
major dimension first; 227 KB a CTA is the hard limit.  If no tile fits,
the wrapper raises; it never falls back to something else.

What bounds it on an H100: device-memory bytes.  Per epoch the least work
is to read each operand once and write each escape once (heat so4 k=4 at
16384²: 2.15 GB, 0.64 ms at 3.35 TB/s).  Here a tile re-reads its
neighbours' halo (80²/64² = 1.56× for heat so4 k=4 at 64² tiles) and
recomputes their frame overlap; loads and compute are phases separated by
``__syncthreads`` (no TMA, no double buffering yet).

Bitwise: the point function is emitted by K1's ``emit_body`` (one float32
statement per IR op in body order, constants as bit patterns) and built
with ``-fmad=false``, so K2 equals its plain version, the unfused K1
route and the torch backend bit for bit.
"""
from __future__ import annotations

import dataclasses
import itertools
import weakref
from typing import Optional, Sequence

import torch

from repro_torch.core.dialects import comm, stencil
from repro_torch.kernels import _DISPATCH
from repro_torch.kernels import stencil_apply as _k1
from repro_torch.obs import trace as _obs

THREADS = 256
SMEM_PER_BLOCK = 232448  # 227 KB: the most one CTA may opt in to on an H100
SMEM_PER_SM = 233472     # 228 KB per SM, of which each resident CTA reserves 1 KB
SMEM_TWO_BLOCKS = SMEM_PER_SM // 2 - 1024  # the budget for two CTAs on one SM
DEFAULT_TILE = {1: (4096,), 2: (64, 64), 3: (8, 8, 32)}
_LAUNCHER = "k2_epoch_launch"


# --------------------------------------------------------------------------
# The plain version
# --------------------------------------------------------------------------


def _mask_ops(fused_op: stencil.FusedEpochOp) -> list:
    return [op for op in fused_op.body.ops if isinstance(op, comm.BoundaryMaskOp)]


def _emit_region(fused_op, inputs, masks, bounds_of) -> list:
    """Evaluate the fused region over tensors: K2's plain version.
    ``bounds_of`` maps a region value to the logical bounds its tensor
    covers (the value's own bounds for a whole shard, a tile's window for
    one tile); ``masks`` holds one 0/1 tensor per boundary_mask, in region
    order, over the masked tensor."""
    from repro_torch.core.lowering import eval_apply_body

    env = dict(zip(fused_op.body.args, inputs))
    device = inputs[0].device if inputs else None
    mask_idx = 0
    for op in fused_op.body.ops:
        if isinstance(op, stencil.ApplyOp):
            arrays = [env[o] for o in op.operands]
            origins = [bounds_of(o).lb for o in op.operands]
            outs = eval_apply_body(
                op, arrays, origins, bounds_of(op.results[0]), device=device
            )
            for res, val in zip(op.results, outs):
                env[res] = val
        elif isinstance(op, comm.BoundaryMaskOp):
            mask = masks[mask_idx]
            mask_idx += 1
            x = env[op.temp]
            zero = torch.zeros((), dtype=x.dtype, device=x.device)
            env[op.results[0]] = torch.where(mask != 0, x, zero)
        elif isinstance(op, stencil.FusedYieldOp):
            return [env[o] for o in op.operands]
        else:  # pragma: no cover - FusedEpochOp.verify_ rejects these
            raise NotImplementedError(f"fused region op {op.name}")
    raise AssertionError("fused_epoch region missing stencil.fused_yield")


def region_masks(fused_op: stencil.FusedEpochOp, device) -> list:
    """One 0/1 float32 keep-mask per boundary_mask of the region, in region
    order, over the masked value's whole bounds: the plain version's
    mask inputs."""
    from repro_torch.core.lowering import boundary_keep

    out = []
    for op in _mask_ops(fused_op):
        shape = tuple(op.temp.type.bounds.shape)
        keep = boundary_keep(op, shape, device)
        if keep is None:
            out.append(torch.ones(shape, dtype=torch.float32, device=device))
        else:
            out.append(torch.broadcast_to(keep, shape).to(torch.float32))
    return out


# --------------------------------------------------------------------------
# The tile plan
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """How K2 cuts one fused epoch into CTAs.  ``core`` is the intersection
    of the escapes' bounds, ``tile`` divides it, ``grid`` counts tiles per
    dim (CTA ``blockIdx.x`` walks them row-major, the last dim fastest)."""

    core: stencil.Bounds
    tile: tuple
    grid: tuple

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


def _divisor_at_most(n: int, limit: int) -> int:
    for d in range(min(n, limit), 0, -1):
        if n % d == 0:
            return d
    return 1


def choose_tile(fused_op: stencil.FusedEpochOp) -> tuple:
    """The tile K2 takes by default: start from ``DEFAULT_TILE`` cut to
    divisors of the core and shrink the largest dimension (the major one
    on a tie) until the shared memory lets two CTAs share an SM, or else
    one CTA hold it (227 KB); raise if even one point per tile is more."""
    core = _core(fused_op)
    start = [
        _divisor_at_most(n, t) for n, t in zip(core.shape, DEFAULT_TILE[core.rank])
    ]

    def smem(tile) -> int:
        return _storage(fused_op, _plan(core, tuple(tile))).smem_bytes

    for budget in (SMEM_TWO_BLOCKS, SMEM_PER_BLOCK):
        tile = list(start)
        while smem(tile) > budget and any(t > 1 for t in tile):
            d = max(range(len(tile)), key=lambda k: (tile[k], -k))
            tile[d] = _divisor_at_most(core.shape[d], tile[d] - 1)
        if smem(tile) <= budget:
            return tuple(tile)
    raise ValueError(
        f"K2 needs {smem(tile)} bytes of shared memory even for a tile of one "
        f"point, more than the {SMEM_PER_BLOCK} a CTA may use"
    )


def _plan(core: stencil.Bounds, tile: tuple) -> TilePlan:
    return TilePlan(core, tile, tuple(n // t for n, t in zip(core.shape, tile)))


def plan_epoch(fused_op: stencil.FusedEpochOp, tile: Optional[Sequence[int]] = None) -> TilePlan:
    """K2's tile plan for ``fused_op``: ``tile`` if given (it must divide
    the core and fit in 227 KB of shared memory), else :func:`choose_tile`."""
    core = _core(fused_op)
    if tile is None:
        return _plan(core, choose_tile(fused_op))
    tile = tuple(int(t) for t in tile)
    if len(tile) != core.rank or any(
        t < 1 or n % t for n, t in zip(core.shape, tile)
    ):
        raise ValueError(
            f"tile {tile} does not divide the epoch's core {core.shape}"
        )
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
# Shared memory, by liveness
# --------------------------------------------------------------------------


@dataclasses.dataclass
class _Storage:
    slot_of: dict  # region value -> shared-memory buffer index
    direct: set    # escapes an apply writes straight to device memory
    slot_floats: list

    @property
    def smem_bytes(self) -> int:
        return 4 * sum(self.slot_floats)

    def offsets(self) -> list:
        out, acc = [], 0
        for n in self.slot_floats:
            out.append(acc)
            acc += n
        return out


def _storage(fused_op: stencil.FusedEpochOp, plan: TilePlan) -> _Storage:
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


# --------------------------------------------------------------------------
# Code generation
# --------------------------------------------------------------------------


def _coords(shape: tuple, indent: str) -> list:
    """``i0 … i{r-1}``: the coordinates of flat point ``p`` in a window."""
    out = []
    for d in range(len(shape)):
        inner = 1
        for w in shape[d + 1:]:
            inner *= w
        q = "p" if inner == 1 else f"(p / {inner})"
        out.append(f"{indent}const int i{d} = {q}" + ("" if d == 0 else f" % {shape[d]}") + ";")
    return out


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


def emit_epoch_cuda(fused_op: stencil.FusedEpochOp, tile: Optional[Sequence[int]] = None) -> str:
    """CUDA C++ source of K2 for one fused epoch at one tile: a
    ``__global__`` kernel with one CTA per tile and the C launcher
    ``k2_epoch_launch(in0, …, out0, …, stream) -> cudaError_t``."""
    from repro_torch.core.lowering import keep_box

    plan = plan_epoch(fused_op, tile)
    st = _storage(fused_op, plan)
    offsets = st.offsets()
    rank = plan.core.rank
    args = list(fused_op.body.args)
    escapes = _escapes(fused_op)
    n_in, n_out = len(args), len(escapes)
    smem = st.smem_bytes

    def wshape(v) -> tuple:
        return plan.window_shape(v.type.bounds)

    def npoints(v) -> int:
        n = 1
        for w in wshape(v):
            n *= w
        return n

    def buf(v) -> str:
        return f"s{st.slot_of[v]}"

    src = [
        "// Generated by repro_torch/kernels/epoch_kernel.py (kernel K2).",
        f"// core {plan.core.lb}..{plan.core.ub}, tile {plan.tile}, grid "
        f"{plan.grid} ({plan.n_tiles} CTAs), {smem} bytes of shared memory",
    ]
    for k, a in enumerate(args):
        src.append(f"// in{k}: bounds {a.type.bounds.lb}..{a.type.bounds.ub}, window {wshape(a)}")
    for j, e in enumerate(escapes):
        src.append(f"// out{j}: bounds {e.type.bounds.lb}..{e.type.bounds.ub}")
    src += [f'#include "{_k1._HEADER}"', "", f"constexpr int kThreads = {THREADS};", ""]
    params = [f"const float* __restrict__ in{k}" for k in range(n_in)] + [
        f"float* __restrict__ out{j}" for j in range(n_out)
    ]
    src.append(
        "__global__ void __launch_bounds__(kThreads) k2_epoch("
        + ", ".join(params) + ") {"
    )
    src.append("  extern __shared__ float smem[];")
    for s, off in enumerate(offsets):
        src.append(f"  float* const s{s} = smem + {off};")
    # this CTA's tile: its index along each dim and its core-relative
    # origin (32-bit: a core extent fits; device offsets are 64-bit)
    src.append("  int blk = blockIdx.x;")
    for d in reversed(range(rank)):
        src.append(f"  const int g{d} = blk % {plan.grid[d]};")
        if d:
            src.append(f"  blk /= {plan.grid[d]};")
    for d in range(rank):
        src.append(f"  const int t{d} = g{d} * {plan.tile[d]};")
        src.append(f"  const bool first{d} = g{d} == 0;")
        src.append(f"  const bool last{d} = g{d} == {plan.grid[d] - 1};")
        src.append(f"  (void)first{d}; (void)last{d};")

    def loop(v, body: list, skip: Optional[str] = None, sync: bool = True) -> list:
        lines = [f"  for (int p = threadIdx.x; p < {npoints(v)}; p += kThreads) {{"]
        lines += _coords(wshape(v), "    ")
        if skip:
            lines.append(f"    if ({skip}) continue;")
        return lines + body + ["  }"] + (["  __syncthreads();"] if sync else [])

    def keep_test(mask_op) -> Optional[str]:
        """C condition true where a boundary_mask keeps the point (None
        when it keeps every point): its box, from the tile's coordinates."""
        vb = mask_op.temp.type.bounds
        box = keep_box(mask_op)
        return " && ".join(
            f"t{d} + i{d} >= {lo - vb.lb[d]} && t{d} + i{d} < {hi - vb.lb[d]}"
            for d, (lo, hi) in sorted(box.items())
        ) or None

    # a mask that is the only reader of an apply's result is applied as the
    # apply writes its frame, into the buffer the two share
    readers: dict = {}
    for op in fused_op.body.ops:
        for o in op.operands:
            readers.setdefault(o, []).append(op)
    mask_of = {}
    for op in fused_op.body.ops:
        if isinstance(op, stencil.ApplyOp) and len(op.results) == 1:
            rd = readers.get(op.results[0], [])
            if len(rd) == 1 and isinstance(rd[0], comm.BoundaryMaskOp):
                mask_of[op] = rd[0]

    def copy_out(v) -> list:
        body = [
            f"    out{j}[{_global_index(e.type.bounds.shape)}] = {buf(v)}[p];"
            for j, e in enumerate(escapes) if e is v
        ]
        return loop(v, body, _outside_owned(plan, v.type.bounds))

    # every operand's window, device memory -> shared memory
    for k, a in enumerate(args):
        src.append(f"  // load in{k}")
        src += loop(
            a,
            [f"    {buf(a)}[p] = in{k}[{_global_index(a.type.bounds.shape)}];"],
            sync=k == len(args) - 1,
        )
    for n, op in enumerate(fused_op.body.ops[:-1]):
        if isinstance(op, stencil.ApplyOp):
            r0 = op.results[0]
            rb = r0.type.bounds
            mask = mask_of.get(op)
            src.append(
                f"  // op {n}: stencil.apply, window {wshape(r0)}"
                + (f", then op {n + 1}'s mask" if mask is not None else "")
            )
            body = []
            for k in sorted(op.access_extents()):
                o = op.operands[k]
                ow = wshape(o)
                ostr = _k1._strides(ow)
                shift = [r - l for r, l in zip(rb.lb, o.type.bounds.lb)]
                terms = " + ".join(f"(i{d} + {shift[d]}) * {ostr[d]}" for d in range(rank))
                body.append(f"    const int b{k} = {terms};")

            def load(k, offset, op=op):
                ostr = _k1._strides(wshape(op.operands[k]))
                flat = sum(o * s for o, s in zip(offset, ostr))
                return f"{buf(op.operands[k])}[b{k} + ({flat})]"

            def index(d, rb=rb):
                return (
                    f"static_cast<float>(t{d} + i{d}) + "
                    f"{_k1._f32_literal(float(rb.lb[d]))}"
                )

            def store(j, v, op=op, mask=mask):
                r = op.results[j]
                if r in st.direct:
                    return " ".join(
                        f"out{e}[{_global_index(r.type.bounds.shape)}] = {v};"
                        for e, x in enumerate(escapes) if x is r
                    )
                if mask is not None and keep_test(mask):
                    return f"{buf(mask.results[0])}[p] = ({keep_test(mask)}) ? {v} : 0.0f;"
                return f"{buf(r)}[p] = {v};"

            body += _k1.emit_body(op, load, index, store, indent="    ")
            skip = _outside_owned(plan, rb) if r0 in st.direct else None
            src += loop(r0, body, skip)
            for r in op.results:
                if r in escapes and r not in st.direct:
                    src.append(f"  // escape of op {n}")
                    src += copy_out(r)
        else:  # comm.boundary_mask
            x, r = op.temp, op.results[0]
            fused = any(m is op for m in mask_of.values())
            if not fused:
                src.append(f"  // op {n}: comm.boundary_mask, keep {keep_box(op)}")
                keep = keep_test(op)
                if keep:
                    src += loop(r, [f"    {buf(r)}[p] = ({keep}) ? {buf(x)}[p] : 0.0f;"])
                elif st.slot_of[r] != st.slot_of[x]:
                    src += loop(r, [f"    {buf(r)}[p] = {buf(x)}[p];"])
            if r in escapes:
                src.append(f"  // escape of op {n}")
                src += copy_out(r)
    if src[-1] == "  __syncthreads();":
        src.pop()  # nothing follows the last phase
    src += ["}", ""]

    c_params = [f"const void* in{k}" for k in range(n_in)] + [
        f"void* out{j}" for j in range(n_out)
    ]
    call_args = [f"static_cast<const float*>(in{k})" for k in range(n_in)] + [
        f"static_cast<float*>(out{j})" for j in range(n_out)
    ]
    src.append(f"K1_EXPORT int {_LAUNCHER}(" + ", ".join(c_params + ["void* stream"]) + ") {")
    if smem > 48 * 1024:
        src += [
            "  const cudaError_t attr = cudaFuncSetAttribute(",
            f"      k2_epoch, cudaFuncAttributeMaxDynamicSharedMemorySize, {smem});",
            "  if (attr != cudaSuccess) return static_cast<int>(attr);",
        ]
    src += [
        f"  k2_epoch<<<{plan.n_tiles}u, kThreads, {smem}, static_cast<cudaStream_t>(stream)>>>(",
        "      " + ", ".join(call_args) + ");",
        "  return k1::launch_status();",
        "}",
        "",
    ]
    return "\n".join(src)


# --------------------------------------------------------------------------
# Entry point
# --------------------------------------------------------------------------

# fused op -> {tile: launcher}: a time loop launches the same epoch at the
# same tile every call, so its source is emitted once
_BOUND: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _kernel_for(fused_op: stencil.FusedEpochOp, tile: Optional[tuple]):
    with _k1._LIBS_LOCK:
        per_op = _BOUND.setdefault(fused_op, {})
        fn = per_op.get(tile)
    if fn is None:
        source = emit_epoch_cuda(fused_op, tile)
        n_args = len(fused_op.operands) + len(fused_op.results) + 1
        fn = _k1._launcher(source, n_args, _LAUNCHER)
        with _k1._LIBS_LOCK:
            per_op[tile] = fn
    return fn


def run_epoch_cuda(
    fused_op: stencil.FusedEpochOp,
    arrays: Sequence[torch.Tensor],
    masks: Optional[Sequence[torch.Tensor]],
    tile: Optional[Sequence[int]] = None,
) -> list:
    """Entry point used by the lowering's ``cuda`` backend: one fused epoch.

    CPU tensors go through the plain version, with ``masks`` (one 0/1
    tensor per boundary_mask, built by :func:`region_masks` when None);
    CUDA tensors go through the kernel, or the call raises.  The kernel
    tests each mask's box from coordinates, so on the card ``masks`` must
    be None.  ``tile`` overrides :func:`choose_tile`.  Each call counts in
    ``dispatch_stats().fused_epoch_calls``, each launch in
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
    for k, (a, arg) in enumerate(zip(arrays, args)):
        if a.device != dev:
            raise ValueError(f"operand {k} on {a.device}, operand 0 on {dev}")
        if a.dtype != torch.float32:
            raise TypeError(f"operand {k} is {a.dtype}; K2 takes float32")
        if tuple(a.shape) != tuple(arg.type.bounds.shape):
            raise ValueError(
                f"operand {k}: tensor shape {tuple(a.shape)} != its bounds' "
                f"shape {tuple(arg.type.bounds.shape)}"
            )
    tile = None if tile is None else tuple(int(t) for t in tile)
    with _obs.span("cuda:fused_epoch", cat="kernel", rank=None, device=dev.type):
        if dev.type == "cpu":
            if tile is not None:
                plan_epoch(fused_op, tile)  # refuse what the kernel would refuse
            if masks is None:
                masks = region_masks(fused_op, dev)
            if len(masks) != len(_mask_ops(fused_op)):
                raise ValueError(
                    f"{len(masks)} masks for {len(_mask_ops(fused_op))} boundary masks"
                )
            return _emit_region(fused_op, list(arrays), masks, lambda v: v.type.bounds)
        if dev.type != "cuda":
            raise ValueError(f"K2 runs on CUDA or (plain version) CPU, not {dev}")
        if masks is not None:
            raise ValueError(
                "K2 tests each boundary mask's box from coordinates: pass "
                "masks=None for CUDA tensors"
            )
        for k, a in enumerate(arrays):
            if not a.is_contiguous():
                raise ValueError(f"operand {k} is not contiguous")
        outs = [
            torch.empty(r.type.bounds.shape, dtype=torch.float32, device=dev)
            for r in fused_op.results
        ]
        fn = _kernel_for(fused_op, tile)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            status = fn(
                *[a.data_ptr() for a in arrays], *[o.data_ptr() for o in outs], stream
            )
        if status != 0:
            raise RuntimeError(f"K2 launch failed with CUDA error {status}")
        _DISPATCH.fused_epoch_launches += 1
    return outs
