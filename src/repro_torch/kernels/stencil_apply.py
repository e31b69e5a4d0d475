"""Kernel K1: one ``stencil.apply`` as a hand-written CUDA kernel for Hopper.

Replaces the Pallas TPU kernel ``repro/kernels/stencil_apply.py:
build_apply_kernel`` (its ``pl.pallas_call``; entry ``run_apply_pallas``).
It computes what that kernel computes — the apply's point-function DAG at
every point of the result bounds, one or more float32 results — but is not
carried over block by block: there is no VMEM window and no tile budget.

Code generation.  :func:`emit_apply_cuda` turns one apply, at one set of
operand shapes and origins, into CUDA C++.  A CTA owns a tile of the
minor dims (256 columns in 2D, 8×32 of a plane in 3D; rank 1 runs as rank
2 with one row) and a chunk of 64 rows along dim 0, and streams down the
chunk in steps of 8 rows (1 in 1D).  Each accessed operand's
slice at each row (the tile plus that operand's access extent) is staged
by ``cp.async`` into a ring of shared-memory slices: those one step
reads, two steps of prefetch (one where two would leave room for fewer
than three CTAs an SM), so copies run ahead of compute, and the step
being refilled; one barrier a step hands slots back.  Each thread
owns one point of the tile, a column of the step's rows, and reads its
taps from the ring, so no tap is re-read from L1/L2; the rows of taps
that differ only along dim 0 are read once a step into registers
(heat so4: 5.5 shared-memory reads a point instead of 9).  The edges are
predicated: the tile need not divide the result, and any operand origin
works (grown frames, interior parts, several operands and results).
Offsets into device memory are 64-bit.  The DAG is emitted in body order
with one float32 operation per IR op and constants as exact bit patterns;
shapes, strides and offsets are baked in as constants.  The kernel is
built with ``-fmad=false`` so that ``a*b+c`` stays two rounded
operations, as the plain version (``core.lowering.eval_apply_body``)
computes it: on the card the two agree bitwise for ``+ - * /`` programs
such as heat and wave.

What bounds it on an H100: device-memory bytes.  Per call the least work
is to read each operand once and write each result once (a few float32
operations per byte, far below the card's balance point).  Each CTA
re-reads its neighbours' halo columns and the chunk's halo rows (from L2
mostly): a 3-D 8×32 tile stages 12×36-float slices for so4, 1.69× the
tile.  With one shared-memory read a tap and one barrier a row the
kernel was bound by shared memory at so8 (PERF.md); the 8-row
steps cut the reads to 5.5 a point for heat so4, 10 for so8.

Slot pools.  The launch takes a slot count ``B``: the grid is ``B`` times
one call's CTAs, the slot is ``blockIdx.x``'s slowest index, and every
operand and result pointer moves by that slot's stride (the serving
engine's ``[B, *shape]`` pools; the port's counterpart of ``jax.vmap`` of
the reference's kernel, which adds a grid axis over the slots).  Operands
are contiguous, so their slot stride is their size, baked into the
source; a result's slot stride is a launch argument, because a result
that is a slice of a combine's result strides by that result's size.
``B`` is an argument too, so one build serves every pool width; the
per-point arithmetic is unchanged, so each slot equals a launch of its
own bit for bit.

Build.  ``nvcc`` (found on ``PATH``, then under ``$CUDA_HOME/bin``, then
``/usr/local/cuda/bin``) compiles each generated source into
``build/repro_torch_kernels/<sha>.so`` at the repository root, with a
plain C launcher loaded through ``ctypes``.  Builds are cached on disk and
in the process; :func:`build` compiles many sources in parallel.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import struct
import subprocess
import threading
import weakref
from pathlib import Path
from typing import Callable, Optional, Sequence

import torch

from repro_torch.core import ir
from repro_torch.core.dialects import stencil
from repro_torch.kernels import _DISPATCH, graphs

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-fmad=false", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
_HEADER = "stencil_apply_common.cuh"
_LAUNCHER = "k1_apply_launch"
_OCCUPANCY = "k1_apply_occupancy"

# --------------------------------------------------------------------------
# Code generation
# --------------------------------------------------------------------------

_BINARY_SYMBOL = {ir.AddOp: "+", ir.SubOp: "-", ir.MulOp: "*", ir.DivOp: "/"}
_UNARY_FORMAT = {
    ir.NegOp: "-{}",
    ir.AbsOp: "fabsf({})",
    ir.SqrtOp: "sqrtf({})",
    ir.ExpOp: "expf({})",
}


def _strides(shape: Sequence[int]) -> tuple:
    out, acc = [], 1
    for n in reversed(shape):
        out.append(acc)
        acc *= n
    return tuple(reversed(out))


def _f32_literal(value: float) -> str:
    """A float32 constant as its exact bit pattern (round to nearest)."""
    bits = struct.unpack("<I", struct.pack("<f", value))[0]
    return f"__int_as_float(0x{bits:08x}) /* {value!r} */"


def check_windows(
    apply_op: stencil.ApplyOp,
    operand_shapes: Sequence[tuple],
    operand_origins: Sequence[tuple],
    result_bounds: stencil.Bounds,
) -> None:
    """Raise unless every access window of ``apply_op`` lies inside its
    operand at both ends (the kernel's reads are unchecked)."""
    rb = result_bounds
    if len(operand_shapes) != len(apply_op.operands):
        raise ValueError(
            f"{len(operand_shapes)} operand tensors for an apply of "
            f"{len(apply_op.operands)} operands"
        )
    for k, (lo, hi) in apply_op.access_extents().items():
        shape, origin = operand_shapes[k], operand_origins[k]
        if len(shape) != rb.rank:
            raise ValueError(
                f"operand {k} has rank {len(shape)}, the result rank {rb.rank}"
            )
        first = tuple(l + o - g for l, o, g in zip(rb.lb, lo, origin))
        end = tuple(u + o - g for u, o, g in zip(rb.ub, hi, origin))
        if any(f < 0 for f in first) or any(e > n for e, n in zip(end, shape)):
            raise ValueError(
                f"operand {k}: the apply reads [{first}, {end}) of a tensor "
                f"of shape {tuple(shape)} (halo missing or origin wrong)"
            )


def emit_body(
    apply_op: stencil.ApplyOp,
    load: Callable[[int, tuple], str],
    index: Callable[[int], str],
    store: Callable[[int, str], str],
    indent: str,
) -> list:
    """The C statements of an apply's point function, shared by K1 and K2:
    one statement per IR op in body order, one float32 operation each,
    constants as exact bit patterns.  ``load(k, offset)`` is the C
    expression reading operand ``k`` at a constant offset from the point,
    ``index(d)`` the point's logical coordinate along ``d`` as a float, and
    ``store(j, v)`` the statement writing result ``j`` from variable ``v``.
    """
    lines: list = []
    names: dict = {}
    for n, op in enumerate(apply_op.body.ops):
        v = f"v{n}"
        if isinstance(op, stencil.StencilReturnOp):
            lines += [indent + store(j, names[o]) for j, o in enumerate(op.operands)]
            return lines
        if isinstance(op, stencil.AccessOp):
            expr = load(op.temp.index, tuple(op.offset))
        elif isinstance(op, stencil.IndexOp):
            expr = index(op.dim)
        elif isinstance(op, ir.ConstantOp):
            expr = _f32_literal(op.value)
        elif type(op) in _BINARY_SYMBOL:
            a, b = (names[o] for o in op.operands)
            expr = f"{a} {_BINARY_SYMBOL[type(op)]} {b}"
        elif type(op) in _UNARY_FORMAT:
            expr = _UNARY_FORMAT[type(op)].format(names[op.operands[0]])
        elif isinstance(op, ir.SelectGeZeroOp):
            pv, a, b = (names[o] for o in op.operands)
            expr = f"({pv} >= 0.0f) ? {a} : {b}"
        else:
            raise NotImplementedError(f"apply body op {op.name}")
        names[op.results[0]] = v
        lines.append(f"{indent}const float {v} = {expr};")
    raise AssertionError("apply body missing stencil.return")


def column_rows(apply_op: stencil.ApplyOp, rows: int, lifted: bool = False) -> dict:
    """The register-blocked column of one apply, shared by K1 and K2:
    ``{(operand, offset along the minor dims): [row, …]}``, each row
    (relative to the column's first point) loaded once into a register and
    read by every point of the column's ``rows`` whose tap falls on it.
    ``lifted``: a rank-1 apply computed as rank 2 with one row."""
    taps: dict = {}
    for x in apply_op.body.ops:
        if isinstance(x, stencil.AccessOp):
            off = ((0,) + tuple(x.offset)) if lifted else tuple(x.offset)
            taps.setdefault((x.temp.index, off[1:]), set()).add(off[0])
    return {
        key: sorted({j + o0 for j in range(rows) for o0 in s0})
        for key, s0 in sorted(taps.items())
    }


SLICE_TILE = {2: (256,), 3: (8, 32)}  # points of the minor dims one CTA owns
CHUNK_ROWS = 64  # dim-0 rows one CTA streams through
# rows of its column a thread computes between two barriers (one step),
# reading each dim-0 tap row once into a register; rank 1 has one row
ROWS_PER_STEP = {1: 1, 2: 8, 3: 8}
PREFETCH_STEPS = 2  # steps of slices in flight ahead of the step being computed
RING_BUDGET = 233472 // 3 - 1024  # rings that leave room for three CTAs an SM


@dataclasses.dataclass(frozen=True)
class SlicePlan:
    """How K1 stages one operand.  Everything is in the lifted frame (rank
    1 is computed as rank 2 with a leading dim of one row).  ``base`` is
    the array index of the operand's window start for result point 0,
    ``ext`` the access extent along each dim (``hi - lo``), ``width`` the
    floats per asynchronous copy, ``shift`` where the window starts inside
    the first copy of a slice row (``base[-1] % width``), ``row`` the
    floats a staged slice row holds (a multiple of ``width``), ``floats``
    those of one slice and ``offset`` the ring's first float in shared
    memory."""

    base: tuple
    ext: tuple
    width: int
    shift: int
    row: int
    floats: int
    offset: int


def _lift(apply_op, operand_shapes, operand_origins, result_bounds):
    """Shapes, origins, result bounds and per-operand extents with rank 1
    lifted to rank 2 (a leading dim of one row)."""
    extents = apply_op.access_extents()
    shapes = [tuple(s) for s in operand_shapes]
    origins = [tuple(o) for o in operand_origins]
    lb, ub = tuple(result_bounds.lb), tuple(result_bounds.ub)
    ext = {k: (tuple(lo), tuple(hi)) for k, (lo, hi) in extents.items()}
    if result_bounds.rank == 1:
        shapes = [(1,) + s for s in shapes]
        origins = [(0,) + o for o in origins]
        lb, ub = (0,) + lb, (1,) + ub
        ext = {k: ((0,) + lo, (0,) + hi) for k, (lo, hi) in ext.items()}
    return shapes, origins, stencil.Bounds(lb, ub), ext


def slice_plans(
    apply_op: stencil.ApplyOp,
    operand_shapes: Sequence[tuple],
    operand_origins: Sequence[tuple],
    result_bounds: stencil.Bounds,
    ptr_align: int = 16,
) -> dict:
    """K1's staging plan for every accessed operand: ``{k: SlicePlan}``.
    A CTA whose tile starts at result index ``u`` of the minor dims and
    whose chunk starts at row ``z`` stages, for slice ``q``, array row
    ``z + base[0] + q`` and, along each minor dim, the array range from
    ``u + base`` over the tile plus ``ext`` (the last dim widened to whole
    copies: down by ``shift``, up to a multiple of ``width``)."""
    shapes, origins, rb, ext = _lift(apply_op, operand_shapes, operand_origins, result_bounds)
    tile = SLICE_TILE[rb.rank]
    plans, offset = {}, 0
    for k in sorted(ext):
        lo, hi = ext[k]
        base = tuple(l + o - g for l, o, g in zip(rb.lb, lo, origins[k]))
        e = tuple(h - l for l, h in zip(lo, hi))
        width = copy_width((shapes[k][-1], tile[-1]), ptr_align)
        shift = base[-1] % width
        row = -(-(shift + tile[-1] + e[-1]) // width) * width
        floats = row * (tile[0] + e[1] if rb.rank == 3 else 1)
        plans[k] = SlicePlan(base, e, width, shift, row, floats, 0)
    _, _, depth = _ring(ext, ROWS_PER_STEP[result_bounds.rank], plans)
    for k, p in plans.items():
        plans[k] = dataclasses.replace(p, offset=offset)
        offset += (depth * p.floats + 3) // 4 * 4
    return plans


def copy_width(lengths: Sequence[int], ptr_align: int) -> int:
    """Floats per asynchronous copy, for K1's slices and K2's windows: the
    widest of 4, 2 and 1 that divides every length in ``lengths`` (row
    lengths and starts, in floats) and whose bytes the operand pointers'
    alignment ``ptr_align`` (bytes) allows."""
    return next(
        v for v in (4, 2, 1)
        if all(n % v == 0 for n in lengths) and ptr_align % (4 * v) == 0
    )


def _ring(ext: dict, rows_per_step: int, plans: dict) -> tuple:
    """``(ahead, prefetch, depth)``: the steps of slices past the current
    one that a step reads (its rows grown by the largest dim-0 extent),
    the steps in flight ahead of it (``PREFETCH_STEPS``, or one where the
    rings would then leave room for fewer than three CTAs an SM, as for
    3-D so8), and the slices of each operand's ring: those the step
    reads, those in flight and the step being refilled."""
    e = max((hi[0] - lo[0] for lo, hi in ext.values()), default=0)
    ahead = (rows_per_step - 1 + e) // rows_per_step
    for prefetch in (PREFETCH_STEPS, 1):
        depth = (ahead + prefetch + 1) * rows_per_step
        if 4 * sum((depth * p.floats + 3) // 4 * 4 for p in plans.values()) <= RING_BUDGET:
            break
    return ahead, prefetch, depth


def emit_apply_cuda(
    apply_op: stencil.ApplyOp,
    operand_shapes: Sequence[tuple],
    operand_origins: Sequence[tuple],
    result_bounds: stencil.Bounds,
    ptr_align: int = 16,
    out_strides: Optional[Sequence[Optional[tuple]]] = None,
) -> str:
    """CUDA C++ source of K1 for one apply at these operand shapes and
    origins: one ``__global__`` kernel, the C launcher
    ``k1_apply_launch(in0, …, out0, …, int slots, long long out0_slot, …,
    stream) -> cudaError_t`` (``slots`` copies of the apply, slot ``b``'s
    operands ``b`` operand sizes and its result ``j`` ``b * outj_slot``
    floats past the pointers) and the occupancy query
    ``k1_apply_occupancy(int* ctas_per_sm)``.
    ``ptr_align`` is the alignment in bytes that every operand pointer
    has; it bounds the width of the slice copies.  ``out_strides`` gives
    each result's strides in floats (``None``, or a ``None`` entry: the
    result is contiguous): a result may be a view into a larger tensor,
    such as its part of a ``stencil.combine``."""
    check_windows(apply_op, operand_shapes, operand_origins, result_bounds)
    ostr = result_strides(apply_op, result_bounds, out_strides)
    lifted = result_bounds.rank == 1
    shapes, origins, rb, ext = _lift(apply_op, operand_shapes, operand_origins, result_bounds)
    rank = rb.rank
    n = rb.shape
    tile = SLICE_TILE[rank]
    plans = slice_plans(apply_op, operand_shapes, operand_origins, result_bounds, ptr_align)
    step = ROWS_PER_STEP[result_bounds.rank]
    ahead, prefetch, depth = _ring(ext, step, plans)
    grid = [-(-n[0] // CHUNK_ROWS)] + [-(-m // t) for m, t in zip(n[1:], tile)]
    n_ctas = 1
    for g in grid:
        n_ctas *= g
    n_threads = 1
    for t in tile:
        n_threads *= t
    smem = 0
    for p in plans.values():
        smem = max(smem, 4 * (p.offset + (depth * p.floats + 3) // 4 * 4))
    n_in = len(apply_op.operands)
    n_out = len(apply_op.results)
    strides = [_strides(s) for s in shapes]
    # each result's strides in the lifted frame (rank 1 has one row, whose
    # index is always 0: its stride is the row's span, as if contiguous);
    # results of one stride share one offset variable
    if lifted:
        ostr = [(n[1] * st[0],) + st for st in ostr]
    groups_of = {st: g for g, st in enumerate(dict.fromkeys(ostr))}
    o_name = {st: ("o" if g == 0 else f"o{g}") for st, g in groups_of.items()}
    n_points = 1
    for s in n:
        n_points *= s

    src = [
        "// Generated by repro_torch/kernels/stencil_apply.py (kernel K1).",
        f"// result bounds {result_bounds.lb}..{result_bounds.ub}, {n_points} points; "
        f"CTA tile {tile} of the minor dims x {CHUNK_ROWS} rows along dim 0 in steps of "
        f"{step}, grid "
        f"{tuple(grid)} ({n_ctas} CTAs), rings of {depth} slices, {smem} bytes of "
        "shared memory",
    ]
    if any(st != _strides(n) for st in ostr):
        src.append("// result strides " + ", ".join(f"out{j} {st[1:] if lifted else st}"
                                                    for j, st in enumerate(ostr)))
    for k in range(n_in):
        src.append(
            f"// in{k}: shape {tuple(operand_shapes[k])}, origin "
            f"{tuple(operand_origins[k])}"
            + (f", slices of {plans[k].floats} floats, {4 * plans[k].width}-byte copies"
               if k in plans else ", not read")
        )
    src += [f'#include "{_HEADER}"', "", f"constexpr int kThreads = K1_BLOCK_THREADS({n_threads});", ""]
    params = [f"const float* __restrict__ in{k}_slots" for k in range(n_in)] + [
        f"float* __restrict__ out{j}_slots" for j in range(n_out)
    ] + [f"long long out{j}_slot" for j in range(n_out)]
    src.append(
        f"__global__ void __launch_bounds__({n_threads}) k1_apply("
        + ", ".join(params) + ") {"
    )
    src.append("  K1_DYNAMIC_SMEM(smem);")
    # this CTA: its slot (slowest), its chunk of rows and its tile of the
    # minor dims, fastest last
    src.append(f"  const long long slot = blockIdx.x / {n_ctas}u;")
    for k in range(n_in):
        src.append(f"  const float* __restrict__ const in{k} = in{k}_slots + slot * "
                   f"{_numel(operand_shapes[k])}LL;")
    for j in range(n_out):
        src.append(f"  float* __restrict__ const out{j} = out{j}_slots + slot * out{j}_slot;")
    src.append(f"  int blk = blockIdx.x % {n_ctas}u;")
    for d in reversed(range(rank)):
        src.append(f"  const int g{d} = blk % {grid[d]};")
        if d:
            src.append(f"  blk /= {grid[d]};")
    src.append(f"  const int z = g0 * {CHUNK_ROWS};")
    src.append(f"  const int rows = {n[0]} - z < {CHUNK_ROWS} ? {n[0]} - z : {CHUNK_ROWS};")
    for d in range(1, rank):
        t = tile[d - 1]
        src.append(f"  const int u{d} = g{d} * {t};")
        src.append(f"  const int w{d} = {n[d]} - u{d} < {t} ? {n[d]} - u{d} : {t};  // valid points")
    for k, p in plans.items():
        src.append(f"  float* const ring{k} = smem + {p.offset};")
    # stage(g): the slices of step g of every operand that has them, into
    # their ring slots (slice q goes to slot q % depth)
    src.append("  auto stage = [&](const int g) {")
    src.append(f"    for (int j = 0; j < {step}; ++j) {{")
    src.append(f"      const int q = g * {step} + j;")
    src.append(f"      const int slot = g % {depth // step} * {step} + j;")
    for k, p in plans.items():
        last = f"u{rank - 1} + {p.base[-1] - p.shift}"
        if rank == 3:
            copies_per_row = p.row // p.width
            src += [
                f"      if (q < rows + {p.ext[0]}) {{",
                f"        const float* const src = in{k} + (z + {p.base[0]} + q) * {strides[k][0]}LL"
                f" + (u1 + {p.base[1]}) * {strides[k][1]}LL + ({last});",
                f"        float* const dst = ring{k} + slot * {p.floats};",
                f"        for (int v = threadIdx.x; v < {(tile[0] + p.ext[1]) * copies_per_row}; "
                "v += kThreads) {",
                f"          const int r = v / {copies_per_row};",
                f"          const int l = v % {copies_per_row} * {p.width};",
                f"          if (r < w1 + {p.ext[1]} && l < w2 + {p.shift + p.ext[2]})",
                f"            K1_CP_ASYNC(dst + r * {p.row} + l, src + r * {strides[k][1]}LL + l, "
                f"{4 * p.width});",
                "        }",
                "      }",
            ]
        else:
            src += [
                f"      if (q < rows + {p.ext[0]}) {{",
                f"        const float* const src = in{k} + (z + {p.base[0]} + q) * {strides[k][0]}LL"
                f" + ({last});",
                f"        float* const dst = ring{k} + slot * {p.floats};",
                f"        for (int l = threadIdx.x * {p.width}; l < w1 + {p.shift + p.ext[1]}; "
                f"l += kThreads * {p.width})",
                f"          K1_CP_ASYNC(dst + l, src + l, {4 * p.width});",
                "      }",
            ]
    src += ["    }", "  };"]
    src += [
        f"  for (int g = 0; g < {ahead + prefetch}; ++g) {{",
        "    stage(g);",
        "    K1_CP_ASYNC_COMMIT();",
        "  }",
        "  int base = 0;  // the ring slot of row s",
        f"  for (int s = 0, g = {ahead + prefetch}; s < rows; s += {step}, ++g) {{",
        f"    K1_CP_ASYNC_WAIT({prefetch - 1});  // this thread's copies of the step's slices",
        "    __syncthreads();  // everyone's, and the previous step's slots are free again",
        "    stage(g);",
        "    K1_CP_ASYNC_COMMIT();",
    ]
    # the register-blocked column: every (operand, minor offset) of a tap
    # reads each of its rows once for the step's rows; row r of operand k
    # sits in ring slot ``slot{r - lo0}``
    groups = column_rows(apply_op, step, lifted)
    for r in sorted({r - ext[k][0][0] for (k, _), rows in groups.items() for r in rows}):
        src.append(f"    const int slot{r} = base + {r} < {depth} ? base + {r} : base + {r - depth};")
    src.append(f"    for (int t = threadIdx.x; t < {n_threads}; t += kThreads) {{")
    if rank == 3:
        src += [f"      const int c1 = t / {tile[1]};", f"      const int c2 = t % {tile[1]};",
                "      if (c1 >= w1 || c2 >= w2) continue;"]
    else:
        src += ["      const int c1 = t;", "      if (c1 >= w1) continue;"]
    for k, p in plans.items():
        inner = f"c1 * {p.row} + c2 + {p.shift}" if rank == 3 else f"c1 + {p.shift}"
        src.append(f"      const int e{k} = {inner};")
    names = {}
    for g, ((k, rest), rows) in enumerate(groups.items()):
        p, lo = plans[k], ext[k][0]
        flat = ((rest[0] - lo[1]) * p.row + rest[1] - lo[2]) if rank == 3 else rest[0] - lo[1]
        for row in rows:
            r = row - lo[0]
            names[(k, rest, row)] = f"x{k}_{g}_{r}"
            src.append(f"      const float x{k}_{g}_{r} = ring{k}[slot{r} * {p.floats} + e{k} + {flat}];")
    for st, name in o_name.items():
        flat_out = " + ".join(
            [f"static_cast<int64_t>(z + s) * {st[0]}LL"]
            + [f"(u{d} + c{d}) * {st[d]}LL" for d in range(1, rank)]
        )
        src.append(f"      const int64_t {name} = {flat_out};")
    for j in range(step):
        def load(k, offset, j=j):
            off = ((0,) + tuple(offset)) if lifted else tuple(offset)
            return names[(k, off[1:], j + off[0])]

        def index(d, j=j):
            dd = d + 1 if lifted else d
            coord = f"(z + s + {j})" if dd == 0 else f"(u{dd} + c{dd})"
            return f"static_cast<float>{coord} + {_f32_literal(float(rb.lb[dd]))}"

        ragged = n[0] % step != 0 and j > 0  # only a chunk's last step is ragged
        src.append(f"      if (s + {j} < rows) {{" if ragged else "      {")
        src += emit_body(apply_op, load, index,
                         lambda jj, v, j=j: f"out{jj}[{o_name[ostr[jj]]} + {j * ostr[jj][0]}LL] = {v};",
                         indent="        ")
        src.append("      }")
    src += [
        "    }",
        f"    base = base + {step} < {depth} ? base + {step} : 0;",
        "  }",
        "  K1_CP_ASYNC_WAIT(0);",
        "}",
        "",
    ]

    c_params = [f"const void* in{k}" for k in range(n_in)] + [
        f"void* out{j}" for j in range(n_out)
    ] + ["int slots"] + [f"long long out{j}_slot" for j in range(n_out)]
    args = [f"static_cast<const float*>(in{k})" for k in range(n_in)] + [
        f"static_cast<float*>(out{j})" for j in range(n_out)
    ] + [f"out{j}_slot" for j in range(n_out)]
    opt_in = []
    if smem > 48 * 1024:
        opt_in = [
            f"  const int attr = static_cast<int>(K1_OPT_IN_SMEM(k1_apply, {smem}));",
            "  if (attr != 0) return attr;",
        ]
    src += [f"K1_EXPORT int {_LAUNCHER}(" + ", ".join(c_params + ["void* stream"]) + ") {"]
    src += [f"  if (slots < 1 || slots > {_MAX_GRID // n_ctas}) return {_INVALID_VALUE};"]
    src += opt_in
    src += [
        f"  K1_LAUNCH(k1_apply, static_cast<unsigned int>(slots) * {n_ctas}u, kThreads, {smem}, stream,",
        "            " + ", ".join(args) + ");",
        "  return k1::launch_status();",
        "}",
        "",
        f"K1_EXPORT int {_OCCUPANCY}(void* ctas_per_sm) {{",
        *opt_in,
        "  return static_cast<int>(K1_OCCUPANCY(static_cast<int*>(ctas_per_sm), k1_apply, "
        f"kThreads, {smem}));",
        "}",
        "",
    ]
    return graphs.name_kernel(src, graphs.K1_KERNEL)


# a 1-D grid's largest x extent, and cudaErrorInvalidValue: what a launcher
# returns for a slot count whose grid would not fit
_MAX_GRID = 0x7FFFFFFF
_INVALID_VALUE = 1


def _numel(shape: Sequence[int]) -> int:
    n = 1
    for x in shape:
        n *= int(x)
    return n


def result_strides(
    apply_op: stencil.ApplyOp,
    result_bounds: stencil.Bounds,
    out_strides: Optional[Sequence[Optional[tuple]]] = None,
) -> list:
    """Each result's strides in floats: contiguous where ``out_strides``
    (or its entry) is ``None``; raise where a given stride tuple has the
    wrong rank or lets two points of the result share an address."""
    n = tuple(result_bounds.shape)
    if out_strides is None:
        out_strides = [None] * len(apply_op.results)
    if len(out_strides) != len(apply_op.results):
        raise ValueError(
            f"{len(out_strides)} result strides for an apply of "
            f"{len(apply_op.results)} results"
        )
    out = []
    for j, st in enumerate(out_strides):
        st = _strides(n) if st is None else tuple(int(x) for x in st)
        if len(st) != len(n):
            raise ValueError(f"result {j}: strides {st} for a rank-{len(n)} result")
        # no two points on one address: sorted by stride, each dim must
        # step over everything the faster dims span
        span = 1
        for x, m in sorted((x, m) for x, m in zip(st, n) if m > 1):
            if x < span:
                raise ValueError(f"result {j}: strides {st} overlap for shape {n}")
            span = x * m
        out.append(st)
    return out


# --------------------------------------------------------------------------
# Build and load
# --------------------------------------------------------------------------

_LIBS: dict = {}  # (generated source, symbol) -> loaded ctypes function
_LIBS_LOCK = threading.Lock()
# apply op -> {(operand shapes, origins, result bounds): launcher}: a time
# loop calls the same apply at the same shapes every step, so its source
# is emitted (and its windows checked) once, not on every call
_BOUND: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def find_nvcc() -> str:
    """``nvcc`` on ``PATH``, else under ``$CUDA_HOME/bin``, else under
    ``/usr/local/cuda/bin``."""
    candidates = [shutil.which("nvcc")]
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found on PATH, under $CUDA_HOME/bin or /usr/local/cuda/bin: "
        "the CUDA kernels cannot be built"
    )


def source_digest(source: str) -> str:
    """Content hash of a generated source, its header and the flags."""
    h = hashlib.sha256(source.encode())
    h.update((CSRC_DIR / _HEADER).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:24]


def library_path(source: str) -> Path:
    return BUILD_DIR / f"{source_digest(source)}.so"


def build(sources: Sequence[str]) -> list:
    """Compile every source whose library is not on disk yet, one ``nvcc``
    per source, all started together; raise with the compiler's output if
    any fails.  Returns the library paths, in the order of ``sources``."""
    paths = [library_path(s) for s in sources]
    todo = {p: s for p, s in zip(paths, sources) if not p.exists()}
    if not todo:
        return paths
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.{threading.get_ident()}"
    jobs: list = []
    failures: list = []
    try:
        for so, source in todo.items():
            cu = so.with_name(f"{so.stem}.{tag}.cu")
            cu.write_text(source)
            tmp = so.with_name(f"{so.stem}.{tag}.so")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(tmp), str(cu)]
            proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )
            jobs.append((so, cu, tmp, proc))
        for so, cu, tmp, proc in jobs:
            log, _ = proc.communicate()
            so.with_suffix(".log").write_text(log)
            if proc.returncode != 0:
                failures.append(f"{cu.name}: nvcc exit {proc.returncode}\n{log}")
                continue
            os.replace(cu, so.with_suffix(".cu"))
            os.replace(tmp, so)
    finally:
        for *_, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return paths


def ptr_alignment(tensors: Sequence[torch.Tensor], rank: Optional[int] = None) -> int:
    """The largest of 16, 8 and 4 bytes that every tensor's data pointer is
    a multiple of: the widest asynchronous copy a kernel may use on them.
    Given ``rank``, tensors with a leading slot dim of more than one slot
    also need each slot's start (the data pointer plus a multiple of the
    slot's bytes, ``4 ×`` the last ``rank`` dims' size) to be aligned."""
    for a in (16, 8, 4):
        if all(t.data_ptr() % a == 0 for t in tensors) and all(
            4 * _numel(t.shape[t.ndim - rank:]) % a == 0
            for t in tensors if rank is not None and t.ndim > rank and t.shape[0] > 1
        ):
            return a
    raise ValueError("a float32 tensor whose data is not 4-byte aligned")


def split_slots(arrays: Sequence[torch.Tensor], rank: int, what: str) -> tuple:
    """``(slots, per-slot shapes)`` of a kernel's operands: each is a
    ``rank``-D tensor, or a ``[B, ...]`` pool of them with one ``B`` for
    all (``slots`` is ``None`` without a slot dim)."""
    leads = {tuple(a.shape[: a.ndim - rank]) for a in arrays}
    if len(leads) > 1 or any(len(x) > 1 for x in leads) or any(a.ndim < rank for a in arrays):
        raise ValueError(
            f"{what} of shapes {[tuple(a.shape) for a in arrays]}: each must be {rank}-D, "
            f"or carry one leading slot dim of one size for all"
        )
    lead = leads.pop() if leads else ()
    return (lead[0] if lead else None), [tuple(a.shape[a.ndim - rank:]) for a in arrays]


def _kernel_for(apply_op, shapes, origins, result_bounds, ptr_align: int = 16,
                out_strides: Optional[tuple] = None):
    key = (tuple(shapes), tuple(tuple(o) for o in origins), result_bounds, ptr_align,
           out_strides)
    with _LIBS_LOCK:
        per_op = _BOUND.setdefault(apply_op, {})
        fn = per_op.get(key)
    if fn is None:
        source = emit_apply_cuda(apply_op, shapes, origins, result_bounds, ptr_align,
                                 out_strides)
        graphs.register(source, apply_op)
        n_out = len(apply_op.results)
        fn = _launcher(source, [ctypes.c_void_p] * (len(shapes) + n_out) + [ctypes.c_int]
                       + [ctypes.c_longlong] * n_out + [ctypes.c_void_p])
        with _LIBS_LOCK:
            per_op[key] = fn
    return fn


def _launcher(source: str, argtypes: Sequence, symbol: str = _LAUNCHER):
    """The C function ``symbol`` of a generated source, built on first use
    and loaded once per process, taking ``argtypes`` (ctypes types) and
    returning an ``int``."""
    with _LIBS_LOCK:
        fn = _LIBS.get((source, symbol))
        if fn is None:
            (path,) = build([source])
            lib = ctypes.CDLL(str(path))
            fn = getattr(lib, symbol)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            _LIBS[(source, symbol)] = fn
    return fn


def ctas_per_sm(source: str, symbol: str = _OCCUPANCY) -> int:
    """CTAs of a generated kernel that one SM of the current card holds at
    once, from its occupancy query ``symbol`` (K1's by default; it calls
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``, which weighs the
    kernel's registers, shared memory and threads); builds the source on
    first use."""
    fn = _launcher(source, [ctypes.c_void_p], symbol)
    out = ctypes.c_int(0)
    status = fn(ctypes.addressof(out))
    if status != 0:
        raise RuntimeError(f"occupancy query failed with CUDA error {status}")
    return out.value


# --------------------------------------------------------------------------
# Entry point
# --------------------------------------------------------------------------


def run_apply_cuda(
    apply_op: stencil.ApplyOp,
    arrays: Sequence[torch.Tensor],
    origins: Sequence[tuple],
    result_bounds: stencil.Bounds,
    device: Optional[torch.device] = None,
    out: Optional[Sequence[Optional[torch.Tensor]]] = None,
    lead: tuple = (),
) -> list:
    """Entry point used by the lowering's ``cuda`` backend.

    CPU tensors go through the plain version (``eval_apply_body``); CUDA
    tensors go through the kernel, or the call raises.  ``device`` and
    ``lead`` (the slot dim) are only read when the apply has no operands.
    ``out`` gives, per result, the tensor to write it into (``None``: a new
    contiguous tensor); it may be a strided view, such as the part of a
    larger result, and must not overlap an operand.  Operands may be ``[B, *shape]`` slot pools (one
    ``B`` for all): the results then are too, and one launch computes
    every slot.  Each call counts in ``dispatch_stats().apply_calls``, each
    launch in ``apply_launches``.
    """
    from repro_torch.core.lowering import eval_apply_body, write_into

    _DISPATCH.apply_calls += 1
    dev = arrays[0].device if arrays else torch.device(device or "cpu")
    slots, shapes = split_slots(arrays, result_bounds.rank, "K1 operands")
    if arrays or not lead:
        lead = () if slots is None else (slots,)
    else:
        slots = lead[0]
    for k, a in enumerate(arrays):
        if a.device != dev:
            raise ValueError(f"operand {k} on {a.device}, operand 0 on {dev}")
        if a.dtype != torch.float32:
            raise TypeError(f"operand {k} is {a.dtype}; K1 takes float32")
    shape = lead + tuple(result_bounds.shape)
    out = list(out) if out is not None else [None] * len(apply_op.results)
    if len(out) != len(apply_op.results):
        raise ValueError(f"{len(out)} out tensors for an apply of {len(apply_op.results)} results")
    for j, o in enumerate(out):
        if o is not None and (o.device != dev or o.dtype != torch.float32
                              or tuple(o.shape) != tuple(shape)):
            raise ValueError(
                f"out {j}: a {o.dtype} tensor of shape {tuple(o.shape)} on {o.device}, "
                f"expected float32 of shape {tuple(shape)} on {dev}"
            )
    if dev.type == "cpu":
        check_windows(apply_op, shapes, origins, result_bounds)
        return write_into(
            eval_apply_body(apply_op, arrays, origins, result_bounds, device=dev, lead=lead), out
        )
    if dev.type != "cuda":
        raise ValueError(f"K1 runs on CUDA or (plain version) CPU, not {dev}")
    for k, a in enumerate(arrays):
        if not a.is_contiguous():
            raise ValueError(f"operand {k} is not contiguous")
    outs = [
        torch.empty(shape, dtype=torch.float32, device=dev) if o is None else o
        for o in out
    ]
    if outs[0].numel() == 0:
        check_windows(apply_op, shapes, origins, result_bounds)
        return outs
    strides = None
    if any(o is not None for o in out):
        strides = tuple(tuple(o.stride()[len(lead):]) for o in outs)
        result_strides(apply_op, result_bounds, strides)  # refuse overlapping views
    # a result's slot stride: a pool's slot may not overlap another slot
    out_slot = [o.stride(0) if lead else 0 for o in outs]
    span = [_numel(shape[1:]) if st is None else
            1 + sum((n - 1) * x for n, x in zip(result_bounds.shape, st))
            for st in (strides or [None] * len(outs))]
    if lead and slots > 1 and any(x < n for x, n in zip(out_slot, span)):
        raise ValueError(f"out slot strides {out_slot}: the slots of a result overlap")
    # the windows are checked when the source is emitted, once per shape
    fn = _kernel_for(apply_op, shapes, origins, result_bounds,
                     ptr_alignment(arrays, result_bounds.rank), strides)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = fn(
            *[a.data_ptr() for a in arrays], *[o.data_ptr() for o in outs],
            slots or 1, *out_slot, stream,
        )
    if status != 0:
        raise RuntimeError(
            f"K1 launch failed with CUDA error {status} (result shape {shape})"
        )
    _DISPATCH.apply_launches += 1
    return outs
