"""Kernels K1 and K2 as generated CUDA C++, run on the host.

The tests here hold the very sources that ``nvcc`` builds for the card
against the kernels' plain versions, bitwise.  Each source is compiled
with ``g++ -O1 -ffp-contract=off`` against ``HOST_HEADER`` below, a host
stand-in for the kernels' header ``stencil_apply_common.cuh``: one thread
per CTA, the launcher walking ``blockIdx.x`` over the grid, shared memory
filled with NaN before each CTA, ``cp.async`` a copy that checks its
alignment, ``__syncthreads`` a no-op.  That runs every index, window,
ring slot, ragged edge and guard of the generated code; what it cannot
show is what only the card has (concurrent threads, the real copy engine,
timing).  Bodies with ``sqrtf``/``expf`` are left out: the C library's
and torch's roundings of those differ.

The overlap path's parts (interior and boundary frames) are emitted with
strided results, as the executor launches them into one result of the
combine's shape: their sources run on the host too, writing into one
NaN-filled buffer, and every point outside the part stays NaN.

Scratch plans (K2's buffers in device memory where shared memory cannot
hold them): the stand-in's per-tile hook fills the CTA's scratch and its
shared memory with NaN before every tile a CTA takes, so a looping CTA
that read a point this tile never wrote would come out NaN rather than
pass with the previous tile's value.

Slot pools: a launch with a slot count ``B`` (here 3) over ``[B, *shape]``
operands runs ``B`` times the grid, each slot bitwise equal to the plain
version of that slot and to a launch of its own; the sources are emitted
for the alignment the wrapper would pick (``ptr_alignment`` with the
slots' strides), and a part of a combine writes its slice of each slot of
a ``[B, *combine]`` result through its slot stride.

Skips only where ``g++`` is not on ``PATH``.
"""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

import _torch_programs as P
from repro_torch import api
from repro_torch.api import Target
from repro_torch.core.lowering import eval_apply_body
from repro_torch.core.dialects import stencil
from repro_torch.core.passes.decompose import make_strategy_1d, make_strategy_2d, make_strategy_3d
from repro_torch.dist import Mesh
from repro_torch.kernels import epoch_kernel as k2
from repro_torch.kernels import ops
from repro_torch.kernels import stencil_apply as k1

HOST_HEADER = r"""// Host stand-in for the kernels' header stencil_apply_common.cuh: with
// it first on the include path a generated K1 or K2 source builds with g++
// into a host library.  One thread per CTA (K1_BLOCK_THREADS is 1, so every
// loop over a CTA's points runs them all); the launcher walks blockIdx.x
// over the grid; shared memory is a host buffer filled with NaN before each
// CTA (a point that reads shared memory nothing wrote comes out NaN), and
// before each tile of a K2 scratch plan its CTA's scratch and shared memory
// are filled with NaN again; a value a K2 streaming plan's thread keeps
// across iterations is one per work item; cp.async is a copy that first
// checks the alignment its size needs; __syncthreads does nothing.
#pragma once

#include <math.h>
#include <stdint.h>
#include <string.h>

#include <algorithm>
#include <limits>
#include <vector>

#define K1_EXPORT extern "C" __attribute__((visibility("default")))
#define __global__
#define __device__
#define __launch_bounds__(...)

struct k1_host_index { unsigned int x; };
static k1_host_index blockIdx = {0u};
static k1_host_index gridDim = {1u};
static const k1_host_index threadIdx = {0u};

namespace k1_host {
static std::vector<float> smem;
static int status = 0;  // 1 after a misaligned asynchronous copy

inline void copy(float* dst, const float* src, int bytes) {
  if (reinterpret_cast<uintptr_t>(dst) % bytes || reinterpret_cast<uintptr_t>(src) % bytes) {
    status = 1;
  }
  memcpy(dst, src, bytes);
}

inline void scratch_tile(float* scratch, long long floats) {
  std::fill(scratch, scratch + floats, std::numeric_limits<float>::quiet_NaN());
  std::fill(smem.begin(), smem.end(), std::numeric_limits<float>::quiet_NaN());
}
}  // namespace k1_host

inline void __syncthreads() {}

inline float __int_as_float(unsigned int bits) {
  float f;
  memcpy(&f, &bits, sizeof f);
  return f;
}

#define K1_BLOCK_THREADS(n) 1
#define K1_DYNAMIC_SMEM(name) float* const name = k1_host::smem.data()
#define K1_CP_ASYNC(dst, src, bytes) k1_host::copy((dst), (src), (bytes))
#define K1_CP_ASYNC_COMMIT() ((void)0)
#define K1_CP_ASYNC_WAIT(n) ((void)0)
#define K1_OPT_IN_SMEM(kernel, bytes) 0
#define K1_OCCUPANCY(blocks, kernel, threads, smem) (*(blocks) = 1, 0)
#define K1_SCRATCH_TILE(scratch, floats) k1_host::scratch_tile((scratch), (floats))
#define K1_PER_THREAD(name, items) float name[items]
#define K1_MINE(name, item) name[item]
#define K1_LAUNCH(kernel, grid, block, smem_bytes, stream, ...)                      \
  do {                                                                               \
    gridDim.x = static_cast<unsigned int>(grid);                                     \
    for (unsigned int b_ = 0; b_ < static_cast<unsigned int>(grid); ++b_) {          \
      k1_host::smem.assign((smem_bytes) / 4 + 4, std::numeric_limits<float>::quiet_NaN()); \
      blockIdx.x = b_;                                                               \
      kernel(__VA_ARGS__);                                                           \
    }                                                                                \
  } while (0)

namespace k1 {
inline int launch_status() { return k1_host::status; }
}  // namespace k1
"""
GXX_FLAGS = ("-x", "c++", "-std=c++17", "-O1", "-ffp-contract=off", "-shared", "-fPIC")


def _applies(prog, k=1):
    return api.compile(prog, Target(backend="cuda", exchange_every=k, device="cpu")).kernel_applies()


def _epoch(prog, k, mesh=None):
    """The fused epoch of ``prog`` at depth ``k``, on one device or (``mesh``
    given) on each rank of a 2×2 (or 2×2×1) mesh of CPU ranks."""
    strategy = make_strategy_2d((2, 2)) if mesh is MESH_2X2 else make_strategy_3d((2, 2, 1))
    dist = {} if mesh is None else {"mesh": mesh, "strategy": strategy}
    target = Target(backend="cuda", exchange_every=k, fused_epoch=True, device="cpu", **dist)
    (op,) = api.compile(prog, target).kernel_epochs()
    return op


MESH_2X2 = Mesh(np.array([torch.device("cpu")] * 4, dtype=object).reshape(2, 2), ("x", "y"))
MESH_2X2X1 = Mesh(np.array([torch.device("cpu")] * 4, dtype=object).reshape(2, 2, 1),
                  ("x", "y", "z"))
CORNERS = [{"x": x, "y": y} for x in (0, 1) for y in (0, 1)]


def _spec(apply_op):
    return (
        apply_op,
        [tuple(o.type.bounds.shape) for o in apply_op.operands],
        [tuple(o.type.bounds.lb) for o in apply_op.operands],
        apply_op.result_bounds,
    )


# K1: name -> the applies to run (rows 70 = 64 + 6 and columns 300 = 256 +
# 44 leave a ragged chunk and a ragged tile)
K1_CASES = {
    "heat2d-so2-zero": lambda: _applies(P.heat("repro_torch", (70, 300), 2)),
    "heat2d-so2-periodic": lambda: _applies(P.heat("repro_torch", (70, 300), 2, "periodic")),
    "heat2d-so4-zero": lambda: _applies(P.heat("repro_torch", (70, 300), 4)),
    "heat2d-so4-periodic": lambda: _applies(P.heat("repro_torch", (70, 300), 4, "periodic")),
    "heat2d-so4-grown-frames": lambda: _applies(P.heat("repro_torch", (18, 270), 4), 4),
    "wave2d-so4": lambda: _applies(P.wave("repro_torch", (40, 270), 4)),
    "index-chain": lambda: _applies(P.index_chain("repro_torch", (24, 20))),
    "heat3d-so4-ragged": lambda: _applies(P.heat("repro_torch", (70, 12, 40), 4), 2),
    "heat3d-so8-one-step-prefetch": lambda: _applies(P.heat("repro_torch", (20, 9, 37), 8)),
    "box3d": lambda: [ops.star_apply_ir(
        {(i, j, k): 1.0 / 27.0 for i in (-1, 0, 1) for j in (-1, 0, 1) for k in (-1, 0, 1)},
        (9, 10, 35), (1, 1, 1))[0]],
    "star1d": lambda: [ops.star_apply_ir({(-3,): 0.5, (0,): 1.0, (2,): 0.25}, (600,), (3,))[0]],
    # fig 10: three operands, three results (PW) and a two-apply chain (tracer)
    "pw-advection-3d": lambda: _applies(P.advection("repro_torch", "pw_advection", (20, 9, 37))),
    "tracer-advection-3d": lambda: _applies(
        P.advection("repro_torch", "tracer_advection", (20, 9, 37), "zero")),
}

def _overlap(prog, mesh_shape):
    """The overlap path's K1 applies of ``prog`` on a rank of a CPU mesh of
    ``mesh_shape``: the interior and a frame at each end of each split dim,
    each with the strides it is written with (a view into the combine's
    result)."""
    names = ("x", "y", "z")[: len(mesh_shape)]
    strategy = {1: lambda: make_strategy_1d(mesh_shape[0]), 2: lambda: make_strategy_2d(mesh_shape),
                3: lambda: make_strategy_3d(mesh_shape)}[len(mesh_shape)]()
    n = int(np.prod(mesh_shape))
    mesh = Mesh(np.array([torch.device("cpu")] * n, dtype=object).reshape(mesh_shape), names)
    step = api.compile(prog, Target(backend="cuda", overlap=True, device="cpu", mesh=mesh,
                                    strategy=strategy))
    return [(a, step.kernel_out_strides(a)) for a in step.kernel_applies()]


# the overlap path's parts, strided results: name -> [(apply, out strides)]
# (a rank's shard of 35x300 leaves a ragged tile; 1-D runs lifted)
K1_PART_CASES = {
    "heat2d-so4-zero-overlap-2x2": lambda: _overlap(P.heat("repro_torch", (70, 600), 4), (2, 2)),
    "heat2d-so2-periodic-overlap-2x2": lambda: _overlap(
        P.heat("repro_torch", (36, 40), 2, "periodic"), (2, 2)),
    "heat3d-so4-overlap-2x2x2": lambda: _overlap(P.heat("repro_torch", (20, 18, 40), 4), (2, 2, 2)),
    "heat1d-so4-overlap-2": lambda: _overlap(P.heat("repro_torch", (48,), 4), (2,)),
}

# K2: name -> (program, k, tile or None for choose_tile's)
K2_CASES = {
    **{
        f"heat2d-so{so}-{bc}-k{k}": (
            (lambda so=so, bc=bc: P.heat("repro_torch", (48, 40), so, bc)), k, (16, 8)
        )
        for so in (2, 4) for bc in ("zero", "periodic") for k in (2, 4)
    },
    "heat2d-so4-zero-k4-default-tile": (lambda: P.heat("repro_torch", (48, 40), 4), 4, None),
    "wave2d-so4-k4": (lambda: P.wave("repro_torch", (24, 20), 4), 4, (8, 4)),
    "index-chain-2d": (lambda: P.index_chain("repro_torch", (24, 20)), 1, (8, 5)),
    "index-chain-1d": (lambda: P.index_chain("repro_torch", (30,)), 1, (6,)),
    "heat3d-so4-k2": (lambda: P.heat("repro_torch", (12, 10, 16), 4), 2, (4, 5, 8)),
}


# K2 scratch plans, whose CTAs loop over tiles with buffers in device
# memory: name -> (program, k, tile, scratch forced, mesh coords), each
# planned with streaming plans left out (``stream=False``).  No tile of
# heat so4 k=8 or wave so8 k=4 fits shared memory (their plans keep some
# buffers on chip and some in scratch); the forced case
# puts every buffer of an epoch that fits in device memory, at the tile of
# "heat3d-so4-k2"; the corner is a rank's epoch of a 2×2×1 mesh
K2_SCRATCH_CASES = {
    "heat3d-so4-k8": (lambda: P.heat("repro_torch", (20, 16, 16), 4), 8, None, False, None),
    "wave3d-so8-k4": (lambda: P.wave("repro_torch", (20, 16, 18), 8), 4, None, False, None),
    "heat3d-so4-k2-forced": (lambda: P.heat("repro_torch", (12, 10, 16), 4), 2, (4, 5, 8), True,
                             None),
    "heat3d-so4-k8-2x2x1-corner": (lambda: P.heat("repro_torch", (40, 32, 16), 4), 8, None, False,
                                   {"x": 1, "y": 0}),
}

# K2 streaming plans (rank 3: a minor tile, the core walked plane by plane
# through rings in shared memory): name -> (program, k, stream, mesh
# coords), ``stream`` as ``plan_epoch`` takes it.  Heat so4 k=8 and wave
# so8 k=4 at their least costly streaming plan; heat so4 k=2 at the minor
# tile of "heat3d-so4-k2"; wave so4 k=2 in three dim-0 segments (the
# carried escape's overhang planes written by the first and last
# segments); a rank's keep box on a 2×2×1 mesh
K2_STREAM_CASES = {
    "heat3d-so4-k8": (lambda: P.heat("repro_torch", (20, 16, 16), 4), 8, (8, 8), None),
    "wave3d-so8-k4": (lambda: P.wave("repro_torch", (20, 16, 18), 8), 4, (8, 9), None),
    "heat3d-so4-k2": (lambda: P.heat("repro_torch", (12, 10, 16), 4), 2, (5, 8), None),
    "wave3d-so4-k2-segments": (lambda: P.wave("repro_torch", (12, 10, 16), 4), 2, (4, 5, 8),
                               None),
    "heat3d-so4-k8-2x2x1-corner": (lambda: P.heat("repro_torch", (40, 32, 16), 4), 8, (8, 16),
                                   {"x": 1, "y": 0}),
}

# pooled launches (B = 3): K1 cases and K2 cases run with a slot count; the
# combine's parts write into a [B, *combine] result
POOL_SLOTS = 3
K1_POOL_CASES = ["heat2d-so4-zero", "heat2d-so2-periodic", "wave2d-so4", "index-chain",
                 "heat3d-so4-ragged", "star1d", "pw-advection-3d"]
K2_POOL_CASES = {
    "heat2d-so4-zero-k4": (lambda: P.heat("repro_torch", (48, 40), 4), 4, (16, 8), None),
    "wave2d-so4-k4": (lambda: P.wave("repro_torch", (24, 20), 4), 4, (8, 4), None),
    "heat2d-so4-zero-k4-2x2-corner": (lambda: P.heat("repro_torch", (48, 40), 4), 4, (8, 4),
                                      {"x": 1, "y": 0}),
}


def _pool_align(shapes, rank):
    """The alignment the wrapper picks (``ptr_alignment``) for
    ``[POOL_SLOTS, *shape]`` operands of :func:`_inputs` (16-byte aligned
    bases) with these per-slot shapes."""
    return k1.ptr_alignment(_inputs([(POOL_SLOTS,) + tuple(sh) for sh in shapes], 0), rank)


# K2 on a rank of a 2×2 mesh, zero BC: the ranks keep different boxes, which
# the kernel takes as launch arguments; name -> (program, k, tile)
K2_RANK_CASES = {
    "heat2d-so4-zero-k4-2x2": (lambda: P.heat("repro_torch", (48, 40), 4), 4, (8, 4)),
    "wave2d-so4-k2-2x2": (lambda: P.wave("repro_torch", (24, 20), 4), 2, (4, 5)),
}


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """Every case's sources, compiled together: {(kernel, name): [(op,
    library path), ...]}.  Also one K1 and one K2 source generated for
    operands only 4-byte aligned, under the name ``unaligned``."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not on PATH")
    out_dir = tmp_path_factory.mktemp("host_kernels")
    (out_dir / k1._HEADER).write_text(HOST_HEADER)
    jobs, built = [], {}

    def add(key, op, source):
        path = out_dir / f"k{len(jobs)}.so"
        cpp = path.with_suffix(".cpp")
        cpp.write_text(source)
        cmd = [gxx, *GXX_FLAGS, "-I", str(out_dir), "-o", str(path), str(cpp)]
        jobs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        built.setdefault(key, []).append((op, path))

    for name, make in K1_CASES.items():
        for apply_op in make():
            add(("k1", name), apply_op, k1.emit_apply_cuda(*_spec(apply_op)))
    for name, make in K1_PART_CASES.items():
        for apply_op, strides in make():
            add(("k1-part", name), (apply_op, strides),
                k1.emit_apply_cuda(*_spec(apply_op), out_strides=strides))
    for name, (prog, k, tile) in K2_CASES.items():
        op = _epoch(prog(), k)
        add(("k2", name), (op, tile), k2.emit_epoch_cuda(op, tile))
    for name, (prog, k, tile) in K2_RANK_CASES.items():
        op = _epoch(prog(), k, MESH_2X2)
        add(("k2", name), (op, tile), k2.emit_epoch_cuda(op, tile))
    for name in K1_POOL_CASES:
        for apply_op in K1_CASES[name]():
            spec = _spec(apply_op)
            add(("k1-pool", name), apply_op,
                k1.emit_apply_cuda(*spec, ptr_align=_pool_align(spec[1], spec[3].rank)))
    for apply_op, strides in K1_PART_CASES["heat2d-so4-zero-overlap-2x2"]():
        add(("k1-part-pool", "heat2d-so4-zero-overlap-2x2"), (apply_op, strides),
            k1.emit_apply_cuda(*_spec(apply_op), out_strides=strides))
    for name, (prog, k, tile, coords) in K2_POOL_CASES.items():
        op = _epoch(prog(), k, None if coords is None else MESH_2X2)
        shapes = [a.type.bounds.shape for a in op.body.args]
        add(("k2-pool", name), (op, tile, coords),
            k2.emit_epoch_cuda(op, tile, ptr_align=_pool_align(shapes, len(shapes[0]))))
    for name, (prog, k, tile, forced, coords) in K2_SCRATCH_CASES.items():
        op = _epoch(prog(), k, None if coords is None else MESH_2X2X1)
        shapes = [a.type.bounds.shape for a in op.body.args]
        add(("k2-scratch", name), (op, tile, forced, coords),
            k2.emit_epoch_cuda(op, tile, ptr_align=_pool_align(shapes, len(shapes[0])),
                               scratch=forced, stream=False))
    for name, (prog, k, stream, coords) in K2_STREAM_CASES.items():
        op = _epoch(prog(), k, None if coords is None else MESH_2X2X1)
        shapes = [a.type.bounds.shape for a in op.body.args]
        add(("k2-stream", name), (op, stream, coords),
            k2.emit_epoch_cuda(op, ptr_align=_pool_align(shapes, len(shapes[0])), stream=stream))
    (heat,) = K1_CASES["heat2d-so4-zero"]()
    add(("k1", "unaligned"), heat, k1.emit_apply_cuda(*_spec(heat), ptr_align=4))
    op = _epoch(P.heat("repro_torch", (48, 40), 4), 4)
    add(("k2", "unaligned"), (op, (16, 8)), k2.emit_epoch_cuda(op, (16, 8), ptr_align=4))
    for job in jobs:
        log, _ = job.communicate()
        assert job.returncode == 0, log
    return built


def _inputs(shapes, seed, offset=0):
    """Seeded float32 operands; ``offset`` floats into their storage (4:
    16-byte aligned, 1: only 4-byte aligned)."""
    rng = np.random.default_rng(seed)
    out = []
    for s in shapes:
        n = int(np.prod(s))
        flat = torch.empty(n + 4)
        flat[offset:offset + n] = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
        out.append(flat[offset:offset + n].view(s))
    return out


def _run(path, symbol, inputs, out_shapes, ints=(), slots=1, scratch=None, status=0):
    """Launch a built source's ``symbol`` on ``inputs``: pointers, then the
    ``int`` arguments ``ints`` (K2's box bounds), the slot count, for K1
    each result's slot stride (its size: the results are contiguous
    ``[slots, *shape]`` pools when ``slots`` > 1), for a K2 scratch plan
    (``scratch``: its floats a CTA and the CTAs to launch) a NaN-filled
    scratch and the CTAs, then the stream; the launcher must return
    ``status``."""
    fn = getattr(ctypes.CDLL(str(path)), symbol)
    k1_slot_strides = [int(np.prod(s)) for s in out_shapes] if symbol == "k1_apply_launch" else []
    grid, grid_types = [], []
    if scratch is not None:
        floats, ctas = scratch
        area = torch.full((max(1, floats * ctas),), float("nan"))
        grid, grid_types = [area.data_ptr(), ctas], [ctypes.c_void_p, ctypes.c_int]
    fn.argtypes = ([ctypes.c_void_p] * (len(inputs) + len(out_shapes))
                   + [ctypes.c_int] * (len(ints) + 1) + [ctypes.c_longlong] * len(k1_slot_strides)
                   + grid_types + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lead = (slots,) if slots > 1 else ()
    outs = [torch.full(lead + tuple(s), float("nan")) for s in out_shapes]
    got = fn(*[x.data_ptr() for x in inputs], *[o.data_ptr() for o in outs], *ints, slots,
             *k1_slot_strides, *grid, None)
    assert got == status  # the stand-in reports a copy wider than its pointers' alignment
    return outs


def _check_k1(built, name, offset=4):
    for n, (apply_op, path) in enumerate(built["k1", name]):
        _, shapes, origins, rb = _spec(apply_op)
        arrays = _inputs(shapes, seed=n, offset=offset)
        got = _run(path, "k1_apply_launch", arrays, [rb.shape] * len(apply_op.results))
        want = eval_apply_body(apply_op, arrays, origins, rb)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def _check_parts(built, name):
    """Every part of the combine written by its source into one NaN-filled
    result of the combine's shape: each part's points bitwise equal to
    the plain version, the points of no part still NaN."""
    parts = built["k1-part", name]
    (comb,) = {u.operation for (a, _), _ in parts for u in a.results[0].uses}
    assert isinstance(comb, stencil.CombineOp)
    cb = comb.result_bounds
    buf = torch.full(tuple(cb.shape), float("nan"))
    want = torch.full(tuple(cb.shape), float("nan"))
    inputs = {}
    for (apply_op, strides), path in parts:
        assert strides is not None and all(st == buf.stride() for st in strides)
        _, shapes, origins, rb = _spec(apply_op)
        arrays = [inputs.setdefault((o, s), _inputs([s], seed=len(inputs))[0])
                  for o, s in zip(apply_op.operands, shapes)]
        idx = tuple(slice(l - c, l - c + n) for l, c, n in zip(rb.lb, cb.lb, rb.shape))
        view = buf[idx]
        fn = getattr(ctypes.CDLL(str(path)), "k1_apply_launch")
        fn.argtypes = ([ctypes.c_void_p] * (len(arrays) + 1) + [ctypes.c_int, ctypes.c_longlong]
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        assert fn(*[x.data_ptr() for x in arrays], view.data_ptr(), 1, 0, None) == 0
        want[idx] = eval_apply_body(apply_op, arrays, origins, rb)[0]
    assert torch.equal(buf.isnan(), want.isnan())
    assert torch.equal(torch.nan_to_num(buf), torch.nan_to_num(want))
    return parts


def _check_k2(built, name, offset=4, coords=None):
    for (op, tile), path in built["k2", name]:
        arrays = _inputs([a.type.bounds.shape for a in op.body.args], seed=1, offset=offset)
        got = _run(path, "k2_epoch_launch", arrays, [r.type.bounds.shape for r in op.results],
                   k2.box_args(op, coords))
        want = k2._emit_region(op, arrays, k2.region_masks(op, "cpu", coords),
                               lambda v: v.type.bounds)
        assert len(got) == len(want) == len(op.results)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.parametrize("name", sorted(K1_CASES))
def test_k1_source_on_host_matches_plain_version(built, name):
    """K1's generated source, every CTA run on the host, bitwise equal to
    ``eval_apply_body``: ragged chunks and tiles, grown frames, two
    operands, ``stencil.index``, 3-D and 1-D."""
    _check_k1(built, name)


@pytest.mark.parametrize("name", sorted(K1_PART_CASES))
def test_k1_part_sources_write_their_slice_of_the_combine(built, name):
    """The overlap path's interior and frames, each emitted with the
    strides of the combine's result: 2-D (both boundaries), 3-D with
    frames at both ends of all three dims, and 1-D lifted to 2-D.  Each
    writes exactly its slice, bitwise equal to the plain version."""
    parts = _check_parts(built, name)
    rank = parts[0][0][0].result_bounds.rank
    assert len(parts) == 1 + 2 * rank  # the interior and two frames a dim


@pytest.mark.parametrize("name", sorted(K2_CASES))
def test_k2_source_on_host_matches_plain_version(built, name):
    """K2's generated source, every CTA run on the host, bitwise equal to
    its plain version: heat so2/so4 zero and periodic at k=2 and k=4
    (edge tiles, ragged column chunks, fused masks), wave's overhang
    escape, ``stencil.index`` chains in 1-D and 2-D, and 3-D heat."""
    _check_k2(built, name)


@pytest.mark.parametrize("corner", range(len(CORNERS)))
@pytest.mark.parametrize("name", sorted(K2_RANK_CASES))
def test_k2_source_on_host_at_each_rank_coordinate(built, name, corner):
    """One K2 source of a rank-local epoch, launched with the box of each
    corner of a 2×2 mesh, bitwise equal to its plain version with that
    corner's masks; the four corners keep four different boxes."""
    ((op, _), _), = built["k2", name]
    assert len({tuple(k2.box_args(op, c)) for c in CORNERS}) == 4
    _check_k2(built, name, coords=CORNERS[corner])


@pytest.mark.parametrize("kernel", ["k1", "k2"])
def test_unaligned_operands_take_narrow_copies(built, kernel):
    """Operands only 4-byte aligned: the wrapper's alignment picks a source
    of 4-byte copies, which runs on them and is bitwise equal too."""
    assert k1.ptr_alignment(_inputs([(3, 5)], 0, offset=1)) == 4
    assert k1.ptr_alignment(_inputs([(3, 5)], 0, offset=2)) == 8
    assert k1.ptr_alignment(_inputs([(3, 5)], 0, offset=4)) == 16
    (_, path), = built[kernel, "unaligned"]
    assert ", 16);" not in path.with_suffix(".cpp").read_text()
    (_check_k1 if kernel == "k1" else _check_k2)(built, "unaligned", offset=1)


def test_occupancy_queries_are_exported(built):
    for kernel, symbol in (("k1", "k1_apply_occupancy"), ("k2", "k2_epoch_occupancy")):
        (_, path), = built[kernel, "unaligned"]
        fn = getattr(ctypes.CDLL(str(path)), symbol)
        fn.argtypes = [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        ctas = ctypes.c_int(0)
        assert fn(ctypes.addressof(ctas)) == 0 and ctas.value == 1


def _pool_inputs(shapes, seed):
    """Seeded ``[POOL_SLOTS, *shape]`` operands, 16-byte aligned bases."""
    return _inputs([(POOL_SLOTS,) + tuple(sh) for sh in shapes], seed)


@pytest.mark.parametrize("name", K1_POOL_CASES)
def test_k1_pooled_source_on_host_matches_plain_and_solo_launches(built, name):
    """One K1 launch with a slot count of 3 over ``[3, *shape]`` operands:
    every slot bitwise equal to the plain version of the pool and to a
    launch of the same source on that slot alone."""
    for n, (apply_op, path) in enumerate(built["k1-pool", name]):
        _, shapes, origins, rb = _spec(apply_op)
        arrays = _pool_inputs(shapes, seed=n)
        assert k1.ptr_alignment(arrays, rb.rank) == _pool_align(shapes, rb.rank)
        got = _run(path, "k1_apply_launch", arrays, [rb.shape] * len(apply_op.results),
                   slots=POOL_SLOTS)
        want = eval_apply_body(apply_op, arrays, origins, rb)
        assert all(tuple(w.shape) == (POOL_SLOTS,) + tuple(rb.shape) for w in want)
        for b in range(POOL_SLOTS):
            solo = _run(path, "k1_apply_launch", [a[b].clone() for a in arrays],
                        [rb.shape] * len(apply_op.results))
            for g, w, o in zip(got, want, solo):
                assert torch.equal(g[b], w[b]) and torch.equal(g[b], o)


def test_k1_pooled_parts_write_their_slice_of_every_slot(built):
    """The overlap path's parts launched with a slot count of 3 into one
    ``[3, *combine]`` result (each part a strided view, its slot stride
    the combine's size): each slot's slices bitwise the plain version, the
    points of no part still NaN in every slot."""
    parts = built["k1-part-pool", "heat2d-so4-zero-overlap-2x2"]
    (comb,) = {u.operation for (a, _), _ in parts for u in a.results[0].uses}
    cb = comb.result_bounds
    buf = torch.full((POOL_SLOTS,) + tuple(cb.shape), float("nan"))
    want = torch.full((POOL_SLOTS,) + tuple(cb.shape), float("nan"))
    inputs = {}
    for (apply_op, strides), path in parts:
        _, shapes, origins, rb = _spec(apply_op)
        arrays = [inputs.setdefault((o, s), _pool_inputs([s], seed=len(inputs))[0])
                  for o, s in zip(apply_op.operands, shapes)]
        idx = (slice(None),) + tuple(
            slice(l - c, l - c + n) for l, c, n in zip(rb.lb, cb.lb, rb.shape))
        view = buf[idx]
        assert tuple(view.stride()[1:]) == tuple(strides[0])
        fn = getattr(ctypes.CDLL(str(path)), "k1_apply_launch")
        fn.argtypes = ([ctypes.c_void_p] * (len(arrays) + 1) + [ctypes.c_int, ctypes.c_longlong]
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        assert fn(*[x.data_ptr() for x in arrays], view.data_ptr(), POOL_SLOTS, view.stride(0),
                  None) == 0
        want[idx] = eval_apply_body(apply_op, arrays, origins, rb)[0]
    assert torch.equal(buf.isnan(), want.isnan())
    assert torch.equal(torch.nan_to_num(buf), torch.nan_to_num(want))


@pytest.mark.parametrize("name", sorted(K2_POOL_CASES))
def test_k2_pooled_source_on_host_matches_plain_and_solo_launches(built, name):
    """One K2 launch with a slot count of 3 over ``[3, *bounds]`` operands
    (heat's fused masks, wave's overhang escape, a rank's box of a 2×2
    mesh): every slot bitwise equal to the plain version of the pool and
    to a launch on that slot alone."""
    ((op, tile, coords), path), = built["k2-pool", name]
    shapes = [a.type.bounds.shape for a in op.body.args]
    arrays = _pool_inputs(shapes, seed=2)
    assert k1.ptr_alignment(arrays, len(shapes[0])) == _pool_align(shapes, len(shapes[0]))
    outs = [r.type.bounds.shape for r in op.results]
    boxes = k2.box_args(op, coords)
    got = _run(path, "k2_epoch_launch", arrays, outs, boxes, slots=POOL_SLOTS)
    want = k2._emit_region(op, arrays, k2.region_masks(op, "cpu", coords),
                           lambda v: v.type.bounds)
    for b in range(POOL_SLOTS):
        solo = _run(path, "k2_epoch_launch", [a[b].clone() for a in arrays], outs, boxes)
        for g, w, o in zip(got, want, solo):
            assert torch.equal(g[b], w[b]) and torch.equal(g[b], o)


def _scratch_launch(op, tile, forced, path, arrays, coords=None, slots=1, ctas=None):
    """One launch of a K2 scratch source, by default on as many CTAs as its
    plan sizes its scratch for (at most one a (slot, tile) pair)."""
    plan = k2.plan_epoch(op, tile, forced, stream=False)
    assert plan.ctas > 0
    ctas = min(plan.ctas, slots * plan.n_tiles) if ctas is None else ctas
    return _run(path, "k2_epoch_launch", arrays, [r.type.bounds.shape for r in op.results],
                k2.box_args(op, coords), slots,
                scratch=(k2._storage(op, plan).scratch_floats, ctas))


def _plain(op, arrays, coords=None):
    return k2._emit_region(op, arrays, k2.region_masks(op, "cpu", coords), lambda v: v.type.bounds)


@pytest.mark.parametrize("name", sorted(K2_SCRATCH_CASES))
def test_k2_scratch_source_on_host_matches_plain_version(built, name):
    """K2 with buffers in device memory, its CTAs looping over the tiles,
    bitwise equal to its plain version: heat so4 k=8 and wave so8 k=4 in
    3-D (no shared-memory plan fits; wave's carried escape over [-r, n+r)
    from frames in scratch), every buffer forced off chip, and a rank's
    keep box on a 2×2×1 mesh.  Scratch and shared memory are NaN before
    every tile."""
    ((op, tile, forced, coords), path), = built["k2-scratch", name]
    plan = k2.plan_epoch(op, tile, forced, stream=False)
    st = k2._storage(op, plan)
    assert plan.ctas and st.scratch_floats and st.in_place
    assert forced or plan.ctas < plan.n_tiles  # so a CTA takes several tiles
    assert (st.smem_bytes == 0) == forced
    if not forced:  # no plan of shared memory alone fits
        with pytest.raises(ValueError, match="shared memory"):
            k2.plan_epoch(op, plan.tile)
    arrays = _inputs([a.type.bounds.shape for a in op.body.args], seed=3)
    got = _scratch_launch(op, tile, forced, path, arrays, coords)
    want = _plain(op, arrays, coords)
    assert len(got) == len(want) == len(op.results)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_k2_scratch_forced_equals_shared_memory_on_the_same_tile(built):
    """3-D heat so4 k=2 with every buffer in device memory and the same
    epoch at the same tile in shared memory only: bitwise equal."""
    ((op, tile, _, _), path), = built["k2-scratch", "heat3d-so4-k2-forced"]
    ((op_s, tile_s), path_s), = built["k2", "heat3d-so4-k2"]
    assert tile == tile_s and k2.plan_epoch(op_s, tile_s).ctas == 0
    arrays = _inputs([a.type.bounds.shape for a in op.body.args], seed=4)
    (got,) = _scratch_launch(op, tile, True, path, arrays)
    (shared,) = _run(path_s, "k2_epoch_launch", arrays, [op_s.results[0].type.bounds.shape],
                     k2.box_args(op_s))
    assert torch.equal(got, shared) and torch.equal(got, _plain(op, arrays)[0])


@pytest.mark.parametrize("ctas", [1, 3])
def test_k2_scratch_grid_smaller_than_the_tiles(built, ctas):
    """A scratch launch on fewer CTAs than tiles (one CTA takes them all,
    or three take about a third each): bitwise the plain version; the
    launcher refuses no CTAs and more than its plan sized."""
    ((op, tile, forced, coords), path), = built["k2-scratch", "wave3d-so8-k4"]
    arrays = _inputs([a.type.bounds.shape for a in op.body.args], seed=5)
    got = _scratch_launch(op, tile, forced, path, arrays, ctas=ctas)
    for g, w in zip(got, _plain(op, arrays)):
        assert torch.equal(g, w)
    plan = k2.plan_epoch(op, tile, forced, stream=False)
    floats = k2._storage(op, plan).scratch_floats
    outs = [r.type.bounds.shape for r in op.results]
    for bad in (0, plan.ctas + 1):
        _run(path, "k2_epoch_launch", arrays, outs, k2.box_args(op), scratch=(floats, bad),
             status=1)


def test_k2_scratch_pooled_source_matches_plain_and_solo_launches(built):
    """A scratch source launched with a slot count of 3 over ``[3,
    *bounds]`` operands on 5 CTAs, each looping over (slot, tile) pairs of
    several slots: each slot bitwise equal to the plain version and to a
    launch on that slot alone."""
    ((op, tile, forced, _), path), = built["k2-scratch", "heat3d-so4-k2-forced"]
    arrays = _pool_inputs([a.type.bounds.shape for a in op.body.args], seed=6)
    assert k2.plan_epoch(op, tile, forced).n_tiles == 12
    got = _scratch_launch(op, tile, forced, path, arrays, slots=POOL_SLOTS, ctas=5)
    want = _plain(op, arrays)
    for b in range(POOL_SLOTS):
        solo = _scratch_launch(op, tile, forced, path, [a[b].clone() for a in arrays])
        for g, w, o in zip(got, want, solo):
            assert torch.equal(g[b], w[b]) and torch.equal(g[b], o)


@pytest.mark.parametrize("name", sorted(K2_STREAM_CASES))
def test_k2_stream_source_on_host_matches_plain_version(built, name):
    """K2's streaming plans, every CTA walking its tile's planes through
    rings of shared memory (NaN until written), bitwise equal to the plain
    version: heat so4 k=8 and wave so8 k=4 (wave's older field read at a
    deeper lag than its taps, its carried escape over [-r, n+r) written as
    the stream passes its first and last planes), heat so4 k=2, wave in
    dim-0 segments, and a rank's keep box on a 2×2×1 mesh."""
    ((op, stream, coords), path), = built["k2-stream", name]
    plan = k2.plan_epoch(op, stream=stream)
    st = k2._storage(op, plan)
    assert plan.stream and st.smem_bytes <= k2.SMEM_PER_BLOCK
    assert (plan.grid[0] > 1) == name.endswith("segments")
    assert "streaming plan" in path.with_suffix(".cpp").read_text()
    if name.startswith("wave"):
        carried = [e for e in op.results if e.type.bounds.lb[0] < plan.core.lb[0]]
        assert carried  # an escape wider than the core along dim 0
    arrays = _inputs([a.type.bounds.shape for a in op.body.args], seed=7)
    got = _run(path, "k2_epoch_launch", arrays, [r.type.bounds.shape for r in op.results],
               k2.box_args(op, coords))
    want = _plain(op, arrays, coords)
    assert len(got) == len(want) == len(op.results)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_k2_stream_equals_tiled_on_the_same_minor_tile(built):
    """3-D heat so4 k=2 streamed at a 5×8 minor tile and tiled at 4×5×8 in
    shared memory: bitwise equal, and to the plain version."""
    ((op, stream, _), path), = built["k2-stream", "heat3d-so4-k2"]
    ((op_t, tile), path_t), = built["k2", "heat3d-so4-k2"]
    assert tile[1:] == stream and not k2.plan_epoch(op_t, tile).stream
    arrays = _inputs([a.type.bounds.shape for a in op.body.args], seed=8)
    (got,) = _run(path, "k2_epoch_launch", arrays, [op.results[0].type.bounds.shape],
                  k2.box_args(op))
    (tiled,) = _run(path_t, "k2_epoch_launch", arrays, [op_t.results[0].type.bounds.shape],
                    k2.box_args(op_t))
    assert torch.equal(got, tiled) and torch.equal(got, _plain(op, arrays)[0])


@pytest.mark.parametrize("name", ["heat3d-so4-k2", "wave3d-so4-k2-segments"])
def test_k2_stream_pooled_source_matches_plain_and_solo_launches(built, name):
    """A streaming source launched with a slot count of 3 over ``[3,
    *bounds]`` operands: each slot bitwise equal to the plain version and
    to a launch on that slot alone."""
    ((op, _, _), path), = built["k2-stream", name]
    shapes = [a.type.bounds.shape for a in op.body.args]
    arrays = _pool_inputs(shapes, seed=9)
    outs = [r.type.bounds.shape for r in op.results]
    got = _run(path, "k2_epoch_launch", arrays, outs, k2.box_args(op), slots=POOL_SLOTS)
    want = _plain(op, arrays)
    for b in range(POOL_SLOTS):
        solo = _run(path, "k2_epoch_launch", [a[b].clone() for a in arrays], outs, k2.box_args(op))
        for g, w, o in zip(got, want, solo):
            assert torch.equal(g[b], w[b]) and torch.equal(g[b], o)
