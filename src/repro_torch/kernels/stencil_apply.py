"""Kernel K1: one ``stencil.apply`` as a hand-written CUDA kernel for Hopper.

Replaces the Pallas TPU kernel ``repro/kernels/stencil_apply.py:
build_apply_kernel`` (its ``pl.pallas_call``; entry ``run_apply_pallas``).
It computes what that kernel computes — the apply's point-function DAG at
every point of the result bounds, one or more float32 results — but is not
carried over block by block: there is no VMEM window and no tile budget.

Code generation.  :func:`emit_apply_cuda` turns one apply, at one set of
operand shapes and origins, into CUDA C++: a kernel with one thread per
result point on a flat 1-D grid (64-bit index, minor dimension fastest, so
loads and stores coalesce), each ``stencil.access`` a load at a constant
offset, the DAG in body order with one float32 operation per IR op, and
constants as exact bit patterns.  Shapes, strides and offsets are baked in
as constants.  The kernel is built with ``-fmad=false`` so that ``a*b+c``
stays two rounded operations, as the plain version (``core.lowering.
eval_apply_body``) computes it: on the card the two agree bitwise for
``+ - * /`` programs such as heat and wave.

What bounds it on an H100: device-memory bytes.  Per call the least work
is to read each operand once and write each result once (a few float32
operations per byte, far below the card's balance point).  Here a
neighbour's taps are re-read through L1/L2 rather than staged; staging
tiles in shared memory with TMA is later work.

Build.  ``nvcc`` (found on ``PATH``, then under ``$CUDA_HOME/bin``, then
``/usr/local/cuda/bin``) compiles each generated source into
``build/repro_torch_kernels/<sha>.so`` at the repository root, with a
plain C launcher loaded through ``ctypes``.  Builds are cached on disk and
in the process; :func:`build` compiles many sources in parallel.
"""
from __future__ import annotations

import ctypes
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
from repro_torch.kernels import _DISPATCH

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


def emit_apply_cuda(
    apply_op: stencil.ApplyOp,
    operand_shapes: Sequence[tuple],
    operand_origins: Sequence[tuple],
    result_bounds: stencil.Bounds,
) -> str:
    """CUDA C++ source of K1 for one apply at these operand shapes and
    origins: one ``__global__`` kernel and the C launcher
    ``k1_apply_launch(in0, …, out0, …, stream) -> cudaError_t``."""
    check_windows(apply_op, operand_shapes, operand_origins, result_bounds)
    rb = result_bounds
    shape = rb.shape
    rank = rb.rank
    n_points = 1
    for s in shape:
        n_points *= s
    n_in = len(apply_op.operands)
    n_out = len(apply_op.results)
    strides = [_strides(s) for s in operand_shapes]

    src = [
        "// Generated by repro_torch/kernels/stencil_apply.py (kernel K1).",
        f"// result bounds {rb.lb}..{rb.ub}, {n_points} points",
    ]
    for k in range(n_in):
        src.append(
            f"// in{k}: shape {tuple(operand_shapes[k])}, origin "
            f"{tuple(operand_origins[k])}"
        )
    src += [f'#include "{_HEADER}"', ""]
    params = [f"const float* __restrict__ in{k}" for k in range(n_in)] + [
        f"float* __restrict__ out{j}" for j in range(n_out)
    ]
    src.append(
        "__global__ void __launch_bounds__(k1::kBlock) k1_apply("
        + ", ".join(params) + ") {"
    )
    src.append("  const int64_t p = k1::flat_index();")
    src.append(f"  if (p >= {n_points}LL) return;")
    # coordinates of the point, relative to the result bounds' lower corner
    if rank == 1:
        src.append("  const int64_t i0 = p;")
    else:
        src.append("  int64_t q = p;")
        for d in reversed(range(1, rank)):
            src.append(f"  const int64_t i{d} = q % {shape[d]}LL;")
            src.append(f"  q /= {shape[d]}LL;")
        src.append("  const int64_t i0 = q;")
    accessed = sorted(apply_op.access_extents())
    for k in accessed:
        base = sum(
            (l - g) * st for l, g, st in zip(rb.lb, operand_origins[k], strides[k])
        )
        terms = " + ".join(f"i{d} * {strides[k][d]}LL" for d in range(rank))
        src.append(f"  const int64_t b{k} = {terms} + ({base}LL);")

    src += emit_body(
        apply_op,
        load=lambda k, offset: (
            f"in{k}[b{k} + "
            f"({sum(o * st for o, st in zip(offset, strides[k]))}LL)]"
        ),
        index=lambda d: (
            f"static_cast<float>(i{d}) + {_f32_literal(float(rb.lb[d]))}"
        ),
        store=lambda j, v: f"out{j}[p] = {v};",
        indent="  ",
    )
    src.append("}")
    src.append("")

    c_params = [f"const void* in{k}" for k in range(n_in)] + [
        f"void* out{j}" for j in range(n_out)
    ]
    args = [f"static_cast<const float*>(in{k})" for k in range(n_in)] + [
        f"static_cast<float*>(out{j})" for j in range(n_out)
    ]
    src += [
        f"K1_EXPORT int {_LAUNCHER}(" + ", ".join(c_params + ["void* stream"]) + ") {",
        f"  const unsigned int blocks = k1::blocks_for({n_points}LL);",
        "  if (blocks == 0u) return static_cast<int>(cudaErrorInvalidValue);",
        "  k1_apply<<<blocks, k1::kBlock, 0, static_cast<cudaStream_t>(stream)>>>(",
        "      " + ", ".join(args) + ");",
        "  return k1::launch_status();",
        "}",
        "",
    ]
    return "\n".join(src)


# --------------------------------------------------------------------------
# Build and load
# --------------------------------------------------------------------------

_LIBS: dict = {}  # generated source -> loaded ctypes launcher
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


def _kernel_for(apply_op, shapes, origins, result_bounds):
    key = (tuple(shapes), tuple(tuple(o) for o in origins), result_bounds)
    with _LIBS_LOCK:
        per_op = _BOUND.setdefault(apply_op, {})
        fn = per_op.get(key)
    if fn is None:
        source = emit_apply_cuda(apply_op, shapes, origins, result_bounds)
        fn = _launcher(source, len(shapes) + len(apply_op.results) + 1)
        with _LIBS_LOCK:
            per_op[key] = fn
    return fn


def _launcher(source: str, n_args: int, symbol: str = _LAUNCHER):
    """The C launcher ``symbol`` of a generated source, built on first use
    and loaded once per process; every argument is a pointer."""
    with _LIBS_LOCK:
        fn = _LIBS.get(source)
        if fn is None:
            (path,) = build([source])
            lib = ctypes.CDLL(str(path))
            fn = getattr(lib, symbol)
            fn.argtypes = [ctypes.c_void_p] * n_args
            fn.restype = ctypes.c_int
            _LIBS[source] = fn
    return fn


# --------------------------------------------------------------------------
# Entry point
# --------------------------------------------------------------------------


def run_apply_cuda(
    apply_op: stencil.ApplyOp,
    arrays: Sequence[torch.Tensor],
    origins: Sequence[tuple],
    result_bounds: stencil.Bounds,
    device: Optional[torch.device] = None,
) -> list:
    """Entry point used by the lowering's ``cuda`` backend.

    CPU tensors go through the plain version (``eval_apply_body``); CUDA
    tensors go through the kernel, or the call raises.  ``device`` is only
    read when the apply has no operands.  Each call counts in
    ``dispatch_stats().apply_calls``, each launch in ``apply_launches``.
    """
    from repro_torch.core.lowering import eval_apply_body

    _DISPATCH.apply_calls += 1
    dev = arrays[0].device if arrays else torch.device(device or "cpu")
    shapes = [tuple(a.shape) for a in arrays]
    for k, a in enumerate(arrays):
        if a.device != dev:
            raise ValueError(f"operand {k} on {a.device}, operand 0 on {dev}")
        if a.dtype != torch.float32:
            raise TypeError(f"operand {k} is {a.dtype}; K1 takes float32")
    if dev.type == "cpu":
        check_windows(apply_op, shapes, origins, result_bounds)
        return eval_apply_body(apply_op, arrays, origins, result_bounds, device=dev)
    if dev.type != "cuda":
        raise ValueError(f"K1 runs on CUDA or (plain version) CPU, not {dev}")
    for k, a in enumerate(arrays):
        if not a.is_contiguous():
            raise ValueError(f"operand {k} is not contiguous")
    shape = result_bounds.shape
    outs = [
        torch.empty(shape, dtype=torch.float32, device=dev)
        for _ in apply_op.results
    ]
    if outs[0].numel() == 0:
        check_windows(apply_op, shapes, origins, result_bounds)
        return outs
    # the windows are checked when the source is emitted, once per shape
    fn = _kernel_for(apply_op, shapes, origins, result_bounds)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = fn(
            *[a.data_ptr() for a in arrays], *[o.data_ptr() for o in outs], stream
        )
    if status != 0:
        raise RuntimeError(
            f"K1 launch failed with CUDA error {status} (result shape {shape})"
        )
    _DISPATCH.apply_launches += 1
    return outs
