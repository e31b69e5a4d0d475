# Copied from src/repro/frontends/psyclone_like.py with repro. renamed to repro_torch.; keep its logic in step with that file.
"""PSyclone-like loop frontend with stencil *recognition* (paper sec. 5.2).

PSyclone parses Fortran loop nests and recognizes stencils, which are then
"represented in the PSy-IR dialect which is then lowered to SSA form" and
on into the shared stencil dialect.  Here the kernel source is a Python
function whose body is a sequence of whole-array loop-nest assignments —
the same DAG-of-array-statements shape as the NEMO/PW-advection kernels —
and recognition happens on the Python AST:

    def pw_advect(su, sv, sw, u, v, w):
        su[i, j, k] = u[i, j, k] * (w[i, j, k - 1] - w[i - 1, j, k]) * 0.5
        sv[i, j, k] = v[i, j, k] * (w[i, j, k + 1] - w[i, j - 1, k]) * 0.5
        sw[i, j, k] = w[i, j, k] * (u[i, j, k] + v[i, j, k])

    prog = recognize(pw_advect, shape=(64, 64, 32))   # repro_torch.api.Program
    step = repro_torch.api.compile(prog, target)

Index expressions must be loop indices ± integer constants — exactly the
affine accesses PSyclone's stencil recognizer accepts.  Assignments to a
name that is later read become *intermediate temps* (chained applies —
tracer advection's "18 individual stencil regions due to dependencies");
the fusion pass then merges what dependencies allow, reproducing the
paper's PW-advection 3→1 fusion.
"""
from __future__ import annotations

import ast
import inspect
import textwrap
from typing import Callable, Optional, Sequence

from repro_torch.api import Program
from repro_torch.core import ir
from repro_torch.core.builder import ApplyArgHandle, Expr, IRBuilder, build_apply
from repro_torch.core.dialects import stencil

_INDEX_NAMES = ("i", "j", "k", "l")


class RecognitionError(Exception):
    pass


def recognize(
    kernel: Callable,
    shape: Sequence[int],
    boundary: str = "zero",
) -> Program:
    """Recognize a loop-style kernel function into a ``repro_torch.api.Program``."""
    func_ir = build_stencil_func(kernel, shape)
    names = [
        a.name_hint for a in func_ir.body.args
        if isinstance(a.type, stencil.FieldType)
    ]
    return Program(
        func_ir,
        boundary=boundary,
        field_names=names,
        name=func_ir.sym_name,
    )


def build_stencil_func(kernel: Callable, shape: Sequence[int]) -> ir.FuncOp:
    src = textwrap.dedent(inspect.getsource(kernel))
    tree = ast.parse(src)
    fdef = tree.body[0]
    if not isinstance(fdef, ast.FunctionDef):
        raise RecognitionError("expected a function definition")
    params = [a.arg for a in fdef.args.args]
    ndim = len(shape)
    idx_names = _INDEX_NAMES[:ndim]
    core = stencil.Bounds.from_shape(tuple(shape))

    # classify statements
    stmts: list[tuple[str, ast.expr]] = []
    for node in fdef.body:
        if isinstance(node, ast.Expr) and isinstance(node.value, ast.Constant):
            continue  # docstring
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            raise RecognitionError(
                f"line {node.lineno}: only single-target array assignments "
                "are recognizable as stencils"
            )
        tgt = node.targets[0]
        name, off = _parse_access(tgt, idx_names)
        if any(o != 0 for o in off):
            raise RecognitionError(
                f"line {node.lineno}: stores must be at the loop point "
                f"(got offset {off})"
            )
        stmts.append((name, node.value))

    written = [n for n, _ in stmts]
    read_names: set[str] = set()
    for _, rhs in stmts:
        read_names |= _array_reads(rhs, idx_names)

    # function arguments that are read before (or never) written are inputs;
    # every written argument is also an output field.
    input_fields = [
        p for p in params if p in read_names and p not in written
    ] + [p for p in params if p in written and _read_before_write(p, stmts, idx_names)]
    output_fields = [p for p in params if p in written]

    arg_names = list(dict.fromkeys(input_fields + output_fields))
    func = ir.FuncOp(
        f"psy_{kernel.__name__}",
        [stencil.FieldType(core) for _ in arg_names],
    )
    for n, a in zip(arg_names, func.body.args):
        a.name_hint = n
    field_of = {n: a for n, a in zip(arg_names, func.body.args)}

    # value environment: name -> temp SSA value (loaded field or apply result)
    env: dict[str, ir.SSAValue] = {}

    def value_of(name: str) -> ir.SSAValue:
        if name not in env:
            if name not in field_of:
                raise RecognitionError(f"unknown array '{name}'")
            load = func.body.add_op(stencil.LoadOp(field_of[name]))
            env[name] = load.results[0]
        return env[name]

    for name, rhs in stmts:
        reads = sorted(_array_reads(rhs, idx_names))
        operands = [value_of(r) for r in reads]
        index_of = {r: k for k, r in enumerate(reads)}

        def body(b: IRBuilder, *handles: ApplyArgHandle) -> Expr:
            return _emit_expr(rhs, b, handles, index_of, idx_names)

        apply_op = build_apply(func.body, operands, core, body)
        env[name] = apply_op.results[0]

    for name in output_fields:
        func.body.add_op(stencil.StoreOp(env[name], field_of[name], core))
    func.body.add_op(ir.ReturnOp([]))
    ir.verify_module(func)
    return func


# -- AST helpers -------------------------------------------------------------


def _parse_access(node: ast.expr, idx_names) -> tuple[str, tuple]:
    """``u[i-1, j, k+2]`` → ("u", (-1, 0, +2))."""
    if not isinstance(node, ast.Subscript) or not isinstance(node.value, ast.Name):
        raise RecognitionError(f"not an array access: {ast.dump(node)}")
    name = node.value.id
    idx = node.slice
    elts = idx.elts if isinstance(idx, ast.Tuple) else [idx]
    if len(elts) != len(idx_names):
        raise RecognitionError(
            f"access to '{name}' has {len(elts)} indices, expected {len(idx_names)}"
        )
    offsets = []
    for e, expected in zip(elts, idx_names):
        offsets.append(_parse_index(e, expected, name))
    return name, tuple(offsets)


def _parse_index(e: ast.expr, expected: str, arr: str) -> int:
    if isinstance(e, ast.Name):
        if e.id != expected:
            raise RecognitionError(
                f"'{arr}': index '{e.id}' where '{expected}' expected — "
                "non-affine or transposed accesses are not recognizable"
            )
        return 0
    if isinstance(e, ast.BinOp) and isinstance(e.left, ast.Name):
        if e.left.id != expected or not isinstance(e.right, ast.Constant):
            raise RecognitionError(f"'{arr}': unrecognizable index {ast.dump(e)}")
        c = int(e.right.value)
        if isinstance(e.op, ast.Add):
            return c
        if isinstance(e.op, ast.Sub):
            return -c
    raise RecognitionError(f"'{arr}': index must be <loop-var> ± <const>")


def _array_reads(node: ast.expr, idx_names) -> set:
    out: set[str] = set()
    for sub in ast.walk(node):
        if isinstance(sub, ast.Subscript) and isinstance(sub.value, ast.Name):
            out.add(sub.value.id)
    return out


def _read_before_write(name: str, stmts, idx_names) -> bool:
    for tgt, rhs in stmts:
        if name in _array_reads(rhs, idx_names):
            return True
        if tgt == name:
            return False
    return False


def _emit_expr(node: ast.expr, b: IRBuilder, handles, index_of, idx_names) -> Expr:
    if isinstance(node, ast.Constant):
        return Expr(b, b.const(float(node.value)))
    if isinstance(node, ast.Subscript):
        name, off = _parse_access(node, idx_names)
        return handles[index_of[name]].at(*off)
    if isinstance(node, ast.BinOp):
        lhs = _emit_expr(node.left, b, handles, index_of, idx_names)
        rhs = _emit_expr(node.right, b, handles, index_of, idx_names)
        if isinstance(node.op, ast.Add):
            return lhs + rhs
        if isinstance(node.op, ast.Sub):
            return lhs - rhs
        if isinstance(node.op, ast.Mult):
            return lhs * rhs
        if isinstance(node.op, ast.Div):
            return lhs / rhs
        raise RecognitionError(f"unsupported operator {node.op}")
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        return -_emit_expr(node.operand, b, handles, index_of, idx_names)
    raise RecognitionError(f"unsupported expression {ast.dump(node)}")
