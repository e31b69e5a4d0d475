# Copied from src/repro/frontends/oec_like.py with repro. renamed to repro_torch.; keep its logic in step with that file.
"""Open-Earth-Compiler-like frontend: direct stencil-dialect construction
(the paper's third DSL reuses the stencil IR as its own input level).

    p = ProgramBuilder("jacobi", shape=(64, 64))
    u = p.input("u")
    out = p.output("out")
    t = p.load(u)
    r = p.apply([t], lambda b, u: (u.at(-1, 0) + u.at(1, 0)
                                   + u.at(0, -1) + u.at(0, 1)) * 0.25)
    p.store(r, out)
    prog = p.finish(boundary="periodic")          # repro_torch.api.Program
    step = repro_torch.api.compile(prog, target)
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

from repro_torch.api import Program
from repro_torch.core import ir
from repro_torch.core.builder import build_apply
from repro_torch.core.dialects import stencil


class ProgramBuilder:
    def __init__(self, name: str, shape: Sequence[int]):
        self.name = name
        self.shape = tuple(shape)
        self.core = stencil.Bounds.from_shape(self.shape)
        self._arg_types: list = []
        self._arg_names: list[str] = []
        self._pending: list[Callable[[ir.FuncOp], None]] = []
        self._finished: Optional[ir.FuncOp] = None
        self._handles: dict[str, int] = {}

    # -- declarations ----------------------------------------------------
    def input(self, name: str) -> str:
        return self._field(name)

    def output(self, name: str) -> str:
        return self._field(name)

    def _field(self, name: str) -> str:
        assert name not in self._handles, f"duplicate field {name}"
        self._handles[name] = len(self._arg_types)
        self._arg_types.append(stencil.FieldType(self.core))
        self._arg_names.append(name)
        return name

    # -- ops (recorded, materialized at finish) ---------------------------
    def load(self, field: str):
        token = _Token()

        def emit(func, env):
            op = func.body.add_op(
                stencil.LoadOp(func.body.args[self._handles[field]])
            )
            env[token] = op.results[0]

        self._pending.append(emit)
        return token

    def apply(self, args: Sequence, fn: Callable, n_results: int = 1):
        tokens = [_Token() for _ in range(n_results)]

        def emit(func, env):
            op = build_apply(
                func.body, [env[a] for a in args], self.core, fn,
                n_results=n_results if n_results > 1 else None,
            )
            for t, r in zip(tokens, op.results):
                env[t] = r

        self._pending.append(emit)
        return tokens[0] if n_results == 1 else tokens

    def store(self, value, field: str):
        def emit(func, env):
            func.body.add_op(
                stencil.StoreOp(
                    env[value], func.body.args[self._handles[field]], self.core
                )
            )

        self._pending.append(emit)

    # -- finish ------------------------------------------------------------
    def build_func(self) -> ir.FuncOp:
        func = ir.FuncOp(self.name, self._arg_types)
        env: dict = {}
        for emit in self._pending:
            emit(func, env)
        func.body.add_op(ir.ReturnOp([]))
        ir.verify_module(func)
        return func

    def finish(self, boundary: str = "zero") -> Program:
        return Program(
            self.build_func(),
            boundary=boundary,
            field_names=tuple(self._arg_names),
            name=self.name,
        )


class _Token:
    __slots__ = ()
