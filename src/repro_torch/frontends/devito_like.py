"""Devito-like symbolic frontend (paper sec. 5.1, listing 5).

A miniature symbolic layer in the spirit of Devito's SymPy DSL:

    grid = Grid(shape=(128, 128), extent=(1.0, 1.0))
    u = TimeFunction(name="u", grid=grid, space_order=4)
    eq = Eq(u.dt, 0.5 * u.laplace)          # mathematician-style
    op = Operator(eq, dt=1e-4)              # solves for u.forward
    state = op.zero_state()
    state = op.apply(state, timesteps=100, target=Target(backend="cuda"))
    # deep-halo epochs of 4 steps, each one launch of the epoch kernel K2
    fused = Target(backend="cuda", exchange_every=4, fused_epoch=True)
    state = op.apply(state, timesteps=100, target=fused)
    # four ranks, 2×2 (the mesh's devices may repeat)
    mesh = Mesh(np.array([torch.device("cuda")] * 4, dtype=object).reshape(2, 2), ("x", "y"))
    state = op.apply(state, timesteps=100, target=Target(
        mesh=mesh, strategy=make_strategy_2d((2, 2)), backend="cuda"))
    # the legacy spelling (DEPRECATED): mesh/strategy/options
    state = op.apply(state, timesteps=100, options=CompileOptions(backend="cuda"))

Derivatives expand to central FD coefficient taps (``repro_torch.core.fd``);
the lowering emits the shared ``stencil`` dialect and everything below
(fusion, dmp decomposition, halo exchanges, the CUDA kernel backend) is
the common stack.  Port of ``repro.frontends.devito_like``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import torch

from repro_torch import api
from repro_torch.api import Program, Target
from repro_torch.core import fd, ir
from repro_torch.core.builder import ApplyArgHandle, Expr, IRBuilder, build_apply
from repro_torch.core.dialects import stencil
from repro_torch.core.passes.decompose import SlicingStrategy
from repro_torch.core.program import CompileOptions, time_loop  # noqa: F401  (re-export)


# --------------------------------------------------------------------------
# Symbolic expressions
# --------------------------------------------------------------------------


class Node:
    def __add__(self, o):  # noqa: D105
        return BinOp("+", self, _c(o))

    __radd__ = __add__

    def __sub__(self, o):
        return BinOp("-", self, _c(o))

    def __rsub__(self, o):
        return BinOp("-", _c(o), self)

    def __mul__(self, o):
        return BinOp("*", self, _c(o))

    __rmul__ = __mul__

    def __truediv__(self, o):
        return BinOp("/", self, _c(o))

    def __neg__(self):
        return BinOp("-", Const(0.0), self)


def _c(v) -> "Node":
    return v if isinstance(v, Node) else Const(float(v))


@dataclasses.dataclass
class Const(Node):
    value: float


@dataclasses.dataclass
class BinOp(Node):
    op: str
    lhs: Node
    rhs: Node


@dataclasses.dataclass
class Tap(Node):
    """A read of ``fn`` at time offset ``t_off`` and spatial ``offsets``."""

    fn: "TimeFunction"
    t_off: int
    offsets: tuple


@dataclasses.dataclass
class Deriv(Node):
    """Unexpanded derivative; expanded at lowering with the fn's order."""

    fn: "TimeFunction"
    t_off: int
    kind: str  # "laplace" | f"dx{dim}" | f"dx2{dim}" | "dt" | "dt2"


class Grid:
    def __init__(self, shape: Sequence[int], extent: Optional[Sequence[float]] = None):
        self.shape = tuple(int(s) for s in shape)
        self.extent = tuple(float(e) for e in (extent or self.shape))
        self.spacing = tuple(e / s for e, s in zip(self.extent, self.shape))

    @property
    def ndim(self) -> int:
        return len(self.shape)


class TimeFunction(Node):
    """A time-varying field on a grid; reads default to time t, center."""

    def __init__(self, name: str, grid: Grid, space_order: int = 2, time_order: int = 1):
        self.name = name
        self.grid = grid
        self.space_order = space_order
        self.time_order = time_order

    # time taps
    @property
    def forward(self) -> Tap:
        return Tap(self, +1, tuple([0] * self.grid.ndim))

    @property
    def backward(self) -> Tap:
        return Tap(self, -1, tuple([0] * self.grid.ndim))

    def at(self, *offsets: int) -> Tap:
        return Tap(self, 0, tuple(offsets))

    def shifted(self, dim: int, k: int) -> Tap:
        off = [0] * self.grid.ndim
        off[dim] = k
        return Tap(self, 0, tuple(off))

    # derivatives (time t)
    @property
    def laplace(self) -> Deriv:
        return Deriv(self, 0, "laplace")

    @property
    def dt(self) -> Deriv:
        return Deriv(self, 0, "dt")

    @property
    def dt2(self) -> Deriv:
        return Deriv(self, 0, "dt2")

    def dx2(self, dim: int) -> Deriv:
        return Deriv(self, 0, f"dx2:{dim}")

    def dx(self, dim: int) -> Deriv:
        return Deriv(self, 0, f"dx:{dim}")

    # reading `u` plain = tap at (t, center)
    def _as_tap(self) -> Tap:
        return Tap(self, 0, tuple([0] * self.grid.ndim))


@dataclasses.dataclass
class Eq:
    lhs: Node
    rhs: Node


# --------------------------------------------------------------------------
# Operator: symbolic → stencil IR → shared stack
# --------------------------------------------------------------------------


class Operator:
    """Compiles one or more update equations into a time-steppable program.

    Supported equation shapes (per TimeFunction):
      - ``Eq(u.forward, expr)``            explicit update;
      - ``Eq(u.dt, expr)``   (time_order 1) → u⁺ = u + dt·expr;
      - ``Eq(u.dt2, expr)``  (time_order 2) → u⁺ = 2u − u⁻ + dt²·expr —
        the paper's heat / acoustic-wave benchmarks.
    """

    def __init__(
        self,
        eqs: Union[Eq, Sequence[Eq]],
        dt: float = 1.0,
        boundary: str = "zero",
    ) -> None:
        self.eqs = [eqs] if isinstance(eqs, Eq) else list(eqs)
        self.dt = float(dt)
        self.boundary = boundary
        self._build()

    # -- symbolic rewrite to explicit updates ---------------------------
    def _build(self) -> None:
        updates: list[tuple[TimeFunction, Node]] = []
        for eq in self.eqs:
            lhs, rhs = eq.lhs, eq.rhs
            if isinstance(lhs, Tap) and lhs.t_off == 1:
                updates.append((lhs.fn, rhs))
            elif isinstance(lhs, Deriv) and lhs.kind == "dt":
                u = lhs.fn
                updates.append((u, u._as_tap() + Const(self.dt) * rhs))
            elif isinstance(lhs, Deriv) and lhs.kind == "dt2":
                u = lhs.fn
                updates.append(
                    (
                        u,
                        Const(2.0) * u._as_tap()
                        - Tap(u, -1, tuple([0] * u.grid.ndim))
                        + Const(self.dt**2) * rhs,
                    )
                )
            else:
                raise ValueError(
                    "equation LHS must be u.forward, u.dt or u.dt2"
                )
        self.updates = updates
        self.grid = updates[0][0].grid

        # which time slots does each function need?
        self.slots: dict[TimeFunction, tuple[int, int]] = {}

        def scan(n: Node) -> None:
            if isinstance(n, (Tap, Deriv)):
                lo, hi = self.slots.get(n.fn, (0, 0))
                self.slots[n.fn] = (min(lo, n.t_off), max(hi, n.t_off))
            if isinstance(n, BinOp):
                scan(n.lhs)
                scan(n.rhs)

        for fn_, rhs in updates:
            self.slots.setdefault(fn_, (0, 0))
            scan(rhs)
        self._build_ir()

    # -- IR construction -------------------------------------------------
    def _build_ir(self) -> None:
        grid = self.grid
        core = stencil.Bounds.from_shape(grid.shape)
        arg_types = []
        self.arg_layout: list[tuple[TimeFunction, int]] = []  # (fn, t_off)
        for fn_, (lo, hi) in self.slots.items():
            for t in range(lo, 1):  # inputs: oldest → newest (t ≤ 0)
                arg_types.append(stencil.FieldType(core))
                self.arg_layout.append((fn_, t))
        updated = [fn_ for fn_, _ in self.updates]
        out_base = len(arg_types)
        for fn_ in updated:
            arg_types.append(stencil.FieldType(core))

        func = ir.FuncOp("devito_op", arg_types)
        loads: dict[tuple, ir.SSAValue] = {}
        for (fn_, t), arg in zip(self.arg_layout, func.body.args):
            load = func.body.add_op(stencil.LoadOp(arg))
            loads[(fn_.name, t)] = load.results[0]

        for i, (fn_, rhs) in enumerate(self.updates):
            expanded = self._expand(rhs, fn_)
            taps = _collect_taps(expanded)
            operands, index_of = [], {}
            for t in taps:
                key = (t.fn.name, t.t_off)
                if key not in index_of:
                    index_of[key] = len(operands)
                    operands.append(loads[key])

            def body(b: IRBuilder, *handles: ApplyArgHandle) -> Expr:
                return _emit(expanded, b, handles, index_of)

            apply_op = build_apply(func.body, operands, core, body)
            out_field = func.body.args[out_base + i]
            func.body.add_op(
                stencil.StoreOp(apply_op.results[0], out_field, core)
            )
        func.body.add_op(ir.ReturnOp([]))
        self.func = func
        names = [f"{fn_.name}@t{t:+d}" for fn_, t in self.arg_layout] + [
            f"{fn_.name}@t+1" for fn_ in updated
        ]
        self.program = Program(
            func, boundary=self.boundary, field_names=names, name=func.sym_name
        )

    def _expand(self, n: Node, ctx_fn: TimeFunction) -> Node:
        """Expand Deriv nodes into FD tap combinations."""
        if isinstance(n, Deriv):
            fn_ = n.fn
            h = fn_.grid.spacing
            if n.kind == "laplace":
                out: Node = Const(0.0)
                for d in range(fn_.grid.ndim):
                    offs, coeffs = fd.second_derivative(fn_.space_order, h[d])
                    for o, c in zip(offs, coeffs):
                        off = tuple(o if k == d else 0 for k in range(fn_.grid.ndim))
                        out = out + Const(c) * Tap(fn_, n.t_off, off)
                return out
            if n.kind.startswith("dx2:"):
                d = int(n.kind.split(":")[1])
                offs, coeffs = fd.second_derivative(fn_.space_order, h[d])
                out = Const(0.0)
                for o, c in zip(offs, coeffs):
                    off = tuple(o if k == d else 0 for k in range(fn_.grid.ndim))
                    out = out + Const(c) * Tap(fn_, n.t_off, off)
                return out
            if n.kind.startswith("dx:"):
                d = int(n.kind.split(":")[1])
                offs, coeffs = fd.first_derivative(
                    min(fn_.space_order, 4), h[d]
                )
                out = Const(0.0)
                for o, c in zip(offs, coeffs):
                    if c == 0.0:
                        continue
                    off = tuple(o if k == d else 0 for k in range(fn_.grid.ndim))
                    out = out + Const(c) * Tap(fn_, n.t_off, off)
                return out
            raise ValueError(f"cannot expand derivative {n.kind} on RHS")
        if isinstance(n, BinOp):
            return BinOp(n.op, self._expand(n.lhs, ctx_fn), self._expand(n.rhs, ctx_fn))
        if isinstance(n, TimeFunction):
            return n._as_tap()
        return n

    # -- execution --------------------------------------------------------
    @property
    def computation(self):
        """DEPRECATED: the old StencilComputation shim over ``.program``
        (built lazily, once — its last_local/last_timings state persists
        across accesses like the old stored attribute did)."""
        if getattr(self, "_computation", None) is None:
            from repro_torch.core.program import StencilComputation

            self._computation = StencilComputation(
                self.func, boundary=self.boundary
            )
        return self._computation

    def _target(
        self,
        mesh=None,
        strategy: Optional[SlicingStrategy] = None,
        options: Optional[CompileOptions] = None,
        target: Optional[Target] = None,
    ) -> Target:
        if target is not None:
            if mesh is not None or strategy is not None or options is not None:
                raise ValueError(
                    "pass either target= or the legacy mesh/strategy/options, "
                    "not both"
                )
            return target
        opts = options or CompileOptions()
        return opts.to_target(mesh=mesh, strategy=strategy)

    def compile_step(
        self,
        mesh=None,
        strategy: Optional[SlicingStrategy] = None,
        options: Optional[CompileOptions] = None,
        target: Optional[Target] = None,
    ):
        """Step over the *input* time buffers only; output buffers (fully
        overwritten every step) are supplied internally.  Prefer
        ``target=``; mesh/strategy/options are the legacy spelling."""
        artifact = api.compile(
            self.program, self._target(mesh, strategy, options, target)
        )
        return artifact.step()

    def zero_state(self, dtype=torch.float32, device="cuda") -> list:
        return [
            torch.zeros(self.grid.shape, dtype=dtype, device=device)
            for _ in self.arg_layout
        ]

    def apply(
        self,
        state: Sequence,
        timesteps: int,
        mesh=None,
        strategy: Optional[SlicingStrategy] = None,
        options: Optional[CompileOptions] = None,
        target: Optional[Target] = None,
    ):
        """Run ``timesteps`` with time-buffer rotation (oldest→newest).

        ``timesteps`` counts single time steps; a
        ``Target(exchange_every=k)`` artifact advances k steps per call,
        so the loop runs in epochs (``CompiledStencil.time_loop``).  With
        ``fused_epoch=True`` an epoch is one K2 launch; for wave it hands
        back the carried state and the new state, two escapes of
        different bounds, which rotate like the unfused epoch's.  With a
        distributed ``Target(mesh=…, strategy=…)`` the state is sharded
        once, stays sharded across every epoch and is gathered at the
        end.  Prefer ``target=``; mesh/strategy/options are the legacy
        spelling."""
        artifact = api.compile(
            self.program, self._target(mesh, strategy, options, target)
        )
        return artifact.time_loop(tuple(state), timesteps)


def _collect_taps(n: Node) -> list:
    out: list[Tap] = []

    def go(m: Node) -> None:
        if isinstance(m, Tap):
            out.append(m)
        elif isinstance(m, BinOp):
            go(m.lhs)
            go(m.rhs)

    go(n)
    return out


def _emit(n: Node, b: IRBuilder, handles, index_of) -> Expr:
    if isinstance(n, Const):
        return Expr(b, b.const(n.value))
    if isinstance(n, Tap):
        h = handles[index_of[(n.fn.name, n.t_off)]]
        return h.at(*n.offsets)
    if isinstance(n, TimeFunction):
        h = handles[index_of[(n.name, 0)]]
        return h.at(*([0] * n.grid.ndim))
    if isinstance(n, BinOp):
        lhs = _emit(n.lhs, b, handles, index_of)
        rhs = _emit(n.rhs, b, handles, index_of)
        return {
            "+": lambda: lhs + rhs,
            "-": lambda: lhs - rhs,
            "*": lambda: lhs * rhs,
            "/": lambda: lhs / rhs,
        }[n.op]()
    raise NotImplementedError(type(n))
