"""Stencil programs built by the same frontend calls in both packages.

``pkg`` is ``"repro"`` (the JAX reference) or ``"repro_torch"`` (the
port); each builder returns that package's ``Program``.  The port tests
hand the same numpy inputs to both builds and compare the outputs.
"""
from __future__ import annotations

import importlib
import os
import sys

import numpy as np


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def heat(pkg: str, shape, so: int, boundary: str = "zero"):
    """Paper fig. 7a: Eq(u.dt, 0.5 u.laplace) through the devito-like frontend."""
    d = _mod(pkg, "frontends.devito_like")
    g = d.Grid(shape=shape, extent=tuple(1.0 for _ in shape))
    u = d.TimeFunction(name="u", grid=g, space_order=so)
    return d.Operator(d.Eq(u.dt, 0.5 * u.laplace), dt=1e-5, boundary=boundary).program


def wave(pkg: str, shape, so: int, boundary: str = "zero"):
    """Paper fig. 7b: Eq(u.dt2, u.laplace), two time buffers."""
    d = _mod(pkg, "frontends.devito_like")
    g = d.Grid(shape=shape, extent=tuple(1.0 for _ in shape))
    u = d.TimeFunction(name="u", grid=g, space_order=so, time_order=2)
    return d.Operator(d.Eq(u.dt2, 1.0 * u.laplace), dt=1e-3, boundary=boundary).program


def jacobi(pkg: str, shape=(16, 16), boundary: str = "periodic"):
    """The oec-like Jacobi of the oec_like module docstring (2-D), or its
    6-point average in 3-D (``tests/dist_worker.py``'s ``_jacobi``)."""
    p = _mod(pkg, "frontends.oec_like").ProgramBuilder("jacobi", shape)
    u = p.input("u")
    out = p.output("out")
    t = p.load(u)
    if len(shape) == 2:
        r = p.apply(
            [t],
            lambda b, u: (u.at(-1, 0) + u.at(1, 0) + u.at(0, -1) + u.at(0, 1)) * 0.25,
        )
    else:
        r = p.apply(
            [t],
            lambda b, u: (
                u.at(-1, 0, 0) + u.at(1, 0, 0) + u.at(0, -1, 0)
                + u.at(0, 1, 0) + u.at(0, 0, -1) + u.at(0, 0, 1)
            ) * (1.0 / 6.0),
        )
    p.store(r, out)
    return p.finish(boundary=boundary)


def box(pkg: str, shape=(32, 32), boundary: str = "periodic"):
    """A corner-reading stencil (``tests/dist_worker.py``'s ``_box``): its
    exchanges forward corners, sequentially or as diagonal exchanges."""
    p = _mod(pkg, "frontends.oec_like").ProgramBuilder("box", shape)
    u = p.input("u")
    out = p.output("out")
    t = p.load(u)
    r = p.apply(
        [t],
        lambda b, u: u.at(-1, -1) + u.at(1, 1) * 0.5 + u.at(-1, 1) * 0.25 + u.at(0, 0),
    )
    p.store(r, out)
    return p.finish(boundary=boundary)


def star_chain(pkg: str, shape, boundary: str, seed: int = 0):
    """Two chained applies with random radius-2 taps in every dim."""
    rng = np.random.default_rng(seed)
    rank = len(shape)
    p = _mod(pkg, "frontends.oec_like").ProgramBuilder(f"chain{rank}", shape)
    u = p.input("u")
    out = p.output("out")
    values = [p.load(u)]
    for _ in range(2):
        taps = [tuple(int(o) for o in rng.integers(-2, 3, size=rank)) for _ in range(5)]
        coeffs = rng.integers(1, 8, size=len(taps)) / 16.0

        def fn(b, v, taps=taps, coeffs=coeffs):
            acc = None
            for off, c in zip(taps, coeffs):
                term = v.at(*off) * float(c)
                acc = term if acc is None else acc + term
            return acc

        values.append(p.apply([values[-1]], fn))
    p.store(values[-1], out)
    return p.finish(boundary=boundary)


def mixed_ops(pkg: str, shape=(12, 10), boundary: str = "zero"):
    """One apply using stencil.index, select_ge_zero, sqrt, exp, abs, neg
    and division, with two results stored to two fields."""
    ir = _mod(pkg, "core.ir")
    stencil = _mod(pkg, "core.dialects.stencil")
    Expr = _mod(pkg, "core.builder").Expr
    p = _mod(pkg, "frontends.oec_like").ProgramBuilder("mixed", shape)
    u = p.input("u")
    a_out = p.output("a")
    b_out = p.output("b")
    t = p.load(u)

    def unary(b, cls, e):
        return Expr(b, b.insert(cls(e.value)).results[0])

    def fn(b, v):
        idx = Expr(b, b.insert(stencil.IndexOp(0)).results[0])
        grad = v.at(1, 0) - v.at(-1, 0)
        mag = unary(b, ir.SqrtOp, unary(b, ir.AbsOp, v.at(0, 1) * v.at(0, -1)))
        sel = Expr(
            b,
            b.insert(ir.SelectGeZeroOp(grad.value, mag.value, unary(b, ir.NegOp, grad).value)).results[0],
        )
        first = sel + idx * 0.125
        second = unary(b, ir.ExpOp, v.at(0, 0) * 0.25) / (mag + 2.0)
        return first, second

    a, bb = p.apply([t], fn, n_results=2)
    p.store(a, a_out)
    p.store(bb, b_out)
    return p.finish(boundary=boundary)


def rand_state(program, seed: int = 0) -> list:
    """Seeded float32 numpy arrays for the program's input fields."""
    rng = np.random.default_rng(seed)
    outs = set(program.output_fields)
    return [
        rng.standard_normal(f.type.bounds.shape).astype(np.float32)
        for f in program.field_args
        if f not in outs
    ]


def index_chain(pkg: str, shape=(24, 20), boundary: str = "zero"):
    """Two chained applies, the first reading ``stencil.index`` along every
    dim and ``select_ge_zero``, with ``+ - * /`` only (exact in both
    packages' float32 arithmetic); fuses into one epoch at k=1."""
    stencil = _mod(pkg, "core.dialects.stencil")
    ir = _mod(pkg, "core.ir")
    Expr = _mod(pkg, "core.builder").Expr
    rank = len(shape)
    p = _mod(pkg, "frontends.oec_like").ProgramBuilder(f"index{rank}", shape)
    u = p.input("u")
    out = p.output("out")
    t = p.load(u)
    unit = [tuple(1 if k == d else 0 for k in range(rank)) for d in range(rank)]

    def first(b, v):
        acc = v.at(*([0] * rank)) * 0.5
        for d in range(rank):
            idx = Expr(b, b.insert(stencil.IndexOp(d)).results[0])
            acc = acc + idx * (0.25 / (d + 1)) - v.at(*unit[d]) / 3.0
        neg = Expr(b, b.const(0.0)) - acc
        return Expr(b, b.insert(ir.SelectGeZeroOp(acc.value, acc.value, neg.value)).results[0])

    def second(b, v):
        acc = v.at(*([0] * rank)) * 0.5
        for d in range(rank):
            back = tuple(-o for o in unit[d])
            acc = acc + (v.at(*unit[d]) + v.at(*back)) * 0.125
        return acc

    r = p.apply([p.apply([t], first)], second)
    p.store(r, out)
    return p.finish(boundary=boundary)


RANDOM_SHAPES = {1: (24,), 2: (16, 12), 3: (10, 8, 12)}


def random_program(pkg: str, seed: int, rank: int, n_applies: int, boundary: str):
    """The random apply DAG of ``_strategies.build_program`` (same numpy
    draws, same program name), built in either package and in rank 3 too:
    each apply reads 1–2 earlier values at offsets within radius 2 with
    coefficients in sixteenths; the last result is stored."""
    rng = np.random.default_rng(seed)
    shape = RANDOM_SHAPES[rank]
    p = _mod(pkg, "frontends.oec_like").ProgramBuilder(f"hyp_{seed}_{rank}_{n_applies}", shape)
    u = p.input("u")
    out = p.output("out")
    values = [p.load(u)]

    def point_fn(offsets, coeffs):
        def fn(b, *handles):
            acc = None
            for (arg_idx, off), c in zip(offsets, coeffs):
                term = handles[arg_idx].at(*off) * float(c)
                acc = term if acc is None else acc + term
            return acc

        return fn

    for _ in range(n_applies):
        n_args = int(rng.integers(1, min(2, len(values)) + 1))
        arg_ids = rng.choice(len(values), size=n_args, replace=False)
        args = [values[i] for i in arg_ids]
        taps = []
        for arg_idx in range(n_args):
            for _ in range(int(rng.integers(1, 4))):
                off = tuple(int(o) for o in rng.integers(-2, 3, size=rank))
                taps.append((arg_idx, off))
        coeffs = rng.integers(1, 8, size=len(taps)) / 16.0
        values.append(p.apply(args, point_fn(taps, coeffs)))
    p.store(values[-1], out)
    return p.finish(boundary=boundary)


def advection(pkg: str, name: str, shape, boundary: str = "periodic"):
    """Fig 10: ``name`` ("pw_advection" or "tracer_advection") of
    ``benchmarks/fig10_advection.py``, recognized by ``pkg``'s
    psyclone-like frontend."""
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
    if root not in sys.path:
        sys.path.insert(0, root)
    kernel = getattr(importlib.import_module("benchmarks.fig10_advection"), name)
    return _mod(pkg, "frontends.psyclone_like").recognize(kernel, shape, boundary=boundary)
