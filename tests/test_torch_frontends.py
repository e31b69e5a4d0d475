"""The port's psyclone-like frontend (``repro_torch.frontends.psyclone_like``)
against the reference's: the psyclone part of ``tests/test_frontends.py``
and the fig-10 kernels of ``benchmarks/fig10_advection.py``.

The same kernel functions recognized by both packages print, fingerprint
and lower to the same IR text; PW advection fuses to one apply with three
results; PW and tracer advection run within rtol=atol=1e-5 of the
reference, and over a 2×2×1 mesh of CPU ranks bitwise equal to the port's
single-device run.  ``i``, ``j``, ``k`` in the kernels below are loop
indices the recognizer reads from the source; the functions never run.
"""
import os
import sys

import numpy as np
import pytest
import torch

from repro import api as rapi
from repro.core import ir as rir
from repro.frontends import psyclone_like as rpsy
from repro_torch import api
from repro_torch.api import Target
from repro_torch.core import ir
from repro_torch.core.dialects import stencil
from repro_torch.core.passes.decompose import make_strategy_2d, make_strategy_3d
from repro_torch.dist import Mesh
from repro_torch.frontends import psyclone_like as psy

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, ROOT)

from benchmarks import fig10_advection as fig10  # noqa: E402
import chip_smoke  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def jacobi(u, out):
    out[i, j] = 0.25 * (u[i - 1, j] + u[i + 1, j] + u[i, j - 1] + u[i, j + 1])  # noqa: F821


def flux_chain(u, flux, out):
    flux[i, j] = 0.5 * (u[i + 1, j] - u[i - 1, j])  # noqa: F821
    out[i, j] = u[i, j] - 0.1 * (flux[i + 1, j] - flux[i, j])  # noqa: F821


def vertical(u, out):
    out[i, j, k] = (u[i, j, k - 1] + u[i, j, k + 1]) * 0.5  # noqa: F821


def offset_store(u, out):
    out[i + 1, j] = u[i, j]  # noqa: F821


# name -> (kernel, shape)
KERNELS = {
    "jacobi": (jacobi, (20, 20)),
    "flux-chain": (flux_chain, (16, 16)),
    "vertical-3d": (vertical, (8, 8, 8)),
    "pw-advection": (fig10.pw_advection, (16, 16, 8)),
    "tracer-advection": (fig10.tracer_advection, (16, 16, 8)),
}


@pytest.mark.parametrize("boundary", ["zero", "periodic"])
@pytest.mark.parametrize("name", list(KERNELS))
def test_recognized_program_matches_the_reference(name, boundary):
    """Same printed module, fingerprint and field names, and the same
    rank-local IR after the default pipeline."""
    kern, shape = KERNELS[name]
    ref = rpsy.recognize(kern, shape, boundary=boundary)
    port = psy.recognize(kern, shape, boundary=boundary)
    assert ir.print_module(port.func) == rir.print_module(ref.func)
    assert port.fingerprint == ref.fingerprint
    assert port.field_names == ref.field_names
    want = rapi.compile(ref, rapi.Target(jit=False))
    got = api.compile(port, Target(device="cpu"))
    assert ir.print_module(got.local_ir) == rir.print_module(want.local_ir)
    assert got.kernel_dispatches == want.kernel_dispatches


@pytest.mark.parametrize("name", ["pw_advection", "tracer_advection"])
def test_chip_smoke_runs_the_benchmark_kernels(name):
    """``chip_smoke.py`` carries its own copy of the fig-10 kernels (it may
    import nothing of the reference): the copy is the same program."""
    shape = (16, 16, 8)
    ours = psy.recognize(getattr(chip_smoke, name), shape, boundary="periodic")
    theirs = psy.recognize(getattr(fig10, name), shape, boundary="periodic")
    assert ours.fingerprint == theirs.fingerprint


def test_pw_advection_fuses_to_one_apply_with_three_results():
    prog = psy.recognize(fig10.pw_advection, (16, 16, 8), boundary="periodic")
    raw = [op for op in prog.func.body.ops if isinstance(op, stencil.ApplyOp)]
    assert len(raw) == 3
    step = api.compile(prog, Target(backend="cuda", device="cpu"))
    (fused,) = step.kernel_applies()
    assert len(fused.results) == 3
    assert step.kernel_dispatches == {"fused_epoch": 0, "apply": 1, "total": 1}


def test_recognizer_rejects_an_offset_store():
    for mod in (psy, rpsy):
        with pytest.raises(mod.RecognitionError):
            mod.recognize(offset_store, shape=(8, 8))


def _fields(prog, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(f.type.bounds.shape).astype(np.float32) for f in prog.field_args]


@pytest.mark.parametrize("boundary", ["zero", "periodic"])
@pytest.mark.parametrize("name", ["pw-advection", "tracer-advection", "flux-chain"])
def test_advection_matches_the_reference_and_distributes_bitwise(name, boundary):
    """One call on every field: within rtol=atol=1e-5 of the reference, the
    cuda route (K1's plain version here) bitwise to the torch route, and a
    2×2(×1) mesh of CPU ranks bitwise to one device."""
    kern, shape = KERNELS[name]
    ref = rpsy.recognize(kern, shape, boundary=boundary)
    port = psy.recognize(kern, shape, boundary=boundary)
    args = _fields(port, 3)
    want = [np.array(x) for x in rapi.compile(ref)(*args)]
    tensors = [torch.from_numpy(a) for a in args]
    torch_route = api.compile(port, Target(device="cpu"))(*tensors)
    got = api.compile(port, Target(backend="cuda", device="cpu"))(*tensors)
    assert len(got) == len(want) == len(port.output_fields)
    for g, t, w in zip(got, torch_route, want):
        assert torch.equal(g, t)
        torch.testing.assert_close(g, torch.from_numpy(w), **TOL)
    mesh_shape = (2, 2, 1) if len(shape) == 3 else (2, 2)
    devs = np.array([torch.device("cpu")] * 4, dtype=object).reshape(mesh_shape)
    mesh = Mesh(devs, ("x", "y", "z")[:len(shape)])
    strategy = (make_strategy_3d if len(shape) == 3 else make_strategy_2d)(mesh_shape)
    dist = api.compile(port, Target(mesh=mesh, strategy=strategy, backend="cuda"))
    for g, d in zip(got, dist(*tensors)):
        assert torch.equal(d, g)


# -------------------------------------------------------------------------
# the rest of tests/test_frontends.py: the devito-like and oec-like cases,
# the cross-frontend agreement and the time-loop rotation, on the port
# (the psyclone cases are the recognizer tests above)
# -------------------------------------------------------------------------

from repro.core.fd import laplacian_star as r_laplacian_star  # noqa: E402
from repro_torch.api import time_loop  # noqa: E402
from repro_torch.core.fd import laplacian_star  # noqa: E402
from repro_torch.frontends.devito_like import Eq, Grid, Operator, TimeFunction  # noqa: E402
from repro_torch.frontends.oec_like import ProgramBuilder  # noqa: E402

CPU = Target(device="cpu")


def np_jacobi(u, boundary="zero"):
    if boundary == "periodic":
        return 0.25 * (
            np.roll(u, 1, 0) + np.roll(u, -1, 0) + np.roll(u, 1, 1) + np.roll(u, -1, 1)
        )
    p = np.pad(u, 1)
    return 0.25 * (p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:])


def np_heat(u, alpha, dt, h, order=2, boundary="zero"):
    star = laplacian_star(2, order, spacing=h)
    assert star == r_laplacian_star(2, order, spacing=h)
    out = np.zeros_like(u)
    for off, c in star.items():
        if boundary == "periodic":
            out += c * np.roll(np.roll(u, -off[0], 0), -off[1], 1)
        else:
            r = max(abs(o) for offs in star for o in offs)
            p = np.pad(u, r)
            out += c * p[
                r + off[0] : r + off[0] + u.shape[0],
                r + off[1] : r + off[1] + u.shape[1],
            ]
    return u + dt * alpha * out


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("order", [2, 4, 8])
@pytest.mark.parametrize("boundary", ["zero", "periodic"])
def test_devito_heat_matches_numpy(order, boundary):
    shape = (32, 32)
    g = Grid(shape=shape, extent=(1.0, 1.0))
    u = TimeFunction(name="u", grid=g, space_order=order)
    dt = 1e-5
    op = Operator(Eq(u.dt, 0.7 * u.laplace), dt=dt, boundary=boundary)

    rng = np.random.default_rng(0)
    u0 = rng.standard_normal(shape).astype(np.float32)
    (got,) = op.apply(_t(u0), timesteps=3, target=CPU)

    want = u0.copy().astype(np.float64)
    for _ in range(3):
        want = np_heat(want, 0.7, dt, g.spacing[0], order=order, boundary=boundary)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=1e-6)


def test_devito_wave_equation_second_order_time():
    """u.dt2 = c²∇²u — the paper's acoustic benchmark shape (3 time slots)."""
    shape = (24, 24)
    g = Grid(shape=shape, extent=(1.0, 1.0))
    u = TimeFunction(name="u", grid=g, space_order=4, time_order=2)
    dt = 1e-4
    op = Operator(Eq(u.dt2, 1.5 * u.laplace), dt=dt, boundary="zero")

    rng = np.random.default_rng(1)
    um1 = rng.standard_normal(shape).astype(np.float32)
    u0 = rng.standard_normal(shape).astype(np.float32)
    assert len(op.zero_state(device="cpu")) == 2  # needs t-1 and t
    got = op.apply(_t(um1, u0), timesteps=1, target=CPU)[-1]  # newest buffer

    star = laplacian_star(2, 4, spacing=g.spacing[0])
    lap = np.zeros(shape)
    r = 2
    p = np.pad(u0.astype(np.float64), r)
    for off, c in star.items():
        lap += c * p[r + off[0]: r + off[0] + 24, r + off[1]: r + off[1] + 24]
    want = 2 * u0 - um1 + dt**2 * 1.5 * lap
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=1e-6)


def test_devito_3d():
    g = Grid(shape=(12, 12, 12), extent=(1.0, 1.0, 1.0))
    u = TimeFunction(name="u", grid=g, space_order=2)
    op = Operator(Eq(u.dt, u.laplace), dt=1e-6)
    u0 = np.random.default_rng(2).standard_normal((12, 12, 12)).astype(np.float32)
    (got,) = op.apply(_t(u0), timesteps=2, target=CPU)
    assert tuple(got.shape) == (12, 12, 12)
    assert torch.isfinite(got).all()


def test_devito_coupled_fields():
    """Two coupled equations (v reads u) — multiple updates per step."""
    g = Grid(shape=(16, 16))
    u = TimeFunction(name="u", grid=g, space_order=2)
    v = TimeFunction(name="v", grid=g, space_order=2)
    op = Operator(
        [Eq(u.forward, u + 0.1 * v), Eq(v.forward, v.laplace)],
        boundary="periodic",
    )
    rng = np.random.default_rng(3)
    u0 = rng.standard_normal((16, 16)).astype(np.float32)
    v0 = rng.standard_normal((16, 16)).astype(np.float32)
    got_u, got_v = op.apply(_t(u0, v0), timesteps=1, target=CPU)
    np.testing.assert_allclose(got_u.numpy(), u0 + 0.1 * v0, rtol=1e-5)


def test_oec_builder_jacobi():
    p = ProgramBuilder("jacobi", shape=(20, 20))
    u = p.input("u")
    out = p.output("out")
    t = p.load(u)
    r = p.apply(
        [t],
        lambda b, u: (u.at(-1, 0) + u.at(1, 0) + u.at(0, -1) + u.at(0, 1)) * 0.25,
    )
    p.store(r, out)
    prog = p.finish(boundary="zero")
    rng = np.random.default_rng(7)
    u0 = rng.standard_normal((20, 20)).astype(np.float32)
    (got,) = api.compile(prog, CPU)(*_t(u0, np.zeros_like(u0)))
    np.testing.assert_allclose(got.numpy(), np_jacobi(u0, "zero"), rtol=1e-5)


def test_three_frontends_agree():
    shape = (24, 24)
    rng = np.random.default_rng(8)
    u0 = rng.standard_normal(shape).astype(np.float32)
    args = _t(u0, np.zeros_like(u0))

    # 1. OEC
    p = ProgramBuilder("j", shape=shape)
    uf = p.input("u")
    of = p.output("out")
    t = p.load(uf)
    r = p.apply(
        [t],
        lambda b, u: (u.at(-1, 0) + u.at(1, 0) + u.at(0, -1) + u.at(0, 1)) * 0.25,
    )
    p.store(r, of)
    r_oec = api.compile(p.finish(boundary="periodic"), CPU)(*args)[0]

    # 2. PSyclone-like
    r_psy = api.compile(psy.recognize(jacobi, shape=shape, boundary="periodic"), CPU)(*args)[0]

    # 3. Devito-like: u.forward = jacobi average — expressed directly via taps
    g = Grid(shape=shape, extent=shape)  # spacing 1
    u = TimeFunction(name="u", grid=g, space_order=2)
    expr = (
        u.shifted(0, -1) + u.shifted(0, 1) + u.shifted(1, -1) + u.shifted(1, 1)
    ) * 0.25
    op = Operator(Eq(u.forward, expr), boundary="periodic")
    (r_dev,) = op.apply(args[:1], timesteps=1, target=CPU)

    torch.testing.assert_close(r_oec, r_psy, rtol=1e-6, atol=0)
    torch.testing.assert_close(r_oec, r_dev, rtol=1e-6, atol=0)


def test_time_loop_rotation():
    """time_loop rotates buffers oldest→newest (paper's time-buffering)."""

    def step(a, b):
        return (a + b,)

    out = time_loop(step, (torch.tensor(1.0), torch.tensor(1.0)), 5)
    # fibonacci: after 5 steps state = (f5, f6) = (8, 13)
    assert float(out[0]) == 8.0 and float(out[1]) == 13.0
