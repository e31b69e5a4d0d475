"""The port's tensor interpreter against the reference's JAX interpreter,
run on the same comm-lowered programs with the same numpy inputs.

Across frameworks the bar is rtol=atol=1e-5: XLA on the CPU may contract
a*b+c into one fused multiply-add, eager torch rounds each op on its own
(DESIGN.md §10).  Within torch the bar is bitwise: kernel route vs plain
route, epochs vs single steps, overlapped vs plain schedules.
"""
import numpy as np
import pytest
import torch

import _torch_programs as P
from repro import api as rapi
from repro.core.lowering import StencilInterpreter as RefInterpreter
from repro_torch import api
from repro_torch.core import ir
from repro_torch.core.dialects import dmp, stencil
from repro_torch.core.lowering import StencilInterpreter, _pad_with_bc, run_func_dataflow

TOL = dict(rtol=1e-5, atol=1e-5)
SHAPES = {1: (20,), 2: (18, 16), 3: (16, 17, 16)}  # >= 4 steps x radius 4
SCHEDULES = {
    "k1": {},
    "overlap": {"overlap": True},
    "ee2": {"exchange_every": 2},
    "ee4": {"exchange_every": 4},
}


def _run_both(ref_prog, port_prog, seed, **target):
    """One call of each package's interpreter on its local IR."""
    local_ref = rapi.compile(ref_prog, rapi.Target(jit=False, **target)).local_ir
    local = api.compile(port_prog, api.Target(device="cpu", **target)).local_ir
    rng = np.random.default_rng(seed)
    args = [
        rng.standard_normal(f.type.bounds.shape).astype(np.float32)
        for f in ref_prog.field_args
    ]
    want = RefInterpreter(local_ref, axis_sizes={}, distributed=False)(*args)
    got = {
        backend: StencilInterpreter(local, axis_sizes={}, backend=backend)(
            *[torch.tensor(a) for a in args]
        )
        for backend in ("torch", "cuda")
    }
    return args, [np.array(w) for w in want], got


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
@pytest.mark.parametrize("boundary", ["zero", "periodic"])
@pytest.mark.parametrize("rank", [1, 2, 3])
def test_interpreter_matches_reference(rank, boundary, schedule):
    build = lambda pkg: P.star_chain(pkg, SHAPES[rank], boundary, seed=rank)
    args, want, got = _run_both(
        build("repro"), build("repro_torch"), seed=rank, **SCHEDULES[schedule]
    )
    for w, t, c in zip(want, got["torch"], got["cuda"]):
        torch.testing.assert_close(t, torch.from_numpy(w), **TOL)
        assert torch.equal(t, c)  # the K1 route's plain version is the evaluator


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("boundary", ["zero", "periodic"])
def test_index_select_sqrt_exp_two_results(boundary, overlap):
    args, want, got = _run_both(
        P.mixed_ops("repro", boundary=boundary),
        P.mixed_ops("repro_torch", boundary=boundary),
        seed=3, overlap=overlap,
    )
    assert len(got["torch"]) == 2
    for w, t, c in zip(want, got["torch"], got["cuda"]):
        torch.testing.assert_close(t, torch.from_numpy(w), **TOL)
        assert torch.equal(t, c)


@pytest.mark.parametrize("boundary", ["zero", "periodic"])
@pytest.mark.parametrize("rank", [1, 2, 3])
def test_epochs_and_overlap_bitwise_within_torch(rank, boundary):
    prog = P.star_chain("repro_torch", SHAPES[rank], boundary, seed=rank)
    (u0,) = [torch.from_numpy(a) for a in P.rand_state(prog, seed=5)]
    base = api.compile(prog, api.Target(device="cpu")).time_loop((u0,), 4)
    for kw in ({"exchange_every": 2}, {"exchange_every": 4}, {"overlap": True}):
        other = api.compile(prog, api.Target(device="cpu", **kw)).time_loop((u0,), 4)
        assert torch.equal(base[0], other[0]), kw


def test_interpreter_never_writes_the_callers_tensors():
    prog = P.heat("repro_torch", (12, 12), 4)
    step = api.compile(prog, api.Target(device="cpu", exchange_every=2))
    u0 = torch.randn(12, 12, generator=torch.Generator().manual_seed(0))
    out0 = torch.full((12, 12), 7.0)
    before = (u0.clone(), out0.clone())
    step(u0, out0)
    assert torch.equal(u0, before[0]) and torch.equal(out0, before[1])


@pytest.mark.parametrize("lo,hi", [((2, 0), (1, 3)), ((7, 5), (9, 6))])
def test_periodic_pad_wraps_like_numpy(lo, hi):
    """Wrap widths up to and beyond the extent (jnp.pad mode="wrap")."""
    x = np.arange(30, dtype=np.float32).reshape(5, 6)
    grid = dmp.GridAttr((1,), ("x",), (0,))  # dim 1 undecomposed
    got = _pad_with_bc(torch.from_numpy(x), lo, hi, grid, "periodic")
    want = np.pad(np.pad(x, [(0, 0), (lo[1], hi[1])], mode="wrap"), [(lo[0], hi[0]), (0, 0)])
    np.testing.assert_array_equal(got.numpy(), want)


def test_run_func_dataflow_returns_values():
    """A value-returning comm-level function: halo_pad, then an apply."""
    from repro_torch.core.dialects import comm

    core = stencil.Bounds((0,), (6,))
    func = ir.FuncOp("dataflow", [stencil.TempType(core)])
    grid = dmp.GridAttr((), (), ())  # dim 0 undecomposed: wrapped locally
    pad = func.body.add_op(
        comm.HaloPadOp(func.body.args[0], core.grow((1,), (1,)), "periodic", grid)
    )
    from repro_torch.core.builder import build_apply

    app = build_apply(func.body, [pad.results[0]], core, lambda b, u: u.at(-1) + u.at(1))
    func.body.add_op(ir.ReturnOp([app.results[0]]))
    x = torch.arange(6, dtype=torch.float32)
    (y,) = run_func_dataflow(func, [x], axis_sizes={})
    assert torch.equal(y, torch.roll(x, 1) + torch.roll(x, -1))


def test_distributed_is_refused():
    """A function distributed over two ranks refuses the one-rank call and
    a run with too few ranks: its ranks run together (``run_ranks``)."""
    local = api.compile(P.jacobi("repro_torch"), api.Target(device="cpu")).local_ir
    interp = StencilInterpreter(local, axis_sizes={"x": 2}, distributed=True)
    x = torch.zeros(16, 16)
    with pytest.raises(ValueError, match="distributed over 2 ranks"):
        interp(x, x)
    with pytest.raises(ValueError, match="function over 2 ranks"):
        interp.run_ranks([(x, x)], [{"x": 0}])
