"""Distribution in the port (``repro_torch.dist`` and the interpreter's
lockstep runner), on the CPU.

Virtual ranks on ``device="cpu"`` run the port's counterpart of each
scenario of ``tests/dist_worker.py`` that this slice covers: 1-, 2- and
3-D decompositions under both boundaries, corner-reading stencils with
and without diagonal exchanges, overlap, explicit pipelines, the
``cuda`` backend (K1 and K2 take their plain versions here), wide halos,
time loops, deep-halo epochs (``exchange_every``) and fused epochs (K2,
whose keep boxes differ per rank under zero BC).  Each case is bitwise
against the port's single-device run, within rtol=atol=1e-5 of the
reference's single-device run of the same seeded numpy input, and keeps
the reference's structural asserts.

Unit tests: ``reshard``/``gather``, zero patches for ranks that receive
nothing, ``keep_box`` at every coordinate of a 2×2 mesh against the
reference's ``_boundary_keep``, ``comm.allreduce`` over ranks, Target
validation, ``time_loop`` keeping its state sharded, and the rank tags of
the interpreter's spans.
"""
import jax
import numpy as np
import pytest
import torch

import _torch_programs as P
from repro import api as rapi
from repro.core.passes import decompose as rdecompose
from repro.frontends import devito_like as rdevito
from repro_torch import api
from repro_torch.api import Target, TargetError
from repro_torch.core import ir
from repro_torch.core.dialects import comm, stencil
from repro_torch.core.lowering import RankView, StencilInterpreter, boundary_keep, keep_box
from repro_torch.core.passes.decompose import make_strategy_1d, make_strategy_2d, make_strategy_3d
from repro_torch.dist import Mesh, P as PS, ShardedTensor, gather, reshard
from repro_torch.frontends import devito_like as devito
from repro_torch.obs import trace as obs

TOL = dict(rtol=1e-5, atol=1e-5)
CPU = torch.device("cpu")


def _mesh(shape, names):
    n = int(np.prod(shape))
    return Mesh(np.array([CPU] * n, dtype=object).reshape(shape), names)


def _strategy(shape):
    return {1: make_strategy_1d, 2: make_strategy_2d, 3: make_strategy_3d}[len(shape)](
        *([shape[0]] if len(shape) == 1 else [tuple(shape)])
    )


def _names(shape):
    return ("x", "y", "z")[: len(shape)]


def _dist(mesh_shape, **kw):
    return Target(mesh=_mesh(mesh_shape, _names(mesh_shape)), strategy=_strategy(mesh_shape), **kw)


def _u0(shape, seed=42):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(a)


def _same(got, want):
    assert torch.equal(got, want), float((got - want).abs().max())


def _close_to_reference(got, want):
    torch.testing.assert_close(got, torch.from_numpy(np.array(want)), **TOL)


def _names_of(step):
    return [op.name for op in step.local_ir.body.ops]


def _starts(step):
    return sum(isinstance(op, comm.ExchangeStartOp) for op in step.local_ir.body.ops)


def _overlap_order(step):
    """The interior apply runs between the exchange starts and the wait."""
    names = _names_of(step)
    assert "comm.exchange_start" in names and "stencil.combine" in names, names
    first_apply = names.index("stencil.apply")
    assert names.index("comm.exchange_start") < first_apply < names.index("comm.wait"), names


# -------------------------------------------------------------------------
# one call over a mesh == one call on one device
# -------------------------------------------------------------------------

# name -> (builder, shape, boundary, mesh shape, target kwargs)
ONE_CALL = {
    "1d-zero": (P.jacobi, (64, 32), "zero", (8,), {}),
    "1d-periodic": (P.jacobi, (64, 32), "periodic", (8,), {}),
    "2d-zero": (P.jacobi, (32, 64), "zero", (4, 2), {}),
    "2d-periodic": (P.jacobi, (32, 64), "periodic", (4, 2), {}),
    "3d": (P.jacobi, (16, 16, 32), "periodic", (2, 2, 2), {}),
    "box": (P.box, (32, 32), "periodic", (2, 2), {}),
    "box-diagonal": (P.box, (32, 32), "periodic", (2, 2), {"diagonal": True}),
    "overlap": (P.jacobi, (32, 64), "periodic", (4, 2), {"overlap": True}),
    "overlap-zero": (P.jacobi, (32, 32), "zero", (2, 2), {"overlap": True}),
    "overlap-periodic": (P.jacobi, (32, 32), "periodic", (2, 2), {"overlap": True}),
    "overlap-box-seq": (P.box, (32, 32), "periodic", (2, 2), {"overlap": True}),
    "overlap-diagonal": (P.box, (32, 32), "periodic", (2, 2), {"overlap": True, "diagonal": True}),
    "overlap-cuda": (P.jacobi, (32, 32), "periodic", (2, 2), {"overlap": True, "backend": "cuda"}),
    "pipeline-spec": (P.jacobi, (32, 64), "periodic", (4, 2),
                      {"pipeline": "fuse,cse,dce,decompose,swap-elim,lower-comm"}),
    "cuda": (P.jacobi, (32, 64), "periodic", (4, 2), {"backend": "cuda"}),
}


@pytest.mark.parametrize("name", list(ONE_CALL))
def test_one_call_over_a_mesh(name):
    build, shape, bc, mesh_shape, kw = ONE_CALL[name]
    prog, ref_prog = build("repro_torch", shape, bc), build("repro", shape, bc)
    u0 = _u0(shape)
    backend = kw.get("backend", "torch")
    want = api.compile(prog, Target(device="cpu", backend=backend))(_t(u0), torch.zeros(shape))[0]
    step = api.compile(prog, _dist(mesh_shape, **kw))
    assert step.target.distributed and step.target.spatial_ranks == int(np.prod(mesh_shape))
    (got,) = step(_t(u0), torch.zeros(shape))
    _same(got, want)
    _close_to_reference(got, rapi.compile(ref_prog)(u0, np.zeros_like(u0))[0])
    if kw.get("overlap"):
        _overlap_order(step)
    if kw.get("diagonal"):
        # corners come from diagonal neighbours: an exchange over two axes
        assert any(len(op.axis_shifts) == 2 for op in step.local_ir.body.ops
                   if isinstance(op, comm.ExchangeStartOp))


# -------------------------------------------------------------------------
# devito-like time loops over a mesh (Operator.apply with a target)
# -------------------------------------------------------------------------


def _heat_op(mod, shape, so, coeff, dt, boundary):
    g = mod.Grid(shape=shape, extent=(1.0, 1.0))
    u = mod.TimeFunction(name="u", grid=g, space_order=so)
    return mod.Operator(mod.Eq(u.dt, coeff * u.laplace), dt=dt, boundary=boundary)


# name -> (shape, space order, coefficient, dt, boundary, steps, mesh shape)
LOOPS = {
    "wide-halo": ((64, 64), 8, 0.3, 1e-6, "periodic", 2, (4, 2)),
    "time-loop": ((64, 32), 4, 0.5, 1e-6, "zero", 20, (8,)),
}


@pytest.mark.parametrize("name", list(LOOPS))
def test_operator_apply_over_a_mesh(name):
    shape, so, coeff, dt, bc, steps, mesh_shape = LOOPS[name]
    u0 = _u0(shape, seed=3 if name == "wide-halo" else 4)
    op = _heat_op(devito, shape, so, coeff, dt, bc)
    want = op.apply([_t(u0)], timesteps=steps, target=Target(device="cpu"))[0]
    got = op.apply([_t(u0)], timesteps=steps, target=_dist(mesh_shape))[0]
    _same(got, want)
    ref = _heat_op(rdevito, shape, so, coeff, dt, bc).apply([u0], timesteps=steps)[0]
    _close_to_reference(got, ref)


# -------------------------------------------------------------------------
# deep-halo epochs over a 2×2 mesh, fused and unfused
# -------------------------------------------------------------------------

# name -> (k, boundary, target kwargs, builder)
EPOCHS = {
    "ee2-periodic": (2, "periodic", {}, P.jacobi),
    "ee4-zero": (4, "zero", {}, P.jacobi),
    "ee4-overlap": (4, "periodic", {"overlap": True}, P.jacobi),
    "ee4-overlap-zero": (4, "zero", {"overlap": True}, P.jacobi),
    "ee2-box-overlap": (2, "periodic", {"overlap": True}, P.box),
    "ee4-cuda": (4, "periodic", {"backend": "cuda"}, P.jacobi),
    "ee4-fused-zero": (4, "zero", {"backend": "cuda", "fused_epoch": True}, P.jacobi),
    "ee4-fused-periodic": (4, "periodic", {"backend": "cuda", "fused_epoch": True}, P.jacobi),
}


def _step_n(call, u0, shape, n):
    """``n`` single calls with explicit rotation (one-input programs)."""
    u = u0
    for _ in range(n):
        u = call(u, torch.zeros(shape) if isinstance(u, torch.Tensor) else np.zeros(shape, np.float32))[0]
    return u


@pytest.mark.parametrize("name", list(EPOCHS))
def test_epochs_over_a_mesh(name):
    """A depth-k epoch over 2×2 ranks (exchange once, k steps with
    redundant frame compute) equals k single-exchange steps on one device,
    bitwise; one exchange volley per epoch."""
    k, bc, kw, build = EPOCHS[name]
    shape, steps = (32, 32), 8
    prog, ref_prog = build("repro_torch", shape, bc), build("repro", shape, bc)
    u0 = _u0(shape)
    want = _step_n(api.compile(prog, Target(device="cpu")), _t(u0), shape, steps)
    backend = {"backend": kw["backend"]} if "backend" in kw else {}
    overlap = {"overlap": True} if kw.get("overlap") else {}
    base = api.compile(prog, _dist((2, 2), **backend, **overlap))
    tiled = api.compile(prog, _dist((2, 2), exchange_every=k, **kw))
    got = _step_n(tiled, _t(u0), shape, steps // k)
    _same(got, want)
    _close_to_reference(got, _step_n(rapi.compile(ref_prog), u0, shape, steps))
    assert _starts(tiled) <= _starts(base), (_starts(tiled), _starts(base))
    if kw.get("overlap"):
        _overlap_order(tiled)
    if kw.get("fused_epoch"):
        assert tiled.kernel_dispatches == {"fused_epoch": 1, "apply": 0, "total": 1}
        # time_loop over the mesh: the same result, state sharded throughout
        _same(tiled.time_loop((_t(u0),), steps)[0], want)


def test_heat_epoch_has_one_exchange_pair_per_epoch():
    """``ee-heat-epoch``: fig-7 heat on a 4-rank 1-D mesh with
    exchange_every=4 emits one exchange pair per 4-step epoch and equals
    exchange_every=1 over 32 steps."""
    shape = (64, 32)

    def build(mod):
        g = mod.Grid(shape=shape, extent=(1.0, 1.0))
        u = mod.TimeFunction(name="u", grid=g, space_order=2)
        dt = 0.1 * (g.spacing[0] ** 2) / 0.5
        return mod.Operator(mod.Eq(u.dt, 0.5 * u.laplace), dt=dt, boundary="periodic")

    u0 = _u0(shape, seed=8)
    op = build(devito)
    want = op.apply([_t(u0)], timesteps=32, target=Target(device="cpu"))[0]
    tiled = api.compile(op.program, _dist((4,), exchange_every=4))
    got = tiled.time_loop((_t(u0),), 32)[0]
    _same(got, want)
    _close_to_reference(got, build(rdevito).apply([u0], timesteps=32)[0])
    ops = tiled.local_ir.body.ops
    starts = [o for o in ops if isinstance(o, comm.ExchangeStartOp)]
    waits = [o for o in ops if isinstance(o, comm.WaitOp)]
    assert len(starts) == 2 and len(waits) == 1, (len(starts), len(waits))


def test_tile_that_does_not_divide_the_shard_is_refused():
    """``tile-shard-error``: a K2 tile that does not divide the *local*
    shard is refused at compile, naming the tile, the shard shape and the
    mesh axis; the same tile divides the whole domain on one device."""
    prog = P.jacobi("repro_torch", (64, 32), "periodic")
    bad = _dist((4,), backend="cuda", tile=(7, 32))
    with pytest.raises(TargetError) as e:
        api.compile(prog, bad)
    for needle in ("(7, 32)", "(16, 32)", "mesh axis 'x'"):
        assert needle in str(e.value)
    api.compile(prog, Target(backend="cuda", tile=(16, 32), device="cpu"))


# -------------------------------------------------------------------------
# units: sharding, exchanges, masks, reductions, validation, state, spans
# -------------------------------------------------------------------------


@pytest.mark.parametrize("spec", [PS("x", None), PS(None, "y"), PS("x", "y"), PS(None, None), PS("y", "x")])
def test_reshard_and_gather_round_trip(spec):
    mesh = _mesh((2, 2), ("x", "y"))
    a = _u0((8, 6))
    (s,) = reshard([a], mesh, [spec])
    assert isinstance(s, ShardedTensor) and s.shape == (8, 6) and len(s.shards) == 4
    local_shape = tuple(n // (2 if axis is not None else 1) for n, axis in zip((8, 6), spec))
    for r, local in enumerate(s.shards):
        assert local.is_contiguous() and local.device == mesh.device(r)
        assert tuple(local.shape) == local_shape
    assert torch.equal(gather(s), _t(a))
    t = _t(a)
    (s2,) = reshard([t], mesh, [spec])
    assert all(x.data_ptr() != t.data_ptr() for x in s2.shards)  # fresh copies
    assert reshard([s2], mesh, [spec])[0] is s2  # already laid out so
    assert torch.equal(reshard([s2], None, [spec])[0], t)  # mesh=None gathers


def test_reshard_refuses_what_it_cannot_place():
    mesh = _mesh((2, 2), ("x", "y"))
    with pytest.raises(ValueError, match="not divisible"):
        reshard([np.zeros((5, 4), np.float32)], mesh, [PS("x", None)])
    with pytest.raises(ValueError, match="not an axis"):
        reshard([np.zeros((4, 4), np.float32)], mesh, [PS("z", None)])
    with pytest.raises(TypeError, match="float32"):
        reshard([np.zeros((4, 4))], mesh, [PS("x", None)])
    with pytest.raises(ValueError, match="names a mesh axis twice"):
        reshard([np.zeros((4, 4), np.float32)], mesh, [PS("x", "x")])


def test_mesh_coordinates_are_row_major():
    mesh = _mesh((2, 3), ("x", "y"))
    assert mesh.shape == {"x": 2, "y": 3} and mesh.size == 6
    assert [tuple(mesh.coords(r).values()) for r in range(6)] == [
        (0, 0), (0, 1), (0, 2), (1, 0), (1, 1), (1, 2)]
    with pytest.raises(ValueError, match="axis names"):
        Mesh(np.array([CPU] * 4, dtype=object).reshape(2, 2), ("x",))


def _first_exchange(bc):
    step = api.compile(P.jacobi("repro_torch", (8, 4), bc), _dist((2,)))
    (op,) = [o for o in step.local_ir.body.ops if isinstance(o, comm.ExchangeStartOp)][:1]
    return step, op


@pytest.mark.parametrize("bc", ["zero", "periodic"])
def test_exchange_gives_zero_patches_to_ranks_that_receive_nothing(bc):
    """``lax.ppermute`` semantics: a rank whose source lies off the grid
    (zero BC) gets a zero patch; every delivered patch is a copy of the
    sender's rectangle, sharing no storage with it."""
    step, op = _first_exchange(bc)
    shape = tuple(op.temp.type.bounds.shape)
    views = [RankView(r, {"x": r}, CPU) for r in range(2)]
    for v in views:
        v.env[op.temp] = torch.full(shape, float(v.rank + 1))
    step._interp._exec_exchange(op, views)
    (axis, shift), = op.axis_shifts
    assert axis == "x" and shift in (-1, 1)
    src_of = {r: r + shift for r in range(2)}
    for v in views:
        patch = v.env[op.results[0]]
        assert tuple(patch.shape) == tuple(op.size)
        src = src_of[v.rank] % 2 if bc == "periodic" else src_of[v.rank]
        if 0 <= src < 2:
            assert torch.equal(patch, torch.full(tuple(op.size), float(src + 1)))
            assert patch.data_ptr() != views[src].env[op.temp].data_ptr()
        else:
            assert torch.equal(patch, torch.zeros(tuple(op.size)))


def _masks_of_epoch(pkg_passes, pkg_prog, pkg_decompose):
    spec = "fuse,cse,dce,decompose,swap-elim,temporal-tile{k=4},lower-comm"
    ctx = pkg_passes.PipelineContext(
        strategy=pkg_decompose.make_strategy_2d((2, 2)), boundary="zero", exchange_every=4
    )
    local = pkg_passes.PassManager(pkg_passes.build_pipeline(spec, ctx)).run(pkg_prog.func)
    return local, [op for op in local.body.ops if op.name == "comm.boundary_mask"]


@pytest.mark.parametrize("coords", [(0, 0), (0, 1), (1, 0), (1, 1)])
def test_keep_box_matches_the_reference_at_every_coordinate(coords, monkeypatch):
    """The port's keep mask at each coordinate of a 2×2 mesh equals the
    reference's ``_boundary_keep`` with ``lax.axis_index`` reading the
    same coordinate, and is the box ``keep_box`` names."""
    from repro.core import lowering as rlowering
    from repro.core import passes as rpasses
    from repro_torch.core import passes as tpasses
    from repro_torch.core.passes import decompose as tdecompose

    shape = (16, 12)
    _, masks = _masks_of_epoch(tpasses, P.heat("repro_torch", shape, 4), tdecompose)
    rlocal, rmasks = _masks_of_epoch(rpasses, P.heat("repro", shape, 4), rdecompose)
    assert len(masks) == len(rmasks) == 3
    at = dict(zip(("x", "y"), coords))
    monkeypatch.setattr(jax.lax, "axis_index", lambda name: at[name])
    rinterp = rlowering.StencilInterpreter(rlocal, axis_sizes={"x": 2, "y": 2}, distributed=True)
    for op, rop in zip(masks, rmasks):
        vshape = tuple(op.temp.type.bounds.shape)
        keep = torch.broadcast_to(boundary_keep(op, vshape, CPU, at), vshape)
        want = np.broadcast_to(np.asarray(rinterp._boundary_keep(rop, vshape)), vshape)
        assert np.array_equal(keep.numpy(), want)
        vb = op.temp.type.bounds
        for d, (lo, hi) in keep_box(op, at).items():
            n = shape[d] // 2
            assert (lo, hi) == (-coords[d] * n, -coords[d] * n + 2 * n)
            assert vb.lb[d] < lo or hi < vb.ub[d]  # the box cuts this value


def test_allreduce_sums_over_the_ranks_of_its_axes():
    """``comm.allreduce`` over ``x`` on a 2×2 mesh: each rank gets the sum
    of its column's two values, in rank order."""
    core = stencil.Bounds((0, 0), (2, 3))
    func = ir.FuncOp("reduce", [stencil.FieldType(core), stencil.FieldType(core)])
    src, dst = func.body.args
    load = func.body.add_op(stencil.LoadOp(src))
    red = func.body.add_op(comm.AllReduceOp(load.results[0], ("x",), "sum"))
    func.body.add_op(stencil.StoreOp(red.results[0], dst, core))
    func.body.add_op(ir.ReturnOp([]))
    interp = StencilInterpreter(func, axis_sizes={"x": 2, "y": 2}, distributed=True)
    mesh = _mesh((2, 2), ("x", "y"))
    vals = [torch.full((2, 3), float(10 ** r)) for r in range(4)]
    outs = interp.run_ranks([(v, torch.zeros(2, 3)) for v in vals],
                            [mesh.coords(r) for r in range(4)])
    for r, (o,) in enumerate(outs):
        y = mesh.coords(r)["y"]
        assert torch.equal(o, vals[y] + vals[2 + y])


def test_target_validates_mesh_and_strategy():
    mesh = _mesh((2, 2), ("x", "y"))
    with pytest.raises(TargetError, match="no mesh was given"):
        Target(strategy=make_strategy_2d((2, 2)), device="cpu")
    with pytest.raises(TargetError, match="not in mesh axes"):
        Target(mesh=mesh, strategy=make_strategy_2d((2, 2), axes=("x", "z")))
    with pytest.raises(TargetError, match="!= mesh size"):
        Target(mesh=mesh, strategy=make_strategy_2d((4, 1)))
    with pytest.raises(TargetError, match="mesh's devices are cpu"):
        Target(mesh=mesh, strategy=make_strategy_2d((2, 2)), device="cuda")
    with pytest.raises(TargetError, match="repro_torch.dist.Mesh"):
        Target(mesh=object(), device="cpu")
    t = Target(mesh=mesh, strategy=make_strategy_2d((2, 2)))
    assert t.device == "cpu" and t.distributed and t.spatial_ranks == 4
    assert not Target(mesh=mesh, device="cpu").distributed
    fps = {t.fingerprint, Target(device="cpu").fingerprint,
           Target(mesh=mesh, strategy=make_strategy_2d((2, 2), axes=("y", "x"))).fingerprint,
           Target(mesh=_mesh((2, 2), ("y", "x")), strategy=make_strategy_2d((2, 2), axes=("y", "x"))).fingerprint}
    assert len(fps) == 4
    with pytest.raises(TargetError, match="decomposes dim 2 of a rank-2"):
        api.compile(P.jacobi("repro_torch", (16, 16)),
                    Target(mesh=_mesh((2,), ("x",)), strategy=make_strategy_1d(2, dim=2)))
    with pytest.raises(TargetError, match="not divisible by grid size 4"):
        api.compile(P.jacobi("repro_torch", (18, 16)), _dist((4,)))
    with pytest.raises(TargetError, match="along dim 0 \\(mesh axis 'x'\\) exceeds the local shard extent 4"):
        api.compile(P.heat("repro_torch", (16, 16), 4), _dist((4,), exchange_every=4))


def test_time_loop_keeps_its_state_sharded(monkeypatch):
    """``time_loop`` over a mesh shards once, hands every epoch sharded
    state and gathers once at the end; ``advance`` keeps it sharded."""
    prog = P.wave("repro_torch", (16, 12), 2)
    state = [_t(a) for a in P.rand_state(prog, 2)]
    step = api.compile(prog, _dist((2, 2), exchange_every=2))
    seen, gathers = [], []
    real_advance, real_gather = step.advance, api.gather
    monkeypatch.setattr(step, "advance",
                        lambda s, **tags: seen.append(s) or real_advance(s, **tags))
    monkeypatch.setattr(api, "gather", lambda x: gathers.append(x) or real_gather(x))
    got = step.time_loop(state, 8)
    assert len(seen) == 4 and all(isinstance(x, ShardedTensor) for s in seen for x in s)
    assert len(gathers) == 2  # the two buffers of wave's state, once
    want = api.compile(prog, Target(device="cpu")).time_loop(state, 8)
    for g, w in zip(got, want):
        _same(g, w)
    sharded = step.advance(step.shard_state(state))
    assert all(isinstance(x, ShardedTensor) for x in sharded)


def test_spans_carry_the_rank_and_exchange_windows_close():
    """With tracing on, every apply span names its rank and the rank
    count, and every exchange window opens at ``exchange_start`` and closes
    at the wait that consumes its patch, per rank."""
    step = api.compile(P.jacobi("repro_torch", (16, 16), "periodic"), _dist((2, 2), overlap=True))
    u = torch.zeros(16, 16)
    obs.clear()
    obs.enable()
    try:
        step(u, u)
    finally:
        obs.disable()
    spans = obs.spans()
    obs.clear()
    comm_spans = [s for s in spans if s.cat == "comm"]
    applies = [s for s in spans if s.name.startswith("apply:")]
    assert len(comm_spans) == 4 * _starts(step)
    assert sorted({s.rank for s in comm_spans}) == [0, 1, 2, 3]
    assert all(s.args.get("ranks") == 4 for s in comm_spans + applies)
    for r in range(4):
        interior = [s for s in applies if s.rank == r and s.name == "apply:interior"]
        windows = [s for s in comm_spans if s.rank == r]
        # each window is open while this rank's interior apply runs
        assert interior and all(
            any(a.ts < w.end and w.ts < a.end for a in interior) for w in windows
        )
