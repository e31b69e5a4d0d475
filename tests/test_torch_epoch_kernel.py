"""Kernel K2 (``repro_torch.kernels.epoch_kernel``): one launch per fused
deep-halo epoch, against the unfused port and the reference's fused
Pallas target (interpret mode).  The port of ``tests/test_fused_epoch.py``.

- Fused against unfused over a fixed, numpy-seeded list of random
  programs (rank 1–3, 1–3 applies, zero/periodic) × k ∈ {1, 2, 4}, which
  includes the three zero-boundary programs that made the reference's
  hypothesis search fail: within torch bitwise, against the reference
  within rtol=atol=1e-5 (XLA may fuse a*b+c; eager torch rounds each op).
- The kernel's tile plan, evaluated tile by tile with the plain version
  and stitched from each tile's owned part, equals the whole bitwise.
- Dispatch counters, Target validation, heat and wave time loops, the
  generated source read as text, and K2 against its plain version on the
  card (marked ``gpu``; skips without one).

Tensors here lie on the CPU, so the K2 wrapper runs its plain version.
"""
import itertools
import re

import numpy as np
import pytest
import torch

import _torch_programs as P
from repro_torch import api
from repro_torch.api import Target, TargetError
from repro_torch.core.dialects import stencil
from repro_torch.interop import state_from_numpy
from repro_torch.kernels import dispatch_stats, reset_dispatch_stats
from repro_torch.kernels import epoch_kernel as k2
from repro_torch.kernels import stencil_apply as k1

TOL = dict(rtol=1e-5, atol=1e-5)
CPU = dict(device="cpu")


def _reference():
    """The reference package, imported here so that the ``gpu`` test also
    runs where JAX is missing."""
    from repro import api as rapi

    return rapi


def _fused(k, **kw):
    return Target(backend="cuda", exchange_every=k, fused_epoch=True, **CPU, **kw)


def _unfused(k, **kw):
    return Target(backend="cuda", exchange_every=k, **CPU, **kw)


# -------------------------------------------------------------------------
# fused == unfused (bitwise) and ≈ the reference, over a fixed list
# -------------------------------------------------------------------------

# the falsifying examples of tests/test_fused_epoch.py's hypothesis search
NAMED = {
    "hyp-1000000-1-2-zero": (1000000, 1, 2, "zero"),
    "hyp-967048-2-2-zero": (967048, 2, 2, "zero"),
    "hyp-778116-2-1-zero": (778116, 2, 1, "zero"),
}


def _descriptors(n=12, seed=2024):
    rng = np.random.default_rng(seed)
    out = {}
    for _ in range(n):
        d = (
            int(rng.integers(0, 10**6)),
            int(rng.integers(1, 4)),
            int(rng.integers(1, 4)),
            str(rng.choice(["zero", "periodic"])),
        )
        out["seeded-{}-{}-{}-{}".format(*d)] = d
    return out


DESCRIPTORS = {**NAMED, **_descriptors()}


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("name", sorted(DESCRIPTORS))
def test_fused_epoch_equals_unfused_and_reference(name, k):
    """Two epochs (so epoch-to-epoch rotation too): the port's fused route
    (K2's plain version) is bitwise equal to its unfused route (k K1
    calls per epoch) and within 1e-5 of the reference's jitted fused
    Pallas target in interpret mode."""
    rapi = _reference()
    seed, rank, n_applies, boundary = DESCRIPTORS[name]
    ref_prog = P.random_program("repro", seed, rank, n_applies, boundary)
    prog = P.random_program("repro_torch", seed, rank, n_applies, boundary)
    assert prog.fingerprint == ref_prog.fingerprint
    ref_target = rapi.Target(
        backend="pallas", exchange_every=k, fused_epoch=True, pallas_interpret=True
    )
    try:
        ref = rapi.compile(ref_prog, ref_target)
    except rapi.TargetError as e:
        assert "deep halo" in str(e)
        with pytest.raises(TargetError, match="deep halo"):
            api.compile(prog, _fused(k))
        return
    fused = api.compile(prog, _fused(k))
    unfused = api.compile(prog, _unfused(k))
    assert fused.kernel_dispatches == {"fused_epoch": 1, "apply": 0, "total": 1}
    u0 = np.random.default_rng(seed + 1).standard_normal(prog.field_args[0].type.bounds.shape)
    u0 = u0.astype(np.float32)
    want = u0
    for _ in range(2):
        want = np.array(ref(want, np.zeros_like(want))[0])
    got = base = torch.from_numpy(u0)
    for _ in range(2):
        (got,) = fused.step()(got)
        (base,) = unfused.step()(base)
    assert torch.equal(got, base)
    torch.testing.assert_close(got, torch.from_numpy(want), **TOL)


def test_random_program_mirrors_the_hypothesis_strategy():
    """The helper builds the very programs of ``_strategies.build_program``
    (ranks 1 and 2), so the named cases are the reference's failures."""
    from _strategies import build_program

    for seed, rank, n_applies, boundary in NAMED.values():
        ref = build_program(seed, rank, n_applies, boundary)
        assert P.random_program("repro", seed, rank, n_applies, boundary).fingerprint == ref.fingerprint
    assert {d[1] for d in DESCRIPTORS.values()} == {1, 2, 3}
    assert {d[3] for d in DESCRIPTORS.values()} == {"zero", "periodic"}


# -------------------------------------------------------------------------
# the kernel's tile plan, checked where the kernel cannot run
# -------------------------------------------------------------------------


def _epoch(prog, k, **kw):
    (op,) = api.compile(prog, _fused(k, **kw)).kernel_epochs()
    return op


def _rand_inputs(op, seed=0):
    rng = np.random.default_rng(seed)
    return [
        torch.from_numpy(rng.standard_normal(a.type.bounds.shape).astype(np.float32))
        for a in op.body.args
    ]


def _slice(t, whole: stencil.Bounds, part: stencil.Bounds):
    return t[tuple(slice(p - w, p - w + n) for p, w, n in zip(part.lb, whole.lb, part.shape))]


TILE_CASES = {
    "heat-so4-zero": (lambda: P.heat("repro_torch", (24, 20), 4), 4, (8, 10)),
    "heat-so2-periodic": (lambda: P.heat("repro_torch", (24, 20), 2, "periodic"), 4, (6, 5)),
    "heat-so8-zero-one-tile": (lambda: P.heat("repro_torch", (40, 36), 8), 2, None),
    "wave-so4-overhang": (lambda: P.wave("repro_torch", (24, 20), 4), 4, (8, 4)),
    "wave-so2-points": (lambda: P.wave("repro_torch", (12, 10), 2), 2, (1, 1)),
    "heat3d-so4": (lambda: P.heat("repro_torch", (12, 10, 16), 4), 2, (4, 5, 8)),
    "index-2d": (lambda: P.index_chain("repro_torch", (24, 20)), 1, (8, 5)),
    "index-3d": (lambda: P.index_chain("repro_torch", (12, 10, 8)), 1, (3, 5, 4)),
    "index-1d": (lambda: P.index_chain("repro_torch", (30,)), 1, (6,)),
    "chain3d-periodic": (lambda: P.star_chain("repro_torch", (16, 17, 16), "periodic", 3), 2, None),
}


@pytest.mark.parametrize("name", sorted(TILE_CASES))
def test_tile_plan_stitches_to_the_whole(name):
    """Evaluate the plain version on every tile's windows (the kernel's own
    plan: windows grown by each value's overhang, edge tiles writing the
    escapes' overhang, ``stencil.index`` at the tile's origin), stitch each
    tile's owned part, and get the whole-shard result bitwise — with every
    escape point written by exactly one tile."""
    build, k, tile = TILE_CASES[name]
    op = _epoch(build(), k)
    plan = k2.plan_epoch(op, tile)
    assert plan.n_tiles == int(np.prod(plan.grid))
    inputs = _rand_inputs(op)
    masks = k2.region_masks(op, "cpu")
    mask_ops = [m for m in op.body.ops if m.name == "comm.boundary_mask"]
    whole = k2._emit_region(op, inputs, masks, lambda v: v.type.bounds)
    escapes = list(op.body.ops[-1].operands)
    stitched = [torch.full_like(w, float("nan")) for w in whole]
    written = [torch.zeros(w.shape, dtype=torch.int32) for w in whole]
    for idx in plan.tiles():
        def window(v, idx=idx):
            return plan.window(v.type.bounds, idx)

        tin = [_slice(x, a.type.bounds, window(a)) for x, a in zip(inputs, op.body.args)]
        tmask = [_slice(m, mo.temp.type.bounds, window(mo.temp)) for m, mo in zip(masks, mask_ops)]
        outs = k2._emit_region(op, tin, tmask, window)
        for j, (e, out) in enumerate(zip(escapes, outs)):
            eb = e.type.bounds
            own = plan.owned(eb, idx)
            assert window(e).contains(own)
            _slice(stitched[j], eb, own)[...] = _slice(out, window(e), own)
            _slice(written[j], eb, own)[...] += 1
    for s, w, n in zip(stitched, whole, written):
        assert bool((n == 1).all())
        assert torch.equal(s, w)


def test_tile_plan_windows_and_owned_parts():
    """The arithmetic itself, on wave so4 k=4 over 64² at 16×32 tiles: the
    carried escape over [-2, 66)² is owned by edge tiles at its rims."""
    op = _epoch(P.wave("repro_torch", (64, 64), 4), 4)
    plan = k2.plan_epoch(op, (16, 32))
    assert plan.core == stencil.Bounds((0, 0), (64, 64))
    assert plan.grid == (4, 2)
    carried, new = (e.type.bounds for e in op.body.ops[-1].operands)
    assert carried == stencil.Bounds((-2, -2), (66, 66)) and new == plan.core
    assert plan.window(carried, (1, 1)) == stencil.Bounds((14, 30), (34, 66))
    assert plan.owned(carried, (0, 0)) == stencil.Bounds((-2, -2), (16, 32))
    assert plan.owned(carried, (1, 1)) == stencil.Bounds((16, 32), (32, 66))
    assert plan.owned(carried, (3, 1)) == stencil.Bounds((48, 32), (66, 66))
    assert plan.owned(new, (3, 1)) == stencil.Bounds((48, 32), (64, 64))
    (u_t, u_tm1) = (a.type.bounds for a in op.body.args)
    assert plan.window_shape(u_t) == (32, 48) and plan.window_shape(u_tm1) == (28, 44)


def test_emitted_ownership_test_matches_the_plan():
    """The C condition by which a tile skips escape points it does not own
    selects exactly ``TilePlan.owned`` in every tile (evaluated here with
    the C operators spelled in Python)."""
    op = _epoch(P.wave("repro_torch", (24, 20), 4), 4)
    plan = k2.plan_epoch(op, (8, 4))
    for e in op.body.ops[-1].operands:
        eb = e.type.bounds
        cond = k2._outside_owned(plan, eb) or "False"  # None: owns its window
        expr = cond.replace("!", "not ").replace("&&", "and").replace("||", "or")
        for idx in plan.tiles():
            env = {f"first{d}": idx[d] == 0 for d in range(2)}
            env.update({f"last{d}": idx[d] == plan.grid[d] - 1 for d in range(2)})
            win, own = plan.window(eb, idx), plan.owned(eb, idx)
            for i0 in range(win.shape[0]):
                for i1 in range(win.shape[1]):
                    point = (win.lb[0] + i0, win.lb[1] + i1)
                    inside = all(l <= x < u for x, l, u in zip(point, own.lb, own.ub))
                    assert eval(expr, {}, {**env, "i0": i0, "i1": i1}) != inside


# -------------------------------------------------------------------------
# tile choice and shared memory
# -------------------------------------------------------------------------


@pytest.mark.parametrize("so,window", [(2, 72), (4, 80), (8, 96)])
def test_default_tile_at_fig7_size_fits_two_ctas_per_sm(so, window):
    """Heat 16384² at k=4 takes 64×128 tiles (grown from 64² by the cost
    model: a 128-wide tile pads its frame walks less and re-reads less
    halo); the windows are the tile plus the 4-step halo, and two CTAs'
    shared memory fits on one SM."""
    op = _epoch(P.heat("repro_torch", (16384, 16384), so), 4)
    plan = k2.plan_epoch(op)
    assert plan.tile == (64, 128) and plan.n_tiles == 256 * 128
    assert plan.window_shape(op.body.args[0].type.bounds) == (window, window + 64)
    st = k2._storage(op, plan)
    assert 4 * window * (window + 64) <= st.smem_bytes <= k2.SMEM_TWO_BLOCKS
    assert len(st.slot_floats) == 2  # input/frame ping-pong; the last frame goes straight out
    square = k2._plan(plan.core, (64, 64))
    assert k2.tile_cost(op, plan) < k2.tile_cost(op, square)
    assert "__launch_bounds__(256, 2)" in k2.emit_epoch_cuda(op)


def test_wave_storage_reuses_dead_buffers():
    op = _epoch(P.wave("repro_torch", (16384, 16384), 4), 4)
    plan = k2.plan_epoch(op)
    assert plan.tile == (32, 128)  # three live buffers: a 64×128 tile would not fit twice
    st = k2._storage(op, plan)
    # u_t (48×144), u_{t-1} (44×140) and the first frame (44×140) are live at once
    assert st.slot_floats == [48 * 144, 44 * 140, 44 * 140]
    assert len(st.direct) == 1  # the new state; the carried one is copied out
    assert "K1_OPT_IN_SMEM(k2_epoch, 76928)" in k2.emit_epoch_cuda(op)  # 76,928 B opts in


def test_tile_shrinks_to_the_budget_and_refuses_what_cannot_fit():
    op = _epoch(P.heat("repro_torch", (64, 64), 8), 4)  # 16-point halo
    big = k2.plan_epoch(op, (64, 64))
    assert k2._storage(op, big).smem_bytes > 0
    with pytest.raises(ValueError, match="does not divide"):
        k2.plan_epoch(op, (48, 64))
    with pytest.raises(ValueError, match="does not divide"):
        k2.plan_epoch(op, (64,))
    # a 16-point halo in 3D: a window of 33³ floats even for one point, so
    # no tile lets two CTAs share an SM; of the tiles (streaming plans left
    # out) the largest one CTA can hold wins, and the default plan streams
    op3 = _epoch(P.heat("repro_torch", (96, 96, 96), 8), 4)
    plan3 = k2.plan_epoch(op3, stream=False)
    assert plan3.tile == (2, 2, 2) and not plan3.stream
    assert k2.plan_epoch(op3).stream
    assert k2.SMEM_TWO_BLOCKS < k2._storage(op3, plan3).smem_bytes <= k2.SMEM_PER_BLOCK
    with pytest.raises(ValueError, match="shared memory"):
        k2.plan_epoch(op3, (96, 96, 96))


# -------------------------------------------------------------------------
# dispatch counters, census and the wrapper
# -------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 2, 4])
def test_fused_is_one_call_per_epoch_unfused_k(k):
    prog = P.heat("repro_torch", (16, 16), 4)
    (u0,) = state_from_numpy(prog, P.rand_state(prog), device="cpu")
    fused = api.compile(prog, _fused(k))
    unfused = api.compile(prog, _unfused(k))
    assert fused.kernel_dispatches == {"fused_epoch": 1, "apply": 0, "total": 1}
    assert unfused.kernel_dispatches == {"fused_epoch": 0, "apply": k, "total": k}
    assert len(fused.kernel_epochs()) == 1 and fused.kernel_applies() == []
    reset_dispatch_stats()
    fused.time_loop((u0,), 8)
    assert dispatch_stats().as_dict() == {
        "apply_calls": 0, "apply_launches": 0,
        "fused_epoch_calls": 8 // k, "fused_epoch_launches": 0,
    }
    reset_dispatch_stats()
    unfused.time_loop((u0,), 8)
    assert dispatch_stats().apply_calls == 8 and dispatch_stats().fused_epoch_calls == 0


def test_fused_ir_holds_one_region_of_k_applies():
    step = api.compile(P.heat("repro_torch", (16, 16), 4), _fused(4))
    ops = list(step.local_ir.body.ops)
    (fused,) = [op for op in ops if isinstance(op, stencil.FusedEpochOp)]
    assert not any(isinstance(op, stencil.ApplyOp) for op in ops)
    inner = [op.name for op in fused.body.ops]
    assert inner.count("stencil.apply") == 4 and inner.count("comm.boundary_mask") == 3
    assert inner[-1] == "stencil.fused_yield" and fused.k == 4


def test_wrapper_checks_its_inputs_and_builds_masks_on_cpu():
    op = _epoch(P.heat("repro_torch", (16, 16), 4), 4)
    (x,) = _rand_inputs(op)
    reset_dispatch_stats()
    (a,) = k2.run_epoch_cuda(op, [x], None)
    (b,) = k2.run_epoch_cuda(op, [x], k2.region_masks(op, "cpu"), tile=(8, 4))
    assert torch.equal(a, b) and a.shape == (16, 16)
    assert dispatch_stats().fused_epoch_calls == 2 and dispatch_stats().fused_epoch_launches == 0
    with pytest.raises(ValueError, match="does not divide"):
        k2.run_epoch_cuda(op, [x], None, tile=(5, 4))
    with pytest.raises(ValueError, match="masks"):
        k2.run_epoch_cuda(op, [x], [])
    with pytest.raises(TypeError, match="float32"):
        k2.run_epoch_cuda(op, [x.double()], None)
    with pytest.raises(ValueError, match="shape"):
        k2.run_epoch_cuda(op, [x[1:]], None)
    with pytest.raises(ValueError, match="CUDA or"):
        k2.run_epoch_cuda(op, [torch.empty(x.shape, device="meta")], None)


def test_fused_epoch_records_its_spans():
    from repro_torch.obs import trace

    step = api.compile(P.heat("repro_torch", (16, 16), 4), _fused(4))
    (u0,) = state_from_numpy(step.program, P.rand_state(step.program), device="cpu")
    trace.enable()
    try:
        trace.clear()
        step.time_loop((u0,), 8)
        names = [s.name for s in trace.spans()]
    finally:
        trace.disable()
        trace.clear()
    assert names.count("fused_epoch") == 2 and names.count("cuda:fused_epoch") == 2


def test_explicit_tile_is_bitwise_to_the_default():
    prog = P.wave("repro_torch", (32, 24), 4)
    state = state_from_numpy(prog, P.rand_state(prog, 3), device="cpu")
    a = api.compile(prog, _fused(4)).time_loop(state, 8)
    b = api.compile(prog, _fused(4, tile=(8, 6))).time_loop(state, 8)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# -------------------------------------------------------------------------
# Target surface
# -------------------------------------------------------------------------


@pytest.mark.parametrize(
    "kwargs,match",
    [
        ({"fused_epoch": True}, "requires backend='cuda'"),
        ({"backend": "torch", "fused_epoch": True}, "requires backend='cuda'"),
        ({"backend": "cuda", "fused_epoch": True, "overlap": True}, "overlap"),
        ({"backend": "cuda", "pipeline": "decompose,swap-elim,lower-comm,fuse-epoch-kernel"},
         "contains the fuse-epoch-kernel"),
        ({"backend": "cuda", "fused_epoch": True, "pipeline": "decompose,swap-elim,lower-comm"},
         "lacks the fuse-epoch-kernel"),
        ({"tile": (0, 4)}, "positive"),
        ({"tile": (2.5, 4)}, "positive"),
    ],
)
def test_target_validates_fused_epoch_and_tile(kwargs, match):
    with pytest.raises(TargetError, match=match):
        Target(**CPU, **kwargs)


def test_fused_target_spec_and_fingerprint_follow_the_reference():
    rapi = _reference()
    t = Target(backend="cuda", exchange_every=4, fused_epoch=True, **CPU)
    assert t.pipeline_spec().endswith("fuse-epoch-kernel")
    assert t.pipeline_spec() == rapi.Target(
        backend="pallas", exchange_every=4, fused_epoch=True
    ).pipeline_spec()
    assert Target(backend="cuda", pipeline=t.pipeline_spec(), exchange_every=4,
                  fused_epoch=True, **CPU).pipeline_spec() == t.pipeline_spec()
    fps = {
        Target(backend="cuda", exchange_every=4, **CPU).fingerprint,
        t.fingerprint,
        Target(backend="cuda", exchange_every=4, fused_epoch=True, tile=(8, 8), **CPU).fingerprint,
    }
    assert len(fps) == 3
    assert Target(tile=[8, 8], **CPU).tile == (8, 8)


@pytest.mark.parametrize("tile,match", [((4, 4, 4), "rank-2"), ((5, 4), "does not divide")])
def test_compile_refuses_a_tile_that_does_not_fit_the_program(tile, match):
    with pytest.raises(TargetError, match=match):
        api.compile(P.heat("repro_torch", (16, 16), 4), _fused(4, tile=tile))


# -------------------------------------------------------------------------
# heat and wave through the frontend, against the reference
# -------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["heat", "wave"])
@pytest.mark.parametrize("k", [2, 4])
def test_time_loop_matches_reference_fused(which, k):
    rapi = _reference()
    build = {
        "heat": lambda pkg: P.heat(pkg, (20, 18), 4),
        "wave": lambda pkg: P.wave(pkg, (16, 20), 2),
    }[which]
    ref_prog, prog = build("repro"), build("repro_torch")
    state = P.rand_state(ref_prog, 5)
    ref_target = rapi.Target(
        backend="pallas", exchange_every=k, fused_epoch=True, pallas_interpret=True
    )
    want = rapi.compile(ref_prog, ref_target).time_loop(state, 8)
    tstate = state_from_numpy(prog, state, device="cpu")
    got = api.compile(prog, _fused(k)).time_loop(tstate, 8)
    base = api.compile(prog, Target(backend="torch", **CPU)).time_loop(tstate, 8)
    assert len(got) == len(want) == len(state)
    for g, w, b in zip(got, want, base):
        torch.testing.assert_close(g, torch.from_numpy(np.array(w)), **TOL)
        assert torch.equal(g, b)


def test_operator_entry_points_take_the_fused_target():
    from repro_torch.frontends.devito_like import Eq, Grid, Operator, TimeFunction

    g = Grid(shape=(16, 12), extent=(1.0, 1.0))
    u = TimeFunction(name="u", grid=g, space_order=4, time_order=2)
    op = Operator(Eq(u.dt2, u.laplace), dt=1e-3)
    state = state_from_numpy(op.program, P.rand_state(op.program, 2), device="cpu")
    target = _fused(4)
    out = op.apply(state, timesteps=8, target=target)
    step = op.compile_step(target=target)
    s = tuple(state)
    for _ in range(2):
        outs = step(*s)
        s = s[len(outs):] + outs
    assert all(torch.equal(a, b) for a, b in zip(out, s))
    unfused = op.apply(state, timesteps=8, target=_unfused(4))
    assert all(torch.equal(a, b) for a, b in zip(out, unfused))


# -------------------------------------------------------------------------
# the generated source, read as text
# -------------------------------------------------------------------------


def test_emitted_source_is_one_kernel_with_staged_windows():
    op = _epoch(P.heat("repro_torch", (16384, 16384), 4), 4)
    src = k2.emit_epoch_cuda(op)
    r = k2.R_BY_RANK[2]
    assert src.count("__global__") == 1
    assert src.count(
        "K1_LAUNCH(k2_epoch, static_cast<unsigned int>(slots) * 32768u, kThreads, 88640, stream,"
    ) == 1
    assert "K1_OPT_IN_SMEM(k2_epoch, 88640)" in src  # 88,640 B: above the 48 KB default
    assert src.count("out0[") == r  # the last frame goes straight out, owned points only
    # the 80×144 window arrives by 16-byte asynchronous copies, then one wait
    assert "K1_CP_ASYNC(s0 + q * 4, in0 + (t0 + i0) * 16400LL + (t1 + i1) * 1LL, 16);" in src
    assert src.index("K1_CP_ASYNC_WAIT(0);") < src.index("__syncthreads()")
    # three masks, each a box test against the global core [0, 16384),
    # applied as the three inner sub-steps write their frames, per point
    boxes = re.findall(r"\? v\d+ : 0.0f", src)
    assert len(boxes) == 3 * r and "comm.boundary_mask, keep" not in src
    # the box comes from the launch's arguments (one pair per masked dim,
    # [0, 16384) on one device): each mask takes its column's offsets from
    # the box once per column, in its window's coordinates, and tests every
    # point against immediates
    box = k2.box_args(op)
    assert box == [0, 16384, 0, 16384]
    offsets = re.findall(r"const int m_lo = a \+ t0 \+ (-?\d+) - box(\d+)_lo;", src)
    windowed = [(str(box[2 * int(j)] - int(off)), str(box[2 * int(j) + 1] - int(off)))
                for off, j in offsets]
    assert windowed == [("6", "16390"), ("4", "16388"), ("2", "16386")]
    tests = re.findall(r"\(m_in && m_lo >= (-?\d+) && m_hi < \1\)", src)
    assert tests == [str(-j) for j in range(r)] * 3
    assert src.count("__syncthreads()") == 1 + 3  # after the load and 3 sub-steps
    # register-blocked columns: per column, 8 points read 12 registers of the
    # dim-0 taps and 8 of each of the 4 minor taps (44 loads, 5.5 a point)
    first = src[src.index("// op 0:"):src.index("// op 1:") if "// op 1:" in src else src.index("// op 2:")]
    assert len(re.findall(r"const float x0_\d+_m?\d+ = ", first)) == (r + 4) + 4 * r


EPOCH_COLUMN_CASES = {
    "heat-so4-ragged": (lambda: P.heat("repro_torch", (24, 20), 4), 4, (8, 10)),
    "heat-so2-periodic": (lambda: P.heat("repro_torch", (24, 20), 2, "periodic"), 4, (6, 5)),
    "wave-so4": (lambda: P.wave("repro_torch", (24, 20), 4), 4, (8, 4)),
    "heat3d-so4": (lambda: P.heat("repro_torch", (12, 10, 16), 4), 2, (4, 5, 8)),
    "index-1d": (lambda: P.index_chain("repro_torch", (30,)), 1, (6,)),
}


@pytest.mark.parametrize("name", sorted(EPOCH_COLUMN_CASES))
def test_register_blocked_columns_stay_inside_their_windows(name):
    """Read each sub-step's column loads from the generated source and walk
    every column and chunk of its frame, ragged last chunks included: each
    load a column makes lies inside the operand's window, and the guard of
    a load is false only where no computed point of the column needs it."""
    build, k, tile = EPOCH_COLUMN_CASES[name]
    op = _epoch(build(), k)
    plan = k2.plan_epoch(op, tile)
    src = k2.emit_epoch_cuda(op, tile)
    st = k2._storage(op, plan)
    blocks = src.split("  // op ")[1:]
    applies = [x for x in op.body.ops if isinstance(x, stencil.ApplyOp)]
    apply_blocks = [b for b in blocks if b.split(":", 1)[1].startswith(" stencil.apply")]
    assert len(apply_blocks) == len(applies)
    r = k2.R_BY_RANK[plan.core.rank]
    for apply_op, block in zip(applies, apply_blocks):
        fw = plan.window_shape(apply_op.results[0].type.bounds)
        rows = k1.column_rows(apply_op, r)
        base = {int(m[0]): m[1] for m in re.findall(r"const int b(\d+) = (.*);", block)}
        loads = re.findall(
            r"const float x(\d+)_(\d+)_(m?\d+) = (?:\(a < (-?\d+)\) \? )?s(\d+)\[b\d+ \+ (-?\d+)\]", block)
        assert len(loads) == sum(len(v) for v in rows.values())
        cols = [()] if plan.core.rank == 1 else itertools.product(*(range(w) for w in fw[1:]))
        for c in cols:
            env = {f"i{d + 1}": x for d, x in enumerate(c)}
            for a in range(0, fw[0], r):
                valid = min(r, fw[0] - a)
                for kk, g, row, lim, slot, off in loads:
                    operand = apply_op.operands[int(kk)]
                    assert int(slot) == st.slot_of[operand]
                    numel = int(np.prod(plan.window_shape(operand.type.bounds)))
                    if lim and not a < int(lim):
                        continue  # guarded off: the load is not made
                    idx = eval(base[int(kk)], {}, {**env, "a": a}) + int(off)
                    assert 0 <= idx < numel, (name, a, c, row)
                # every tap of every computed point reads a loaded, unguarded row
                for x in apply_op.body.ops:
                    if isinstance(x, stencil.AccessOp):
                        for j in range(valid):
                            need = j + x.offset[0]
                            (lim,) = [ll for kk, g, row, ll, _, _ in loads
                                      if int(kk) == x.temp.index
                                      and (-int(row[1:]) if row.startswith("m") else int(row)) == need
                                      and list(rows)[int(g)][1] == tuple(x.offset[1:])]
                            assert not lim or a < int(lim)


# -------------------------------------------------------------------------
# on the card
# -------------------------------------------------------------------------


@pytest.mark.gpu
def test_kernel_matches_plain_version_on_card():
    """K2 on the card == its plain version on the card, bitwise: heat so4
    k=4 (zero and periodic), wave so4 k=4 at a default and an explicit
    tile, heat 3D k=2 and a stencil.index chain; every launch counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cases = [
        (P.heat("repro_torch", (256, 192), 4), 4, None),
        (P.heat("repro_torch", (256, 192), 4, "periodic"), 4, None),
        (P.wave("repro_torch", (256, 192), 4), 4, None),
        (P.wave("repro_torch", (256, 192), 4), 4, (32, 64)),
        (P.heat("repro_torch", (64, 48, 40), 4), 2, None),
        (P.index_chain("repro_torch", (90, 70)), 1, (9, 14)),
    ]
    gen = torch.Generator(device="cuda").manual_seed(0)
    reset_dispatch_stats()
    for prog, k, tile in cases:
        op = _epoch(prog, k)
        arrays = [torch.randn(a.type.bounds.shape, device="cuda", generator=gen) for a in op.body.args]
        got = k2.run_epoch_cuda(op, arrays, None, tile=tile)
        want = k2._emit_region(op, arrays, k2.region_masks(op, "cuda"), lambda v: v.type.bounds)
        torch.cuda.synchronize()
        assert len(got) == len(want) == len(op.results)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert dispatch_stats().fused_epoch_launches == len(cases)


@pytest.mark.gpu
def test_kernel_takes_each_rank_box_on_card():
    """K2 of the rank-local epoch of a 2×2 mesh (zero BC) on the card,
    launched with the box of each corner, bitwise equal to its plain
    version on the card with that corner's masks; one build serves all
    four corners, whose results differ."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core.passes.decompose import make_strategy_2d
    from repro_torch.dist import Mesh

    mesh = Mesh(np.array([torch.device("cpu")] * 4, dtype=object).reshape(2, 2), ("x", "y"))
    op = _epoch(P.heat("repro_torch", (512, 384), 4), 4,
                mesh=mesh, strategy=make_strategy_2d((2, 2)))
    gen = torch.Generator(device="cuda").manual_seed(0)
    arrays = [torch.randn(a.type.bounds.shape, device="cuda", generator=gen) for a in op.body.args]
    reset_dispatch_stats()
    outs = []
    for coords in ({"x": 0, "y": 0}, {"x": 0, "y": 1}, {"x": 1, "y": 0}, {"x": 1, "y": 1}):
        (got,) = k2.run_epoch_cuda(op, arrays, None, coords=coords)
        (want,) = k2._emit_region(op, arrays, k2.region_masks(op, "cuda", coords),
                                  lambda v: v.type.bounds)
        torch.cuda.synchronize()
        assert torch.equal(got, want), coords
        outs.append(got)
    assert dispatch_stats().fused_epoch_launches == 4
    assert all(not torch.equal(outs[0], o) for o in outs[1:])
