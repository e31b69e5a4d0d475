"""The port's compile surface (``repro_torch.api``) against the reference:
time loops of fig-7 heat and wave for epoch depths 1, 2 and 4, Target
validation, the compile cache, the dispatch census and counters, state
carried across from numpy, and the refusal to fall back to the CPU.

Across frameworks the bar is rtol=atol=1e-5 over 8 steps (XLA may fuse
a*b+c; eager torch rounds each op); within torch it is bitwise.
"""
import numpy as np
import pytest
import torch

import _torch_programs as P
from repro import api as rapi
from repro_torch import api
from repro_torch.api import Target, TargetError
from repro_torch.interop import state_from_numpy
from repro_torch.kernels import dispatch_stats, reset_dispatch_stats

TOL = dict(rtol=1e-5, atol=1e-5)
CPU = dict(device="cpu")


def _loop_both(build, k, steps=8, seed=0):
    ref_prog, prog = build("repro"), build("repro_torch")
    state = P.rand_state(ref_prog, seed)
    want = rapi.compile(ref_prog, rapi.Target(exchange_every=k)).time_loop(state, steps)
    got = api.compile(prog, Target(backend="cuda", exchange_every=k, **CPU)).time_loop(
        state_from_numpy(prog, state, device="cpu"), steps
    )
    return [np.array(w) for w in want], got


@pytest.mark.parametrize("k", [1, 2, 4])
def test_heat_time_loop_matches_reference(k):
    want, got = _loop_both(lambda pkg: P.heat(pkg, (20, 18), 4), k)
    assert len(got) == 1
    torch.testing.assert_close(got[0], torch.from_numpy(want[0]), **TOL)


@pytest.mark.parametrize("k", [1, 2, 4])
def test_wave_time_loop_matches_reference(k):
    want, got = _loop_both(lambda pkg: P.wave(pkg, (16, 20), 2), k)
    assert len(got) == 2  # the full rotated state (u@t+7, u@t+8)
    for w, g in zip(want, got):
        torch.testing.assert_close(g, torch.from_numpy(w), **TOL)


def test_heat_3d_time_loop_matches_reference():
    want, got = _loop_both(lambda pkg: P.heat(pkg, (10, 9, 12), 4), 1, steps=4)
    torch.testing.assert_close(got[0], torch.from_numpy(want[0]), **TOL)


@pytest.mark.parametrize("k", [1, 4])
def test_kernel_route_bitwise_to_torch_backend(k):
    prog = P.wave("repro_torch", (16, 16), 4)
    state = state_from_numpy(prog, P.rand_state(prog, 1), device="cpu")
    a = api.compile(prog, Target(backend="torch", exchange_every=k, **CPU)).time_loop(state, 8)
    b = api.compile(prog, Target(backend="cuda", exchange_every=k, **CPU)).time_loop(state, 8)
    base = api.compile(prog, Target(**CPU)).time_loop(state, 8)
    for x, y, z in zip(a, b, base):
        assert torch.equal(x, y) and torch.equal(x, z)


# -------------------------------------------------------------------------
# Target validation
# -------------------------------------------------------------------------


@pytest.mark.parametrize(
    "kwargs,match",
    [
        ({"backend": "pallas"}, "unknown backend"),
        ({"fused_epoch": True}, "requires backend='cuda'"),
        ({"exchange_every": 0}, "positive integer"),
        ({"exchange_every": 1.5}, "positive integer"),
        ({"device": "meta"}, "CUDA device or 'cpu'"),
        ({"pipeline": "decompose,swap-elim,lower-comm", "exchange_every": 2}, "disagrees"),
        ({"pipeline": "decompose,swap-elim,temporal-tile{k=2},lower-comm,fuse-epoch-kernel",
          "exchange_every": 2}, "contains the fuse-epoch-kernel"),
    ],
)
def test_target_rejects_at_construction(kwargs, match):
    with pytest.raises(TargetError, match=match):
        Target(**kwargs)


def test_target_defaults_to_the_card_and_fingerprints_its_axes():
    t = Target()
    assert t.device == "cuda" and t.backend == "torch"
    fps = {
        Target(**CPU).fingerprint,
        Target(backend="cuda", **CPU).fingerprint,
        Target(exchange_every=2, **CPU).fingerprint,
        Target(overlap=True, **CPU).fingerprint,
        t.fingerprint,
    }
    assert len(fps) == 5
    assert Target(**CPU).pipeline_spec() == rapi.Target().pipeline_spec()
    assert Target(exchange_every=4, overlap=True, **CPU).pipeline_spec() == rapi.Target(
        exchange_every=4, overlap=True
    ).pipeline_spec()


def test_compile_refuses_a_missing_card(monkeypatch):
    """The default target runs on the card; with none, compile raises
    instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(TargetError, match="no CUDA device"):
        api.compile(P.jacobi("repro_torch"), Target())
    with pytest.raises(TargetError, match="no CUDA device"):
        api.compile(P.jacobi("repro_torch"), Target(backend="cuda"))


def test_deep_halo_validation():
    prog = P.heat("repro_torch", (8, 8), 8)
    with pytest.raises(TargetError, match="deep halo"):
        api.compile(prog, Target(exchange_every=4, **CPU))


# -------------------------------------------------------------------------
# cache, census, counters
# -------------------------------------------------------------------------


def test_compile_cache_hits():
    api.clear_cache()
    prog = P.heat("repro_torch", (12, 12), 2)
    a = api.compile(prog, Target(**CPU))
    b = api.compile(P.heat("repro_torch", (12, 12), 2), Target(**CPU))
    c = api.compile(prog, Target(exchange_every=2, **CPU))
    assert a is b and a is not c
    assert api.cache_stats().as_dict() == {"hits": 1, "misses": 2, "evictions": 0}
    api.clear_cache()
    assert api.cache_stats().hits == 0


@pytest.mark.parametrize("k,applies", [(1, 1), (2, 2), (4, 4)])
def test_kernel_dispatches_and_apply_calls(k, applies):
    prog = P.heat("repro_torch", (16, 16), 4)
    step = api.compile(prog, Target(backend="cuda", exchange_every=k, **CPU))
    assert step.kernel_dispatches == {"fused_epoch": 0, "apply": applies, "total": applies}
    assert len(step.kernel_applies()) == applies
    (u0,) = state_from_numpy(prog, P.rand_state(prog), device="cpu")
    reset_dispatch_stats()
    step.time_loop((u0,), 8)
    # one wrapper call per apply per step; no CUDA launch on the CPU
    assert dispatch_stats().apply_calls == 8
    assert dispatch_stats().apply_launches == 0


def test_overlap_frames_go_through_k1():
    """The overlap path's frames no longer stay on the evaluator: on the
    ``cuda`` backend the interior and every frame go through K1's wrapper
    (its plain version here), one call each per step."""
    prog = P.heat("repro_torch", (16, 16), 4)
    step = api.compile(prog, Target(backend="cuda", overlap=True, **CPU))
    assert step.kernel_dispatches["apply"] == 5  # interior + 4 frames
    assert len(step.kernel_applies()) == 5  # all of them go to K1
    reset_dispatch_stats()
    step.time_loop(state_from_numpy(prog, P.rand_state(prog), device="cpu"), 2)
    assert dispatch_stats().apply_calls == 10


def test_time_loop_counts_steps_and_advance_rotates():
    prog = P.wave("repro_torch", (12, 12), 2)
    step = api.compile(prog, Target(exchange_every=2, **CPU))
    state = state_from_numpy(prog, P.rand_state(prog), device="cpu")
    with pytest.raises(ValueError, match="multiple of"):
        step.time_loop(state, 3)
    assert step.epochs(8) == 4
    once = step.advance(state)
    assert torch.equal(once[1], step.time_loop(state, 2)[1])


# -------------------------------------------------------------------------
# frontends and interop
# -------------------------------------------------------------------------


def test_devito_operator_entry_points():
    from repro_torch.frontends.devito_like import Eq, Grid, Operator, TimeFunction

    g = Grid(shape=(12, 10), extent=(1.0, 1.0))
    u = TimeFunction(name="u", grid=g, space_order=2)
    op = Operator(Eq(u.dt, 0.5 * u.laplace), dt=1e-4)
    (z,) = op.zero_state(device="cpu")
    assert z.shape == (12, 10) and z.device.type == "cpu"
    (u0,) = state_from_numpy(op.program, P.rand_state(op.program), device="cpu")
    target = Target(backend="cuda", **CPU)
    (a,) = op.apply((u0,), timesteps=3, target=target)
    step = op.compile_step(target=target)
    b = u0
    for _ in range(3):
        (b,) = step(b)
    assert torch.equal(a, b)
    assert [t.shape for t in op.program.global_zeros(device="cpu")] == [(12, 10)] * 2


def test_state_from_numpy_checks_and_copies():
    prog = P.wave("repro_torch", (8, 6), 2)
    good = P.rand_state(prog)
    state = state_from_numpy(prog, good, device="cpu")
    assert [tuple(s.shape) for s in state] == [(8, 6), (8, 6)]
    assert all(s.dtype == torch.float32 for s in state)
    good[0][0, 0] = 123.0
    assert state[0][0, 0] != 123.0  # a copy, not a view of the caller's array
    with pytest.raises(ValueError, match="takes 2 state arrays"):
        state_from_numpy(prog, good[:1], device="cpu")
    with pytest.raises(TypeError, match="float32"):
        state_from_numpy(prog, [good[0].astype(np.float64), good[1]], device="cpu")
    with pytest.raises(ValueError, match="shape"):
        state_from_numpy(prog, [good[0][:, :5], good[1]], device="cpu")
    with pytest.raises(TypeError, match="numpy array"):
        state_from_numpy(prog, [torch.zeros(8, 6), good[1]], device="cpu")


def test_step_refuses_mixed_devices_and_dtypes():
    prog = P.heat("repro_torch", (8, 8), 2)
    step = api.compile(prog, Target(**CPU))
    with pytest.raises(TypeError, match="float32"):
        step.step()(torch.zeros(8, 8, dtype=torch.float64))
