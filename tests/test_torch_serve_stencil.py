"""The port's stencil-serving engine (``repro_torch.serve.stencil``) on
the CPU: fingerprint-batched slot pools.

The port of ``tests/test_serve_stencil.py`` case by case, every target
``Target(device="cpu", ...)`` (the engine's default target is the card)
and ``backend="cuda"`` in place of the reference's ``"pallas"`` (on CPU
tensors K1 and K2 run their plain versions).  Added: a pooled call over
``[B, *shape]`` tensors bitwise equal to ``B`` solo calls for heat and
wave at k = 1, 2, 4 on the torch and cuda backends and fused epochs;
the port's engine within rtol=atol=1e-5 of the reference's engine on the
same seeded requests (across frameworks the bar is a tolerance); slot
reads that later dispatches leave as they are; and a K1/K2 failure in a
pooled dispatch that propagates out of ``step()`` instead of falling
back.
"""
import importlib

import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.api import Target, TargetError
from repro_torch.kernels import has_cuda
from repro_torch.serve.stencil import (
    DONE,
    QUEUED,
    RUNNING,
    Scheduler,
    StencilEngine,
    StencilEngineConfig,
    StepMetrics,
)

TOL = dict(rtol=1e-5, atol=1e-5)


def T(**kw):
    return Target(device="cpu", **kw)


def _pb(pkg):
    return importlib.import_module(f"{pkg}.frontends.oec_like").ProgramBuilder


def _heat(shape=(16, 16), alpha=0.25, boundary="periodic", name="heat_serve", pkg="repro_torch"):
    p = _pb(pkg)(name, shape)
    u = p.input("u")
    out = p.output("out")
    t = p.load(u)
    r = p.apply(
        [t],
        lambda b, u: (u.at(-1, 0) + u.at(1, 0) + u.at(0, -1) + u.at(0, 1))
        * alpha,
    )
    p.store(r, out)
    return p.finish(boundary=boundary)


def _wave(shape=(16, 16), boundary="zero", name="wave_serve", pkg="repro_torch"):
    # p=2 inputs (u@t-1, u@t), q=1 output — exercises carried-state
    # rotation inside the slot pool
    p = _pb(pkg)(name, shape)
    um = p.input("u_prev")
    u0 = p.input("u_now")
    out = p.output("u_next")
    tm, t0 = p.load(um), p.load(u0)
    r = p.apply(
        [tm, t0],
        lambda b, um, u0: 2.0 * u0.at(0, 0)
        - um.at(0, 0)
        + 0.1
        * (
            u0.at(-1, 0)
            + u0.at(1, 0)
            + u0.at(0, -1)
            + u0.at(0, 1)
            - 4.0 * u0.at(0, 0)
        ),
    )
    p.store(r, out)
    return p.finish(boundary=boundary)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32
    )


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_bitwise(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), _np(w))


# -------------------------------------------------------------------------
# scheduler: admission / reclaim ordering
# -------------------------------------------------------------------------


def test_admission_is_fifo_and_bounded_by_pool():
    prog = _heat(name="heat_admit")
    compiled = api.compile(prog, T())
    sched = Scheduler(slots_per_group=2)
    group = sched.group_for(compiled)
    from repro_torch.serve.stencil.request import StencilRequest

    reqs = [
        StencilRequest(
            rid=i,
            program=prog,
            target=compiled.target,
            state=(_rand((16, 16), i),),
            n_steps=2,
        )
        for i in range(4)
    ]
    for r in reqs:
        sched.enqueue(group, r)
    admitted = sched.admit(group)
    # FIFO: the first two submitted run first; the rest wait queued
    assert [r.rid for r in admitted] == [0, 1]
    assert [r.status for r in reqs] == [RUNNING, RUNNING, QUEUED, QUEUED]
    assert group.free == [] and len(group.queue) == 2
    # reclaim frees the exact slot and the next FIFO request takes it
    slot = reqs[0].slot
    sched.reclaim(group, slot)
    assert sched.admit(group)[0].rid == 2
    assert reqs[2].slot == slot


def test_group_for_reuses_bucket_per_fingerprint():
    sched = Scheduler(slots_per_group=2)
    a = api.compile(_heat(name="heat_fp_a"), T())
    g1 = sched.group_for(a)
    g2 = sched.group_for(api.compile(_heat(name="heat_fp_a"), T()))
    assert g1 is g2  # same (program fp, target fp) → same slot pool
    g3 = sched.group_for(api.compile(_heat(name="heat_fp_a"), T(exchange_every=2)))
    assert g3 is not g1  # different target fingerprint → new bucket


# -------------------------------------------------------------------------
# engine: coalescing, bitwise correctness, continuous admission
# -------------------------------------------------------------------------


def test_same_fingerprint_requests_coalesce_into_batched_dispatch():
    prog = _heat(name="heat_coalesce")
    eng = StencilEngine(StencilEngineConfig(slots_per_group=4))
    for i in range(3):
        eng.submit(prog, (_rand((16, 16), i),), n_steps=4, target=T())
    m = eng.step()
    # three live same-fingerprint requests advanced by ONE dispatch
    assert m.live_slots == 3
    assert m.batched_dispatches == 1 and m.solo_dispatches == 0
    assert m.steps_advanced == 3
    eng.run()
    assert eng.metrics.solo_dispatches == 0  # never fell back to solo


def test_final_state_bitwise_equals_solo_time_loop():
    heat = _heat(name="heat_bitwise")
    wave = _wave(name="wave_bitwise")
    t1 = T()
    t2 = T(exchange_every=2)
    eng = StencilEngine(StencilEngineConfig(slots_per_group=3))
    jobs = []
    for i in range(3):
        s = (_rand((16, 16), 10 + i),)
        jobs.append((eng.submit(heat, s, n_steps=4 + 2 * i, target=t1), heat, t1, s))
    for i in range(2):
        s = (_rand((16, 16), 20 + i), _rand((16, 16), 30 + i))
        jobs.append((eng.submit(wave, s, n_steps=4, target=t2), wave, t2, s))
    eng.run()
    for handle, prog, target, state in jobs:
        want = api.compile(prog, target).time_loop(state, handle._req.n_steps)
        _assert_bitwise(handle.result(), want)


def test_mixed_fingerprints_dispatch_independently():
    heat = _heat(name="heat_mixed")
    wave = _wave(name="wave_mixed")
    eng = StencilEngine(StencilEngineConfig(slots_per_group=4))
    for i in range(2):
        eng.submit(heat, (_rand((16, 16), i),), n_steps=2, target=T())
    eng.submit(
        wave,
        (_rand((16, 16), 5), _rand((16, 16), 6)),
        n_steps=2,
        target=T(exchange_every=2),
    )
    m = eng.step()
    # heat bucket (2 live) batched; wave bucket (1 live) went solo
    assert m.batched_dispatches == 1 and m.solo_dispatches == 1
    # wave advanced a whole epoch (2 steps), heat 1 step each
    assert m.steps_advanced == 2 * 1 + 2


def test_continuous_admission_refills_freed_slots_same_step():
    prog = _heat(name="heat_refill")
    eng = StencilEngine(StencilEngineConfig(slots_per_group=2))
    handles = [
        eng.submit(prog, (_rand((16, 16), i),), n_steps=1, target=T()) for i in range(4)
    ]
    m = eng.step()
    # both pool requests finished and both queued ones were admitted
    # before the step returned — the pool never idles
    assert handles[0].done and handles[1].done
    assert handles[2].status == RUNNING and handles[3].status == RUNNING
    assert m.queued == 0
    eng.run()
    assert all(h.done for h in handles)
    assert eng.metrics.requests_completed == 4


def test_submit_validates_epoch_alignment_and_shapes():
    prog = _heat(name="heat_validate")
    eng = StencilEngine()
    with pytest.raises(ValueError, match="multiple"):
        eng.submit(
            prog, (_rand((16, 16), 0),), n_steps=3, target=T(exchange_every=2)
        )
    with pytest.raises(ValueError, match="n_steps"):
        eng.submit(prog, (_rand((16, 16), 0),), n_steps=0, target=T())
    with pytest.raises(ValueError, match="shape"):
        eng.submit(prog, (_rand((8, 8), 0),), n_steps=2, target=T())
    with pytest.raises(ValueError, match="input buffer"):
        eng.submit(prog, (_rand((16, 16), 0), _rand((16, 16), 1)), n_steps=2, target=T())


def test_default_target_is_the_card():
    """``submit(target=None)`` builds ``Target()``, which is on the card:
    without one it names the missing device."""
    prog = _heat(name="heat_default_target")
    eng = StencilEngine()
    if has_cuda():
        eng.submit(prog, (_rand((16, 16), 0),), n_steps=1)
        (group,) = eng.scheduler.groups.values()
        assert group.compiled.target.device.startswith("cuda")
    else:
        with pytest.raises(TargetError, match="no CUDA device"):
            eng.submit(prog, (_rand((16, 16), 0),), n_steps=1)


def test_result_raises_until_done():
    prog = _heat(name="heat_notdone")
    eng = StencilEngine()
    h = eng.submit(prog, (_rand((16, 16), 0),), n_steps=4, target=T())
    with pytest.raises(RuntimeError, match="queued"):
        h.result()
    eng.step()
    with pytest.raises(RuntimeError, match="running"):
        h.result()
    eng.run()
    assert h.status == DONE
    assert h.result() is not None


# -------------------------------------------------------------------------
# streaming frames
# -------------------------------------------------------------------------


def test_frame_cadence_callback_and_iterator():
    prog = _heat(name="heat_frames")
    eng = StencilEngine()
    seen = []
    h_cb = eng.submit(
        prog,
        (_rand((16, 16), 0),),
        n_steps=6,
        target=T(),
        frame_every=2,
        on_frame=seen.append,
    )
    h_pull = eng.submit(
        prog, (_rand((16, 16), 1),), n_steps=6, target=T(), frame_every=3
    )
    eng.run()
    assert [f.step for f in seen] == [2, 4, 6]
    assert all(f.rid == h_cb.rid for f in seen)
    pulled = list(h_pull.frames())
    assert [f.step for f in pulled] == [3, 6]
    assert list(h_pull.frames()) == []  # iterator drains
    # frames are host arrays; the cadence-final frame equals the result,
    # and callback frames never double-buffer on the handle
    assert all(isinstance(a, np.ndarray) for f in pulled for a in f.arrays)
    np.testing.assert_array_equal(pulled[-1].arrays[0], _np(h_pull.result()[0]))
    assert list(h_cb.frames()) == []
    # each frame equals the solo run stopped at that step
    solo = api.compile(prog, T())
    for f in seen:
        np.testing.assert_array_equal(f.arrays[0], _np(solo.time_loop((_rand((16, 16), 0),), f.step)[0]))


def test_epoch_target_frames_land_on_epoch_boundaries():
    wave = _wave(name="wave_frames")
    eng = StencilEngine()
    h = eng.submit(
        wave,
        (_rand((16, 16), 0), _rand((16, 16), 1)),
        n_steps=8,
        target=T(exchange_every=2),
        frame_every=3,  # marks at 3 and 6 → snapshots at epochs 4 and 6
    )
    eng.run()
    assert [f.step for f in h.frames()] == [4, 6]


# -------------------------------------------------------------------------
# metrics: utilization math
# -------------------------------------------------------------------------


def test_step_metrics_utilization_math():
    m = StepMetrics(
        engine_step=1,
        live_slots=3,
        pool_slots=4,
        queued=2,
        batched_dispatches=1,
        solo_dispatches=0,
        steps_advanced=3,
        queue_depth={},
    )
    assert m.utilization == pytest.approx(0.75)
    empty = StepMetrics(0, 0, 0, 0, 0, 0, 0, {})
    assert empty.utilization == 0.0


def test_engine_metrics_aggregate_and_cache_deltas():
    prog = _heat(name="heat_metrics")
    eng = StencilEngine(StencilEngineConfig(slots_per_group=2))
    for i in range(2):
        eng.submit(prog, (_rand((16, 16), i),), n_steps=2, target=T())
    eng.run()
    snap = eng.metrics.snapshot()
    assert snap["requests_submitted"] == 2
    assert snap["requests_completed"] == 2
    assert snap["batched_dispatches"] == eng.metrics.batched_dispatches >= 1
    assert snap["steps_advanced"] == 4
    # full pool both steps → mean utilization 1.0
    assert snap["mean_utilization"] == pytest.approx(1.0)
    # cache counters are deltas since engine construction, never negative
    assert all(v >= 0 for v in snap["compile_cache"].values())
    # a second identical engine re-uses every compile artifact
    eng2 = StencilEngine(StencilEngineConfig(slots_per_group=2))
    eng2.submit(prog, (_rand((16, 16), 9),), n_steps=2, target=T())
    eng2.run()
    cache2 = eng2.metrics.compile_cache()
    assert cache2["misses"] == 0 and cache2["hits"] >= 1


def test_step_latency_reports_per_fingerprint_quantiles():
    """Every dispatch is timed under its bucket's "program_fp/target_fp"
    key: a fused-epoch target and its unfused sibling land in separate
    buckets, each with p50/p99/mean over the recorded window — the
    fused-vs-unfused win is visible straight from the snapshot."""
    prog = _heat(name="heat_latency")
    eng = StencilEngine(StencilEngineConfig(slots_per_group=2))
    t_unfused = T(backend="cuda", exchange_every=2)
    t_fused = T(backend="cuda", exchange_every=2, fused_epoch=True)
    eng.submit(prog, (_rand((16, 16), 0),), n_steps=4, target=t_unfused)
    eng.submit(prog, (_rand((16, 16), 1),), n_steps=4, target=t_fused)
    eng.run()
    lat = eng.metrics.snapshot()["step_latency"]
    assert len(lat) == 2
    for t in (t_unfused, t_fused):
        key = f"{prog.fingerprint}/{t.fingerprint}"
        stats = lat[key]
        assert stats["count"] == 2  # 4 steps at k=2 → 2 epoch dispatches
        assert 0.0 < stats["p50_s"] <= stats["p99_s"]
        assert stats["mean_s"] > 0.0


def test_step_latency_degenerate_windows():
    """0- and 1-sample latency windows are well-defined: an empty window
    reports count=0 with all-zero quantiles (it must not vanish from the
    snapshot or raise), and a single sample is its own p50/p99/max."""
    from repro_torch.serve.stencil.metrics import EngineMetrics

    m = EngineMetrics()
    m.step_seconds["empty/window"] = []
    m.record_dispatch("one/sample", 0.25)
    lat = m.step_latency()
    assert lat["empty/window"] == {
        "count": 0, "mean_s": 0.0, "p50_s": 0.0, "p99_s": 0.0, "max_s": 0.0,
    }
    one = lat["one/sample"]
    assert one["count"] == 1
    assert one["p50_s"] == one["p99_s"] == one["max_s"] == one["mean_s"] == 0.25
    # two samples: max is the larger, p50 interpolates between them
    m.record_dispatch("one/sample", 0.75)
    two = m.step_latency()["one/sample"]
    assert two["max_s"] == 0.75
    assert two["p50_s"] == pytest.approx(0.5)
    assert two["p99_s"] <= two["max_s"]


def test_queue_depth_reports_per_fingerprint():
    prog = _heat(name="heat_depth")
    eng = StencilEngine(StencilEngineConfig(slots_per_group=1))
    for i in range(3):
        eng.submit(prog, (_rand((16, 16), i),), n_steps=2, target=T())
    m = eng.step()
    compiled = api.compile(prog, T())
    key = f"{compiled.program.fingerprint}/{compiled.target.fingerprint}"
    assert m.queue_depth[key] == 2  # 1 running (pool=1), 2 still waiting
    eng.run()
    assert eng.scheduler.queue_depths()[key] == 0


# -------------------------------------------------------------------------
# LRU compile cache bound (api.py)
# -------------------------------------------------------------------------


def test_cache_capacity_bounds_entries_and_counts_evictions():
    prev = api.set_cache_capacity(2)
    try:
        api.clear_cache()
        progs = [_heat(alpha=0.1 * (i + 1), name=f"heat_lru{i}") for i in range(3)]
        for p in progs:
            api.compile(p, T())
        stats = api.cache_stats()
        assert stats.misses == 3
        assert stats.evictions == 1  # capacity 2, third insert evicts oldest
        assert len(api._CACHE) == 2
        # the evicted (oldest) program recompiles: miss, and evicts again
        api.compile(progs[0], T())
        stats = api.cache_stats()
        assert stats.misses == 4 and stats.evictions == 2
        # the most-recent entry is still cached: a true hit
        api.compile(progs[0], T())
        assert api.cache_stats().hits >= 1
        assert api.cache_capacity() == 2
    finally:
        api.set_cache_capacity(prev)
        api.clear_cache()


def test_cache_hit_refreshes_lru_order():
    prev = api.set_cache_capacity(2)
    try:
        api.clear_cache()
        a = _heat(alpha=0.11, name="heat_lru_a")
        b = _heat(alpha=0.12, name="heat_lru_b")
        c = _heat(alpha=0.13, name="heat_lru_c")
        api.compile(a, T())
        api.compile(b, T())
        api.compile(a, T())  # refresh a → b is now oldest
        api.compile(c, T())  # evicts b, not a
        misses = api.cache_stats().misses
        api.compile(a, T())  # still cached
        assert api.cache_stats().misses == misses
        api.compile(b, T())  # was evicted → recompiles
        assert api.cache_stats().misses == misses + 1
    finally:
        api.set_cache_capacity(prev)
        api.clear_cache()


def test_set_cache_capacity_validates():
    with pytest.raises(ValueError, match=">= 1"):
        api.set_cache_capacity(0)


def test_lower_ir_and_cached_callable_share_the_cache():
    """``lower_ir`` runs a pipeline spec through the compile cache (a
    second call is a hit and the same IR object); ``cached_callable``
    builds once per key and counts in the same stats."""
    prog = _heat(name="heat_lower_ir")
    spec = T().pipeline_spec()
    strategy = api.trivial_strategy(2)
    first = api.lower_ir(prog.func, spec, strategy, boundary="periodic")
    assert first.sym_name.startswith(prog.func.sym_name)
    hits = api.cache_stats().hits
    assert api.lower_ir(prog.func, spec, strategy, boundary="periodic") is first
    assert api.cache_stats().hits == hits + 1
    built = []
    key = ("test-callable", prog.fingerprint)
    one = api.cached_callable(key, lambda: built.append(1) or object())
    hits = api.cache_stats().hits
    assert api.cached_callable(key, lambda: built.append(1) or object()) is one
    assert built == [1]
    assert api.cache_stats().hits == hits + 1


# -------------------------------------------------------------------------
# run() result, idle retirement, batched row commit
# -------------------------------------------------------------------------


def test_run_returns_only_this_calls_finishes():
    prog = _heat(name="heat_run_twice")
    eng = StencilEngine(StencilEngineConfig(slots_per_group=2))
    h1 = eng.submit(prog, (_rand((16, 16), 0),), n_steps=2, target=T())
    first = eng.run()
    assert [r.rid for r in first] == [h1.rid]
    h2 = eng.submit(prog, (_rand((16, 16), 1),), n_steps=2, target=T())
    second = eng.run()
    assert [r.rid for r in second] == [h2.rid]  # NOT [h1, h2]
    # the engine-lifetime history still accumulates
    assert [r.rid for r in eng.finished] == [h1.rid, h2.rid]
    # an empty run reports nothing
    assert eng.run() == []


def test_idle_buckets_retire_and_free_pooled_state(monkeypatch):
    """After serving N distinct fingerprints and draining them, idle
    retirement leaves no pooled tensors and ``buckets_retired == N``;
    ``total_slots``/``utilization`` stop counting the retired pools, and
    their pool executables' rings are released (the ring forced on, as a
    ``jit`` step on the card has one)."""
    monkeypatch.setattr(api.CompiledStencil, "_graphed", lambda self: True)
    progs = [_heat(name=f"heat_retire{i}") for i in range(3)]
    eng = StencilEngine(
        StencilEngineConfig(slots_per_group=2, bucket_idle_steps=2)
    )
    for i, p in enumerate(progs):
        eng.submit(p, (_rand((16, 16), i),), n_steps=2, target=T())
    eng.run()
    assert len(eng.scheduler.groups) == 3  # drained but not yet retired
    groups = list(eng.scheduler.groups.values())
    exes = [g.executable for g in groups]
    assert all(e is not None and e._ring is not None for e in exes)
    eng.step()  # idle step 1
    assert eng.metrics.buckets_retired == 0
    eng.step()  # idle step 2 → all three retire
    assert eng.metrics.buckets_retired == 3
    assert eng.scheduler.groups == {}
    assert eng.scheduler.total_slots == 0
    assert eng.utilization == 0.0
    assert eng.metrics.snapshot()["buckets_retired"] == 3
    assert all(g.executable is None for g in groups)
    assert all(e._ring is None for e in exes)
    # a retired fingerprint that returns gets a fresh bucket and works
    h = eng.submit(progs[0], (_rand((16, 16), 9),), n_steps=2, target=T())
    eng.run()
    assert h.done


def test_engines_over_the_same_traffic_keep_their_own_pool_executables(monkeypatch):
    """Two engines serving the same program and target at the same pool
    width each build one pool executable and one ring, whatever the order
    of their steps (the ring forced on, as a ``jit`` step on the card has
    one: a shared one would be rebuilt at every dispatch); one engine's
    bucket retiring leaves the other's ring in place; every result is
    bitwise its solo run."""
    monkeypatch.setattr(api.CompiledStencil, "_graphed", lambda self: True)
    rings = []
    real_init = api._Ring.__init__

    def init(ring, stencil, *args):
        real_init(ring, stencil, *args)
        rings.append(stencil)

    monkeypatch.setattr(api._Ring, "__init__", init)
    prog = _heat(name="heat_two_engines")
    engines = [
        StencilEngine(StencilEngineConfig(slots_per_group=2, bucket_idle_steps=1))
        for _ in range(2)
    ]
    states = [_rand((16, 16), 70 + i) for i in range(4)]
    handles = [
        engines[i % 2].submit(prog, (s,), n_steps=6 if i < 2 else 2, target=T())
        for i, s in enumerate(states)
    ]
    while any(e.pending for e in engines):
        for e in engines:
            e.step()
    exes = [next(iter(e.scheduler.groups.values())).executable for e in engines]
    assert exes[0] is not exes[1]
    assert rings == exes or rings == exes[::-1], rings  # one ring each
    kept = exes[1]._ring
    engines[0].step()  # idle: engine 0's bucket retires
    assert not engines[0].scheduler.groups and exes[0]._ring is None
    assert exes[1]._ring is kept
    solo = api.compile(prog, T())
    for h, s, n in zip(handles, states, (6, 6, 2, 2)):
        _assert_bitwise(h.result(), solo.time_loop((s,), n))


def test_bucket_activity_resets_idle_counter():
    prog = _heat(name="heat_idle_reset")
    eng = StencilEngine(
        StencilEngineConfig(slots_per_group=2, bucket_idle_steps=3)
    )
    eng.submit(prog, (_rand((16, 16), 0),), n_steps=2, target=T())
    eng.run()
    eng.step()
    eng.step()  # 2 idle steps of 3 — still alive
    assert len(eng.scheduler.groups) == 1
    eng.submit(prog, (_rand((16, 16), 1),), n_steps=2, target=T())  # traffic returns
    eng.run()
    assert len(eng.scheduler.groups) == 1  # counter reset, not retired
    assert eng.metrics.buckets_retired == 0


def test_commit_rows_matches_per_slot_write_loop():
    """The batched row commit (one ``index_copy_`` per buffer) lands the
    same pool state as a ``write_slot`` per slot."""
    prog = _wave(name="wave_commit_rows")
    compiled = api.compile(prog, T())
    sched_a, sched_b = Scheduler(4), Scheduler(4)
    ga = sched_a.group_for(compiled)
    gb = sched_b.group_for(compiled)
    for slot in range(4):
        row = (_rand((16, 16), slot), _rand((16, 16), 40 + slot))
        ga.write_slot(slot, row)
        gb.write_slot(slot, row)
    outs = {slot: (torch.from_numpy(_rand((16, 16), 80 + slot)),) for slot in (0, 2, 3)}
    rows = {}
    for slot, o in outs.items():
        row = ga.read_slot(slot)
        rows[slot] = tuple(row[len(o):]) + o
        gb.write_slot(slot, rows[slot])  # the per-slot path
    state = ga.state
    ga.commit_rows(rows)
    assert all(a is b for a, b in zip(state, ga.state))  # rows written in place
    for pa, pb in zip(ga.state, gb.state):
        assert torch.equal(pa, pb)


def test_read_slot_copies_do_not_change_after_later_dispatches():
    """A slot read (a result, a frame's source, a migration snapshot) is a
    copy: the pool tensors it came from are advanced by later dispatches
    (in place, in the pool executable's ring, on the card), and the read
    stays as it was."""
    prog = _heat(name="heat_read_slot")
    eng = StencilEngine(StencilEngineConfig(slots_per_group=2))
    short = eng.submit(prog, (_rand((16, 16), 0),), n_steps=2, target=T())
    long = eng.submit(prog, (_rand((16, 16), 1),), n_steps=8, target=T())
    eng.step()
    (group,) = eng.scheduler.groups.values()
    snap = group.read_slot(long._req.slot)
    kept = [t.clone() for t in snap]
    assert all(s.untyped_storage().data_ptr() != p.untyped_storage().data_ptr()
               for s, p in zip(snap, group.state))
    eng.step()  # short finishes: its result is read
    result = short.result()
    result_kept = [t.clone() for t in result]
    eng.run()  # later dispatches advance the pool
    _assert_bitwise(snap, kept)
    _assert_bitwise(short.result(), result_kept)
    solo = api.compile(prog, T())
    _assert_bitwise(snap, solo.time_loop((_rand((16, 16), 1),), 1))
    _assert_bitwise(long.result(), solo.time_loop((_rand((16, 16), 1),), 8))


# -------------------------------------------------------------------------
# frame cadence across migration
# -------------------------------------------------------------------------


def test_migrated_request_frame_cadence_with_non_dividing_start_step():
    """A request admitted mid-run at ``start_step=2`` with
    ``frame_every=4`` (not dividing the start step) streams at the next
    cadence marks — 4, 8 — and the landing final frame at 12."""
    prog = _heat(name="heat_cadence_midrun")
    eng = StencilEngine()
    h = eng.submit(
        prog, (_rand((16, 16), 0),), n_steps=12, target=T(), frame_every=4,
        start_step=2,
    )
    eng.run()
    assert [f.step for f in h.frames()] == [4, 8, 12]


def test_final_frame_emitted_exactly_once_when_cadence_lands_on_n_steps():
    prog = _heat(name="heat_final_frame")
    eng = StencilEngine()
    seen = []
    eng.submit(
        prog, (_rand((16, 16), 0),), n_steps=4, target=T(), frame_every=2,
        on_frame=seen.append,
    )
    eng.run()
    assert [f.step for f in seen] == [2, 4]
    assert sum(1 for f in seen if f.step == 4) == 1
    assert eng.metrics.frames_emitted == 2


def test_frame_steps_strictly_increase_across_evacuate_admit_hop(tmp_path):
    """Stream cadence survives migration: frames before the hop and
    frames after readmission (``start_step`` at the evacuated step)
    form one strictly increasing ``step`` sequence with no repeats."""
    prog = _heat(name="heat_hop_frames")
    first = StencilEngine(StencilEngineConfig(slots_per_group=1))
    h1 = first.submit(
        prog, (_rand((16, 16), 0),), n_steps=12, target=T(), frame_every=3
    )
    for _ in range(4):  # advance to step 4; frame mark 3 crossed
        first.step()
    before = [f.step for f in h1.frames()]
    assert before == [3]
    d = str(tmp_path / "hop")
    first.evacuate(prog.fingerprint, d)

    second = StencilEngine(StencilEngineConfig(slots_per_group=1))
    (h2,) = second.admit_evacuated(d, prog)
    assert h2.steps_done == 4
    second.run()
    after = [f.step for f in h2.frames()]
    assert after == [6, 9, 12]  # resumes the schedule, no replay of 3
    combined = before + after
    assert combined == sorted(set(combined))  # strictly increasing


# -------------------------------------------------------------------------
# PoolSizer policy
# -------------------------------------------------------------------------


def _sizer_group(name, capacity, live=0, queued=0):
    from repro_torch.serve.stencil.request import StencilRequest

    compiled = api.compile(_heat(name=name), T())
    sched = Scheduler(capacity)
    group = sched.group_for(compiled)
    for i in range(live):
        group.active[i] = StencilRequest(
            rid=i, program=compiled.program, target=compiled.target,
            state=(), n_steps=4,
        )
    for i in range(queued):
        group.queue.append(
            StencilRequest(
                rid=100 + i, program=compiled.program,
                target=compiled.target, state=(), n_steps=4,
            )
        )
    return group


def test_pool_sizer_grows_on_queue_depth_with_provenance():
    from repro_torch.serve.stencil import PoolSizer, PoolSizerConfig

    sizer = PoolSizer(PoolSizerConfig(max_capacity=16, ewma_alpha=1.0))
    group = _sizer_group("heat_sizer_grow", capacity=2, live=2, queued=4)
    new, prov = sizer.observe(group)
    assert new == 4 and prov["action"] == "grow"
    assert prov["queue_depth"] == 4 and prov["live"] == 2
    assert prov["queue_ewma"] == pytest.approx(2.0)
    assert prov["from_capacity"] == 2 and prov["to_capacity"] == 4


def test_pool_sizer_shrinks_on_low_utilization_never_below_live():
    from repro_torch.serve.stencil import PoolSizer, PoolSizerConfig

    sizer = PoolSizer(
        PoolSizerConfig(min_capacity=1, ewma_alpha=1.0, cooldown_steps=0)
    )
    group = _sizer_group("heat_sizer_shrink", capacity=8, live=1, queued=0)
    new, prov = sizer.observe(group)
    assert prov["action"] == "shrink"
    assert new == 4  # 8 * 0.5, still >= live
    assert prov["utilization_ewma"] == pytest.approx(0.125)
    group2 = _sizer_group("heat_sizer_floor", capacity=8, live=3, queued=0)
    sizer2 = PoolSizer(
        PoolSizerConfig(
            min_capacity=1, ewma_alpha=1.0, cooldown_steps=0,
            shrink_factor=0.25, shrink_utilization=0.5,
        )
    )
    new2, _ = sizer2.observe(group2)
    assert new2 == 3  # 8 * 0.25 = 2 would strand a live request


def test_pool_sizer_cooldown_hysteresis_blocks_back_to_back_resizes():
    from repro_torch.serve.stencil import PoolSizer, PoolSizerConfig

    sizer = PoolSizer(
        PoolSizerConfig(max_capacity=64, ewma_alpha=1.0, cooldown_steps=2)
    )
    group = _sizer_group("heat_sizer_cool", capacity=2, live=2, queued=8)
    assert sizer.observe(group) is not None  # resize fires
    # pressure persists, but the cooldown holds the width for 2 steps
    assert sizer.observe(group) is None
    assert sizer.observe(group) is None
    assert sizer.observe(group) is not None  # cooldown expired


def test_pool_sizer_holds_idle_and_steady_buckets():
    from repro_torch.serve.stencil import PoolSizer, PoolSizerConfig

    sizer = PoolSizer(PoolSizerConfig(ewma_alpha=1.0, cooldown_steps=0))
    # idle bucket: retirement's job, not the sizer's
    idle = _sizer_group("heat_sizer_idle", capacity=4, live=0, queued=0)
    assert sizer.observe(idle) is None
    # healthy utilization, empty queue: hold
    steady = _sizer_group("heat_sizer_steady", capacity=4, live=3, queued=0)
    assert sizer.observe(steady) is None


def test_autoscaled_engine_results_stay_bitwise_across_resizes(monkeypatch):
    """Single-device autoscaling end-to-end: a burst grows the bucket,
    the tail shrinks it, and every result matches solo time_loop
    bitwise; each resize releases the old width's pool executable (its
    ring, forced on as a ``jit`` step on the card has one)."""
    from repro_torch.serve.stencil import PoolSizerConfig

    monkeypatch.setattr(api.CompiledStencil, "_graphed", lambda self: True)
    built = []
    for_pool = api.CompiledStencil.for_pool
    monkeypatch.setattr(api.CompiledStencil, "for_pool",
                        lambda self: built.append(for_pool(self)) or built[-1])

    prog = _heat(name="heat_autoscale_e2e")
    eng = StencilEngine(
        StencilEngineConfig(
            slots_per_group=2,
            autoscale=PoolSizerConfig(
                min_capacity=1, max_capacity=8, ewma_alpha=1.0,
                cooldown_steps=1,
            ),
        )
    )
    states = [_rand((16, 16), 60 + i) for i in range(8)]
    steps = [4] * 7 + [40]
    handles = [
        eng.submit(prog, (s,), n, target=T()) for s, n in zip(states, steps)
    ]
    eng.run()
    auto = eng.metrics.snapshot()["autoscale"]
    assert auto["grows"] >= 1 and auto["shrinks"] >= 1, auto
    (group,) = eng.scheduler.groups.values()
    # at most one executable a pool width (none for a width that never
    # dispatched); only the live width's keeps its ring
    assert 2 <= len(built) <= 1 + auto["grows"] + auto["shrinks"]
    live = group.executable
    assert live is None or (live is built[-1] and live._ring is not None)
    assert all(e._ring is None for e in built if e is not live)
    solo = api.compile(prog, T())
    for h, s, n in zip(handles, states, steps):
        _assert_bitwise(h.result(), solo.time_loop((s,), n))


# -------------------------------------------------------------------------
# the slot dimension: pooled == solo, bitwise
# -------------------------------------------------------------------------


POOL_CASES = [
    (family, kw)
    for family in ("heat", "wave")
    for kw in (
        dict(),
        dict(exchange_every=2),
        dict(exchange_every=4),
        dict(backend="cuda"),
        dict(backend="cuda", exchange_every=2),
        dict(backend="cuda", exchange_every=4),
        dict(backend="cuda", exchange_every=2, fused_epoch=True),
        dict(backend="cuda", exchange_every=4, fused_epoch=True),
    )
]


@pytest.mark.parametrize("family,kw", POOL_CASES,
                         ids=[f"{f}-{'-'.join(f'{k}={v}' for k, v in kw.items()) or 'k1'}"
                              for f, kw in POOL_CASES])
def test_pooled_call_is_bitwise_b_solo_calls(family, kw):
    """A call of the compiled step over ``[B, *shape]`` tensors (the
    engine's pool executable, ``for_pool``) equals ``B`` solo calls bit
    for bit, for heat and wave (carried state through the epochs) at
    k = 1, 2, 4 on the torch backend, the cuda backend (K1's plain
    version on CPU tensors) and fused epochs (K2's)."""
    prog = (_heat(boundary="zero", name="heat_pool_bits") if family == "heat"
            else _wave(name="wave_pool_bits"))
    step = api.compile(prog, T(**kw))
    pool = step.for_pool()
    assert pool.target.donate and pool.local_ir is step.local_ir
    B = 3
    n_in = len(step.input_indices)
    state = tuple(torch.from_numpy(np.stack([_rand((16, 16), 7 * b + i) for b in range(B)]))
                  for i in range(n_in))
    got = state
    for _ in range(2):
        got = pool.advance(got)
    k = step.target.exchange_every
    for b in range(B):
        _assert_bitwise([g[b] for g in got], step.time_loop([s[b] for s in state], 2 * k))


def test_engine_bitwise_over_pooled_cuda_and_fused_buckets():
    """Heat and wave buckets on the cuda backend and fused epochs, with
    ragged n_steps so slots refill mid-run: every result equals its solo
    ``time_loop`` bitwise."""
    heat = _heat(boundary="zero", name="heat_engine_cuda")
    wave = _wave(name="wave_engine_cuda")
    eng = StencilEngine(StencilEngineConfig(slots_per_group=2))
    jobs = []
    for prog, target in ((heat, T(backend="cuda")), (heat, T(backend="cuda", exchange_every=2,
                                                            fused_epoch=True)),
                         (wave, T(backend="cuda", exchange_every=2, fused_epoch=True))):
        n_in = len(api.compile(prog, target).input_indices)
        for i, n in enumerate((4, 8, 4)):
            s = tuple(_rand((16, 16), 100 + 3 * i + j) for j in range(n_in))
            jobs.append((eng.submit(prog, s, n, target=target), prog, target, s, n))
    eng.run()
    assert eng.metrics.batched_dispatches > 0
    for h, prog, target, s, n in jobs:
        _assert_bitwise(h.result(), api.compile(prog, target).time_loop(s, n))


def test_engine_matches_the_reference_engine():
    """The same seeded requests through the reference's engine (JAX on the
    CPU) and the port's: heat at k=1 and wave at k=2, each result within
    rtol=atol=1e-5 of the reference's (bitwise is the bar within one
    framework only)."""
    from repro.api import Target as RTarget
    from repro.serve.stencil import StencilEngine as RefEngine
    from repro.serve.stencil import StencilEngineConfig as RefConfig

    cases = [("heat", {}, 1, 6), ("wave", {"exchange_every": 2}, 2, 8)]
    ref_eng = RefEngine(RefConfig(slots_per_group=2))
    eng = StencilEngine(StencilEngineConfig(slots_per_group=2))
    pairs = []
    for family, kw, n_in, n in cases:
        make = _heat if family == "heat" else _wave
        rprog, prog = make(name=f"{family}_xref", pkg="repro"), make(name=f"{family}_xref")
        assert rprog.fingerprint == prog.fingerprint
        for i in range(3):
            s = tuple(_rand((16, 16), 200 + 3 * i + j) for j in range(n_in))
            pairs.append((ref_eng.submit(rprog, s, n, target=RTarget(**kw)),
                          eng.submit(prog, s, n, target=T(**kw))))
    ref_eng.run()
    eng.run()
    for rh, h in pairs:
        for w, g in zip(rh.result(), h.result()):
            np.testing.assert_allclose(_np(g), np.asarray(w), **TOL)


@pytest.mark.parametrize("kernel", ["K1", "K2"])
def test_kernel_failure_in_a_pooled_dispatch_propagates(monkeypatch, kernel):
    """A K1 or K2 failure in a pooled dispatch (a stubbed launch) raises
    out of ``step()``, on one device and over a mesh: no bucket falls back
    to the solo loop, and nothing counts the dispatch."""
    from repro_torch.dist import Mesh
    from repro_torch.core.passes.decompose import make_strategy_1d
    from repro_torch.kernels import epoch_kernel, stencil_apply

    def fail(*a, **k):
        raise RuntimeError(f"{kernel} launch failed with CUDA error 700")

    mod, name = ((stencil_apply, "run_apply_cuda") if kernel == "K1"
                 else (epoch_kernel, "run_epoch_cuda"))
    kw = dict(backend="cuda") if kernel == "K1" else dict(backend="cuda", exchange_every=2,
                                                            fused_epoch=True)
    prog = _heat(boundary="zero", shape=(16, 16), name=f"heat_fail_{kernel}")
    mesh = Mesh(np.array([torch.device("cpu")] * 2, dtype=object), ("x",))
    for target in (T(**kw), Target(mesh=mesh, strategy=make_strategy_1d(2), **kw)):
        eng = StencilEngine(StencilEngineConfig(slots_per_group=2))
        for i in range(2):
            eng.submit(prog, (_rand((16, 16), i),), 4, target=target)
        monkeypatch.setattr(mod, name, fail)
        with pytest.raises(RuntimeError, match=f"{kernel} launch failed"):
            eng.step()
        monkeypatch.undo()
        assert eng.metrics.kernel_dispatches == 0 and eng.metrics.solo_dispatches == 0
        (group,) = eng.scheduler.groups.values()
        assert group.pooled is None or group.pooled[1] is not None
