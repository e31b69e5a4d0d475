"""The port's cost model and autotuner (``repro_torch.launch.roofline``,
``CompiledStencil.cost()``, ``repro_torch.tune``, ``Target.auto``/
``Target.tuned`` and ``compile(tune=...)``), on the CPU.

The port of ``tests/test_tune.py`` case by case (backends ``torch``/
``cuda`` in place of ``jnp``/``pallas``), of ``tests/test_temporal.py``'s
``test_cost_carries_tiling_terms_and_recommends``, and of
``tests/dist_worker.py``'s ``tune-4rank`` and ``tune-transfer`` scenarios
on 4 and 2 virtual CPU ranks, in process.  Held against the reference:
``RooflineTerms`` arithmetic exactly (the port's H100 constants patched
to the reference's), ``cost()``'s structural terms exactly, the search
space after the backend mapping, ``target_from_dict`` of a reference
dict, and the tuned winner's run within rtol=atol=1e-5 of the
reference's ``jnp`` run.  Flops and bytes are pinned to hand counts (XLA
counts by another rule).  Every test keeps its cache under ``tmp_path``
(``REPRO_TORCH_TUNE_CACHE``).  The reference is imported inside the
tests, so that the ``gpu`` test also runs where JAX is missing.
"""
import importlib
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_programs as P
from _hypothesis_compat import given, settings, strategies as st
from repro_torch import api
from repro_torch.api import Target, TargetError
from repro_torch.core.passes.decompose import make_strategy_2d
from repro_torch.dist import Mesh
from repro_torch.launch import roofline
from repro_torch.launch.roofline import RooflineTerms
from repro_torch.tune import (
    cache_stats,
    enumerate_candidates,
    measure_compiled,
    reset_cache_stats,
    target_from_dict,
    target_to_dict,
    tune,
)
from repro_torch.tune import cache as tune_cache
from repro_torch.tune.space import (
    exchange_every_candidates,
    factorizations,
    mesh_assignments,
    strategy_candidates,
    tile_candidates,
)

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
ONE = [CPU]
TOL = dict(rtol=1e-5, atol=1e-5)


def _ref(module: str):
    return importlib.import_module(f"repro.{module}")


def _jacobi_prog(shape=(32, 32), boundary="periodic", name="tune_jacobi", pkg="repro_torch"):
    p = importlib.import_module(f"{pkg}.frontends.oec_like").ProgramBuilder(name, shape)
    u = p.input("u")
    out = p.output("out")
    t = p.load(u)
    r = p.apply(
        [t],
        lambda b, u: (u.at(-1, 0) + u.at(1, 0) + u.at(0, -1) + u.at(0, 1))
        * 0.25,
    )
    p.store(r, out)
    return p.finish(boundary=boundary)


def _cpu_mesh(shape, names=("x", "y")):
    n = int(np.prod(shape))
    return Mesh(np.array([CPU] * n, dtype=object).reshape(shape), names[: len(shape)])


@pytest.fixture
def tune_dir(tmp_path, monkeypatch):
    d = tmp_path / "tune-cache"
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(d))
    reset_cache_stats()
    yield str(d)
    reset_cache_stats()


# -------------------------------------------------------------------------
# search space
# -------------------------------------------------------------------------


def test_factorizations():
    assert factorizations(1) == [()]
    assert set(factorizations(8)) == {(8,), (2, 4), (4, 2), (2, 2, 2)}
    assert set(factorizations(6)) == {(6,), (2, 3), (3, 2)}


def test_mesh_assignments_dedup_and_rank_bound():
    # rank-2 program: (2,2,2) factorization needs 3 dims → dropped;
    # 2×2 over dims (0,1) and (1,0) are the same assignment
    assigns = mesh_assignments(8, rank=2)
    assert ((2, 0), (4, 1)) in assigns and ((4, 0), (2, 1)) in assigns
    assert ((8, 0),) in assigns and ((8, 1),) in assigns
    assert not any(len(a) > 2 for a in assigns)
    four = mesh_assignments(4, rank=2)
    assert four.count(((2, 0), (2, 1))) == 1


def test_strategy_candidates_respect_divisibility():
    # 6 does not divide 32: no factor-6 grids on either dim
    prog = _jacobi_prog((32, 32))
    strategies = strategy_candidates(prog, 6)
    for s in strategies:
        for g, d in zip(s.grid_shape, s.dims):
            assert 32 % g == 0
    assert strategy_candidates(prog, 1) == [None]


def test_exchange_every_candidates_filter_deep_halo():
    prog = _jacobi_prog((8, 8))
    # single device, shard 8×8, halo 1/step: k=8 fills the shard, fine;
    # k beyond the shard is filtered
    ks = exchange_every_candidates(prog, None, ks=(1, 2, 4, 8, 16))
    assert 1 in ks and 16 not in ks
    # non-epochable inputs keep k=1 only (wave-like: guarded upstream)
    assert exchange_every_candidates(prog, None, ks=(1,)) == [1]


def _strategy_key(s):
    return None if s is None else (tuple(s.grid_shape), tuple(s.axis_names), tuple(s.dims))


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_space_equals_the_reference_at_each_rank_count(n):
    """factorizations, mesh_assignments, strategy_candidates and
    exchange_every_candidates are the reference's, rank count by rank
    count (rank-1/2/3 programs; extents 32×24 and 16×16×12)."""
    rspace = _ref("tune.space")
    from repro_torch.tune import space

    assert space.factorizations(n) == rspace.factorizations(n)
    for rank in (1, 2, 3):
        assert space.mesh_assignments(n, rank) == rspace.mesh_assignments(n, rank)
    for shape, boundary in (((32, 24), "periodic"), ((16, 16, 12), "zero")):
        prog = P.heat("repro_torch", shape, 2, boundary)
        ref = P.heat("repro", shape, 2, boundary)
        mine = space.strategy_candidates(prog, n)
        theirs = rspace.strategy_candidates(ref, n)
        assert [_strategy_key(s) for s in mine] == [_strategy_key(s) for s in theirs]
        for s, rs in zip(mine, theirs):
            ks = (1, 2, 4, 8, 16)
            assert (space.exchange_every_candidates(prog, s, ks)
                    == rspace.exchange_every_candidates(ref, rs, ks))


def test_tile_candidates_divide_the_core_and_fit_one_cta():
    """K2's tile is offered only on fused candidates: None (its own
    choice) and the next two by its tile cost, each dividing the core and
    fitting the shared memory of one CTA."""
    from repro_torch.kernels import epoch_kernel as k2

    prog = _jacobi_prog((64, 32))
    fused = Target(backend="cuda", exchange_every=2, fused_epoch=True, device="cpu")
    tiles = tile_candidates(prog, fused)
    assert tiles[0] is None and 1 < len(tiles) <= 3
    local, _ = api.lower_local(prog, fused)
    (epoch,) = [op for op in local.body.ops if op.name == "stencil.fused_epoch"]
    chosen = k2.choose_tile(epoch)
    for t in tiles[1:]:
        assert t != chosen and all(n % x == 0 for n, x in zip((64, 32), t))
        assert k2.plan_epoch(epoch, t).tile == t  # K2 takes it
    costs = [k2.tile_cost(epoch, k2.plan_epoch(epoch, t)) for t in tiles[1:]]
    assert costs == sorted(costs)
    # an unfused epoch has no K2 and so no tile to vary
    unfused = Target(backend="cuda", exchange_every=2, device="cpu")
    assert tile_candidates(prog, unfused) == [None]


def test_enumerate_baseline_first_and_valid():
    prog = _jacobi_prog()
    cands = enumerate_candidates(prog, devices=ONE)
    assert cands[0].origin == "baseline"
    fps = [c.fingerprint for c in cands]
    assert len(fps) == len(set(fps)), "duplicate candidates"
    for c in cands[:6]:  # spot-check: every offered candidate validates
        api._validate_for_program(prog, c.target)
    # jit is not a search axis: every candidate keeps the compiled step
    assert all(c.target.jit for c in cands)
    # a tile only where K2 reads it
    assert all(c.target.fused_epoch for c in cands if c.target.tile is not None)


def test_enumerate_emits_fused_epoch_candidates():
    prog = _jacobi_prog()
    cands = enumerate_candidates(prog, devices=ONE)
    fused = [c for c in cands if c.target.fused_epoch]
    assert fused, "no fused_epoch candidates offered"
    for c in fused:
        assert c.target.backend == "cuda"
        assert not c.target.overlap  # fused ⊥ overlap
        assert "fused" in c.describe()
    # the axis can be switched off
    none_fused = enumerate_candidates(prog, devices=ONE, fused_epoch=(False,))
    assert not any(c.target.fused_epoch for c in none_fused)


def test_enumerate_follows_the_device_inventory(monkeypatch):
    """The counterpart of the reference's interpret-mode inventory test:
    candidates live on the devices given (one CPU rank, or four repeated
    ones); with no devices given the space is the card's, and with no card
    the search raises instead of falling back to the CPU."""
    prog = _jacobi_prog()
    assert {c.target.device for c in enumerate_candidates(prog, devices=ONE)} == {"cpu"}
    four = enumerate_candidates(prog, devices=[CPU] * 4)
    assert four[0].origin == "baseline" and four[0].target.spatial_ranks == 4
    assert all(c.target.mesh is not None and c.target.mesh.device_type == "cpu"
               for c in four)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(TargetError, match="no CUDA device"):
        enumerate_candidates(prog)
    with pytest.raises(TargetError, match="requested 5 ranks, have 4 devices"):
        enumerate_candidates(prog, devices=[CPU] * 4, ranks=5)


def _project(target, mapping=lambda b: b):
    s = target.strategy
    strategy = None if s is None or not any(g > 1 for g in s.grid_shape) else _strategy_key(s)
    return (strategy, target.overlap, target.exchange_every, mapping(target.backend),
            target.fused_epoch)


def test_enumerate_on_one_device_equals_the_reference_space():
    """The port's candidates on one device are the reference's, projected
    to (strategy, overlap, k, backend, fused_epoch) after jnp→torch and
    pallas→cuda and without the tiles; the baseline first in both."""
    rspace = _ref("tune.space")
    to_port = {"jnp": "torch", "pallas": "cuda"}.get
    prog, ref = _jacobi_prog(), _jacobi_prog(pkg="repro")
    mine = [_project(c.target) for c in enumerate_candidates(prog, devices=ONE)]
    theirs = [_project(c.target, to_port) for c in rspace.enumerate_candidates(ref)]
    assert mine[0] == theirs[0] == (None, False, 1, "torch", False)
    assert set(mine) == set(theirs)


# -------------------------------------------------------------------------
# Target.auto
# -------------------------------------------------------------------------


def test_target_auto_decomposes_over_the_devices(monkeypatch):
    one = Target.auto(device="cpu")
    assert one.mesh is None and one.device == "cpu"
    four = Target.auto(ranks=4, device="cpu", backend="cuda")
    assert four.distributed and four.backend == "cuda"
    assert four.strategy.grid_shape == (4,) and four.strategy.dims == (0,)
    assert list(four.mesh.shape.values()) == [4] and four.mesh.device_type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(TargetError, match="no CUDA device"):
        Target.auto()
    # one card: a single-device target on it; more ranks than cards raise
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert Target.auto().device == "cuda:0" and Target.auto().mesh is None
    with pytest.raises(TargetError, match="requested 2 ranks, have 1 devices"):
        Target.auto(ranks=2)


def test_target_auto_runs_ranks_on_several_cards_op_by_op(monkeypatch):
    """Over two cards ``Target.auto`` decomposes over both and runs the
    ranks op by op (``jit=False``: one captured graph runs on one card),
    and the search offers and labels two-rank candidates alike; ranks
    repeated on one card keep the compiled step."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    two = Target.auto()
    assert two.spatial_ranks == 2 and not two.jit
    assert [str(d) for d in two.mesh.devices.flat] == ["cuda:0", "cuda:1"]
    with pytest.raises(TargetError, match="one captured graph runs on one device"):
        Target.auto(jit=True)
    assert Target.auto(ranks=1).jit and Target.auto(ranks=1).device == "cuda:0"
    assert Target.auto(ranks=2, device="cuda:0").jit
    prog = _jacobi_prog()
    cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
    cands = enumerate_candidates(prog, devices=cards)
    assert cands[0].origin == "baseline" and cands[0].target.fingerprint == two.fingerprint
    assert len(cands) > 1
    assert all(c.target.spatial_ranks == 2 and not c.target.jit for c in cands)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "card")
    assert tune_cache.hardware_signature(cards) == "cuda:card:n2"


# -------------------------------------------------------------------------
# cost-model-only tuning + the persistent cache (acceptance)
# -------------------------------------------------------------------------


def test_tuned_cost_model_only_winner_and_cache(tune_dir):
    prog = _jacobi_prog(name="tune_cost_only")
    res = tune(prog, devices=ONE, measure=False)
    assert not res.from_cache
    assert cache_stats().misses == 1 and cache_stats().stores == 1

    # the winner is a *validated* Target: it compiles
    compiled = api.compile(prog, res.target)
    assert compiled.target.fingerprint == res.target.fingerprint

    # winner's modeled step_time ≤ every unpruned candidate's
    unpruned = [c for c in res.candidates if not c.pruned]
    assert unpruned and res.winner in unpruned
    assert all(
        res.winner.modeled_s <= c.modeled_s for c in unpruned
    ), [(c.describe(), c.modeled_s) for c in unpruned]

    # second call: persistent-cache hit with the identical winner
    res2 = tune(prog, devices=ONE, measure=False)
    assert res2.from_cache
    assert cache_stats().hits == 1
    assert res2.target.fingerprint == res.target.fingerprint
    assert os.path.exists(res2.cache_path)
    assert Path(res2.cache_path).parent == Path(tune_dir)

    # Target.tuned surfaces the same winner (third call, second hit)
    t = Target.tuned(prog, measure=False, devices=ONE)
    assert t.fingerprint == res.target.fingerprint
    assert cache_stats().hits == 2


def test_compile_tune_kwarg(tune_dir):
    prog = _jacobi_prog(name="tune_compile_kwarg")
    step = api.compile(prog, tune={"measure": False, "devices": ONE})
    assert isinstance(step, api.CompiledStencil)
    with pytest.raises(ValueError, match="not both"):
        api.compile(prog, Target(device="cpu"), tune={"measure": False, "devices": ONE})
    # tuned target round-trips through the compile cache
    again = api.compile(prog, tune={"measure": False, "devices": ONE})
    assert again is step


def test_tune_measure_single_device(tune_dir):
    prog = _jacobi_prog((16, 16), name="tune_measured")
    res = tune(
        prog, devices=ONE, measure=True, steps=4, trials=2, warmup=1,
        backends=("torch",), exchange_every=(1, 2),
    )
    measured = [c for c in res.candidates if c.measured_s is not None]
    assert measured and res.winner in measured
    assert all(res.winner.measured_s <= c.measured_s for c in measured)
    # pruned candidates were never measured
    assert all(c.measured_s is None for c in res.candidates if c.pruned)
    # measurement protocol: per-step normalization keeps epochs comparable
    compiled = api.compile(prog, res.target)
    t = measure_compiled(compiled, steps=2, trials=1, warmup=1)
    assert t > 0.0 and math.isfinite(t)


def test_measurement_releases_what_the_search_compiled(tune_dir):
    """Each survivor is released once it is timed: what the search
    compiled leaves the compile cache, and an artifact the caller had
    compiled stays there with its graphs dropped."""
    prog = _jacobi_prog((16, 16), name="tune_release")
    mine = api.compile(prog, Target(device="cpu"))
    mine._ring = object()  # stands for a compiled step's graphs
    res = tune(prog, devices=ONE, measure=True, steps=2, trials=1,
               backends=("torch", "cuda"), exchange_every=(1,), overlap=(False,))
    measured = [c for c in res.candidates if c.measured_s is not None]
    assert len(measured) >= 2 and not any(c.note for c in measured)
    assert api.is_cached(prog, mine.target) and mine._ring is None
    assert not any(api.is_cached(prog, c.target) for c in measured
                   if c.fingerprint != mine.target.fingerprint)
    mine._ring = object()
    api.forget(prog, mine.target)
    assert not api.is_cached(prog, mine.target) and mine._ring is None


@pytest.mark.parametrize("fault", ["build", "launch"])
def test_a_kernel_failure_on_the_card_raises_out_of_tune(tune_dir, monkeypatch, fault):
    """A cuda candidate on the card whose K1/K2 source does not build, or
    whose kernel does not launch, raises out of ``tune`` (no plain-version
    winner is returned or stored); a torch candidate's failure there stays
    a note on it.  The card is stood in for on the CPU: sources are
    emitted on the host, the build and the timed run are replaced."""
    from repro_torch.kernels import stencil_apply
    from repro_torch.tune import measure as tune_measure

    prog = _jacobi_prog((16, 16), name=f"tune_fault_{fault}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "card")
    built = []

    def build(sources):
        built.extend(sources)
        if fault == "build":
            raise RuntimeError("kernel build failed: nvcc exited 1")
        return []

    def timed(compiled, **kw):
        if compiled.target.backend == "cuda":
            raise RuntimeError("K1 launch failed with CUDA error 98")
        raise RuntimeError("out of memory")

    monkeypatch.setattr(stencil_apply, "build", build)
    monkeypatch.setattr(tune_measure, "measurement_state", lambda compiled: ())
    monkeypatch.setattr(tune_measure, "measure_compiled", timed)
    match = "kernel build failed" if fault == "build" else "K1 launch failed"
    with pytest.raises(RuntimeError, match=match):
        tune(prog, devices=[torch.device("cuda", 0)], measure=True, exchange_every=(1,),
             overlap=(False,))
    assert built, "the survivors' sources were not built"
    assert tune_cache.cache_stats().stores == 0
    # the torch candidates alone: their failure is noted, not raised
    res = tune(prog, devices=[torch.device("cuda", 0)], measure=True, cache=False,
               backends=("torch",), exchange_every=(1,), overlap=(False,))
    assert res.candidates and all("out of memory" in c.note for c in res.candidates)


def test_single_device_model_has_no_phantom_latency(tune_dir):
    # a non-distributed artifact's exchanges are emulated locally — no
    # messages, so the modeled score must not reward deep epochs with
    # latency amortization that cannot happen; the modeled winner on one
    # device keeps one exchange per step
    prog = _jacobi_prog(name="tune_no_phantom")
    res = tune(prog, ranks=1, devices=ONE, measure=False)
    assert res.target.exchange_every == 1, res.winner.describe()


def test_tune_raises_informatively_when_nothing_models(tune_dir, monkeypatch):
    prog = _jacobi_prog(name="tune_all_fail")

    def boom(*a, **k):
        raise RuntimeError("backend exploded")

    monkeypatch.setattr(api, "compile", boom)
    with pytest.raises(RuntimeError, match="no candidate .* could be modeled"):
        tune(prog, devices=ONE, measure=False, cache=False)


def test_measurement_protocol_changes_cache_key(tune_dir):
    # steps/trials/warmup are part of the options digest: a
    # higher-fidelity search must not read back a low-fidelity entry
    prog = _jacobi_prog((16, 16), name="tune_protocol")
    kw = dict(devices=ONE, measure=True, backends=("torch",), exchange_every=(1,))
    r1 = tune(prog, steps=2, trials=1, warmup=1, **kw)
    r2 = tune(prog, steps=4, trials=2, warmup=1, **kw)
    assert r1.cache_key != r2.cache_key
    assert not r2.from_cache


def test_tune_result_table_prints(tune_dir):
    prog = _jacobi_prog(name="tune_table")
    res = tune(prog, devices=ONE, measure=False)
    text = res.table(top=5)
    assert "candidate" in text and "modeled/step" in text
    assert "baseline" in res.table()


def test_tuned_winner_agrees_with_the_reference(tune_dir):
    """A measured search on a 32² heat on the CPU: the winner's 8 steps
    are within 1e-5 of the reference's jnp run and bitwise the port's
    plain route."""
    rapi = _ref("api")
    prog, ref = P.heat("repro_torch", (32, 32), 2), P.heat("repro", (32, 32), 2)
    res = tune(prog, devices=ONE, measure=True)
    measured = [c for c in res.candidates if c.measured_s is not None]
    assert res.winner in measured and not any(c.note for c in measured)
    assert res.winner.measured_s == min(c.measured_s for c in measured)
    state = P.rand_state(ref, 5)
    (got,) = api.compile(prog, res.target).time_loop([torch.from_numpy(a) for a in state], 8)
    (want,) = rapi.compile(ref, rapi.Target(backend="jnp")).time_loop(state, 8)
    torch.testing.assert_close(got, torch.from_numpy(np.array(want)), **TOL)
    (plain,) = api.compile(prog, Target(device="cpu")).time_loop(
        [torch.from_numpy(a) for a in state], 8)
    assert torch.equal(got, plain)


def test_cli_prints_a_winner(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               REPRO_TORCH_TUNE_CACHE=str(tmp_path / "cli-cache"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.tune", "--device", "cpu", "--size", "32", "--json"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    record = json.loads(out.stdout)
    assert record["hardware"] == "cpu:cpu:n1" and record["n_ranks"] == 1
    assert record["winner"]["describe"].startswith("grid=1 backend=")
    assert record["ranked"] and not record["from_cache"]
    assert (tmp_path / "cli-cache" / f"{record['cache_key']}.json").exists()


# -------------------------------------------------------------------------
# the reference's dist_worker scenarios, on virtual CPU ranks
# -------------------------------------------------------------------------


def _step_n(step, u0, n):
    u = u0
    for _ in range(n):
        (u,) = step(u, torch.zeros_like(u))
    return u


def test_tune_4rank(tune_dir):
    """``tune-4rank``: a measured search on a 4-rank mesh; the winner is
    the measured argmin, no slower than the ``Target.auto()`` baseline;
    a second search is a disk-cache hit with the same winner; the winner
    is bitwise the single-device run."""
    shape = (64, 32)
    prog = P.jacobi("repro_torch", shape, "periodic")
    kwargs = dict(
        ranks=4, devices=[CPU] * 4, measure=True, steps=4, trials=2, warmup=1,
        backends=("torch",), exchange_every=(1, 2, 4), overlap=(False, True),
    )
    res = tune(prog, **kwargs)
    assert not res.from_cache and cache_stats().stores == 1
    measured = [c for c in res.candidates if c.measured_s is not None]
    assert res.winner in measured, "winner must come from the measured set"
    assert all(res.winner.measured_s <= c.measured_s for c in measured)
    baseline = [c for c in measured if c.origin == "baseline"]
    assert baseline, "the Target.auto() default must always be measured"
    assert res.winner.measured_s <= baseline[0].measured_s
    assert res.hardware == "cpu:cpu:n4"

    res2 = tune(prog, **kwargs)
    assert res2.from_cache and cache_stats().hits == 1
    assert res2.target.fingerprint == res.winner.fingerprint

    u0 = torch.from_numpy(np.random.default_rng(42).standard_normal(shape).astype(np.float32))
    k = res.target.exchange_every
    tuned = api.compile(prog, res.target)
    got = u0
    for _ in range(4 // k):
        (got,) = tuned(got, torch.zeros_like(got))
    want = _step_n(api.compile(prog, Target(device="cpu")), u0, 4)
    assert torch.equal(got, want)


def test_tune_transfer(tune_dir):
    """``tune-transfer``: a winner tuned at 2 ranks transfers to a 4-rank
    job (the rank count is part of the hardware signature), counts as a
    transfer hit (never a hit) and is the stored winner verbatim."""
    prog = P.jacobi("repro_torch", (64, 32), "periodic")
    kwargs = dict(
        devices=[CPU] * 4, measure=False, backends=("torch",), exchange_every=(1, 2),
        overlap=(False,), fused_epoch=(False,),
    )
    res2 = tune(prog, ranks=2, **kwargs)
    assert not res2.from_cache and cache_stats().stores == 1

    reset_cache_stats()
    moved = tune(prog, ranks=4, transfer=True, **kwargs)
    s = cache_stats().as_dict()
    assert moved.from_cache and moved.winner.origin == "transfer"
    assert s["transfer_hits"] == 1 and s["hits"] == 0 and s["stores"] == 0, s
    assert moved.target.fingerprint == res2.target.fingerprint

    reset_cache_stats()
    fresh = tune(prog, ranks=4, **kwargs)
    s = cache_stats().as_dict()
    assert not fresh.from_cache and s["transfer_hits"] == 0, s


# -------------------------------------------------------------------------
# cache internals
# -------------------------------------------------------------------------


def test_target_dict_roundtrip_fingerprint():
    t = Target(backend="cuda", tile=(8, 16), exchange_every=2, overlap=True, device="cpu")
    d = target_to_dict(t)
    back = target_from_dict(d)
    assert back.fingerprint == t.fingerprint == d["fingerprint"]
    assert back.tile == (8, 16) and back.exchange_every == 2
    mesh = Target(mesh=_cpu_mesh((2, 2)), strategy=make_strategy_2d((2, 2)), backend="cuda")
    again = target_from_dict(target_to_dict(mesh))
    assert again.fingerprint == mesh.fingerprint and again.mesh.device_type == "cpu"


def test_target_dict_roundtrips_fused_epoch():
    t = Target(backend="cuda", exchange_every=4, fused_epoch=True, device="cpu")
    d = target_to_dict(t)
    assert d["fused_epoch"] is True
    back = target_from_dict(d)
    assert back.fused_epoch and back.fingerprint == t.fingerprint
    # a winner dict without the fused_epoch field rebuilds as unfused
    # rather than erroring
    legacy = {k: v for k, v in d.items() if k != "fused_epoch"}
    old = target_from_dict(legacy)
    assert not old.fused_epoch
    assert old.fingerprint != t.fingerprint


@pytest.mark.parametrize("tile", [None, (8, 16)])
def test_target_from_dict_reads_the_reference_dict(tile):
    """The reference's ``target_to_dict`` of a 2×2 fused k=4 target (and
    of a single-device pallas target with a tile, and of the 2×2 target's
    slot-axis sibling) becomes the port's counterpart; its own round trip
    keeps its fingerprint.  A slot axis that is not a mesh axis makes no
    target."""
    import jax
    from jax.sharding import Mesh as JaxMesh

    rapi, rcache = _ref("api"), _ref("tune.cache")
    rstrategy = _ref("core.passes.decompose").make_strategy_2d
    jmesh = JaxMesh(np.array([jax.devices()[0]] * 4).reshape(2, 2), ("x", "y"))
    ref = rapi.Target(mesh=jmesh, strategy=rstrategy((2, 2)), backend="pallas",
                      exchange_every=4, fused_epoch=True, pallas_tile=tile)
    got = target_from_dict(rcache.target_to_dict(ref), devices=[CPU] * 4)
    want = Target(mesh=_cpu_mesh((2, 2)), strategy=make_strategy_2d((2, 2)), backend="cuda",
                  exchange_every=4, fused_epoch=True, tile=tile)
    assert got.fingerprint == want.fingerprint
    assert target_from_dict(target_to_dict(got)).fingerprint == got.fingerprint
    one = target_from_dict(
        rcache.target_to_dict(rapi.Target(backend="pallas", pallas_tile=tile)), devices=ONE)
    assert one.fingerprint == Target(backend="cuda", tile=tile, device="cpu").fingerprint
    pooled = target_from_dict(rcache.target_to_dict(rapi.pooled_target(ref, slots=1)),
                              devices=[CPU] * 4)
    assert pooled.fingerprint == api.pooled_target(want, slots=1).fingerprint
    assert target_from_dict(target_to_dict(pooled)).fingerprint == pooled.fingerprint
    with pytest.raises(tune_cache.TuneCacheError, match="slot"):
        target_from_dict({**rcache.target_to_dict(ref), "slot_axis": "slot"}, devices=[CPU] * 4)


def test_cache_schema_and_corruption_are_misses(tune_dir):
    key = tune_cache.cache_key("fp", "hw", 1, "opts")
    assert tune_cache.load(key) is None  # cold
    tune_cache.store(key, {"winner": {}})
    assert tune_cache.load(key) is not None
    # corrupt file → miss, not an exception
    with open(tune_cache.entry_path(key), "w") as f:
        f.write("{not json")
    assert tune_cache.load(key) is None
    # schema drift → miss
    with open(tune_cache.entry_path(key), "w") as f:
        json.dump({"schema": tune_cache.SCHEMA_VERSION + 1}, f)
    assert tune_cache.load(key) is None


def test_cache_key_separates_programs_hardware_ranks():
    k = tune_cache.cache_key
    assert k("a", "hw", 1, "o") != k("b", "hw", 1, "o")
    assert k("a", "hw", 1, "o") != k("a", "hw2", 1, "o")
    assert k("a", "hw", 1, "o") != k("a", "hw", 2, "o")
    assert k("a", "hw", 1, "o") != k("a", "hw", 1, "o2")


def test_cache_dir_is_the_ports_own(monkeypatch, tmp_path):
    monkeypatch.delenv("REPRO_TORCH_TUNE_CACHE", raising=False)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    assert tune_cache.cache_dir() == str(tmp_path / "repro-torch-tune")
    assert tune_cache.cache_dir() != _ref("tune.cache").cache_dir()


def test_stale_cache_entry_for_other_program_misses(tune_dir):
    # an entry whose winner no longer validates for the program reads as
    # a miss (fresh search), never as a wrong answer
    prog = _jacobi_prog(name="tune_stale")
    res = tune(prog, devices=ONE, measure=False)
    with open(res.cache_path) as f:
        entry = json.load(f)
    entry["winner"]["strategy"] = {"grid": [5], "axes": ["x"], "dims": [0]}
    entry["winner"]["mesh"] = None
    with open(res.cache_path, "w") as f:
        json.dump(entry, f)
    reset_cache_stats()
    res2 = tune(prog, devices=ONE, measure=False)
    assert not res2.from_cache  # fingerprint/validation rejected the entry
    # the rejected load is counted as a miss, not a hit: the search ran
    assert cache_stats().hits == 0 and cache_stats().misses == 1, (
        cache_stats().as_dict()
    )


# -------------------------------------------------------------------------
# RooflineTerms: the reference's arithmetic, edge cases, and cost()
# -------------------------------------------------------------------------

_CONSTANTS = ("PEAK_FLOPS", "HBM_BW", "LINK_BW", "LINK_LATENCY")


@settings(max_examples=60, deadline=None)
@given(
    flops=st.floats(0.0, 1e13), n_bytes=st.floats(0.0, 1e12), coll=st.floats(0.0, 1e9),
    k=st.integers(1, 8), msgs=st.integers(0, 16), rank=st.integers(1, 3),
    halo=st.tuples(st.integers(0, 4), st.integers(0, 4), st.integers(0, 4)),
    shape=st.tuples(st.integers(1, 512), st.integers(1, 512), st.integers(1, 512)),
)
def test_roofline_terms_are_the_references(flops, n_bytes, coll, k, msgs, rank, halo, shape):
    """With the port's four H100 constants set to the reference's TPU
    ones, ``as_dict()``, ``step_time(k)`` and ``ranked_exchange_every(8)``
    equal the reference's exactly."""
    rroof = _ref("launch.roofline")
    kw = dict(flops=flops, bytes_accessed=n_bytes, collectives={"collective-permute": coll},
              exchange_every=k, messages_per_epoch=msgs, step_halo=halo[:rank],
              local_shape=shape[:rank])
    saved = {c: getattr(roofline, c) for c in _CONSTANTS}
    try:
        for c in _CONSTANTS:
            setattr(roofline, c, getattr(rroof, c))
        mine, theirs = RooflineTerms(**kw), rroof.RooflineTerms(**kw)
        assert mine.as_dict() == theirs.as_dict()
        assert [mine.step_time(j) for j in range(1, 9)] == [theirs.step_time(j) for j in range(1, 9)]
        assert mine.ranked_exchange_every(8) == theirs.ranked_exchange_every(8)
    finally:
        for c, v in saved.items():
            setattr(roofline, c, v)


def test_roofline_constants_are_an_h100s():
    assert roofline.PEAK_FLOPS == 67e12 and roofline.HBM_BW == 3.35e12
    assert roofline.LINK_BW == roofline.HBM_BW / 2
    assert 0 < roofline.LINK_LATENCY < 1e-4


def _terms(**kw):
    base = dict(
        flops=1e6, bytes_accessed=1e5, collectives={},
        exchange_every=1, messages_per_epoch=8,
        step_halo=(1, 1), local_shape=(64, 64),
    )
    base.update(kw)
    return RooflineTerms(**base)


def test_recommend_clamps_to_max_k():
    lat = _terms(local_shape=(256, 256))  # latency-dominated: deeper is better
    assert lat.recommend_exchange_every(max_k=8) > 2
    assert lat.recommend_exchange_every(max_k=2) <= 2
    assert lat.recommend_exchange_every(max_k=1) == 1


def test_recommend_returns_1_when_no_latency():
    # t_latency == 0 (no messages): amortization buys nothing, redundant
    # compute only costs — k=1 must win
    quiet = _terms(messages_per_epoch=0)
    assert quiet.t_latency == 0.0
    assert quiet.recommend_exchange_every(max_k=8) == 1
    # no halo at all: terms unavailable → 1
    assert _terms(step_halo=(0, 0)).recommend_exchange_every() == 1
    assert _terms(step_halo=(), local_shape=()).recommend_exchange_every() == 1


def test_recommend_skips_infeasible_k():
    tiny = _terms(local_shape=(4, 4), step_halo=(1, 1))
    assert not tiny.feasible_exchange_every(8)  # deep halo 8 > shard 4
    ranked = tiny.ranked_exchange_every(max_k=8)
    assert all(k <= 4 for k, _ in ranked)
    assert tiny.recommend_exchange_every(max_k=8) <= 4


def test_step_time_monotone_pieces():
    t = _terms()
    # redundant-compute factor: 1.0 at k=1, nondecreasing in k
    rcf = [t.redundant_compute_factor(k) for k in (1, 2, 4, 8)]
    assert rcf[0] == 1.0
    assert all(a <= b for a, b in zip(rcf, rcf[1:]))
    assert rcf[-1] > 1.0
    # latency piece: with a huge shard (rcf ≈ 1) step_time strictly
    # decreases with k — pure 1/k amortization
    lat = _terms(local_shape=(10_000, 10_000))
    times = [lat.step_time(k) for k in (1, 2, 4, 8)]
    assert all(a > b for a, b in zip(times, times[1:]))
    # with no messages, step_time is nondecreasing in k (redundant
    # compute only)
    quiet = _terms(messages_per_epoch=0)
    times = [quiet.step_time(k) for k in (1, 2, 4, 8)]
    assert all(a <= b for a, b in zip(times, times[1:]))


def test_ranked_exchange_every_best_first():
    t = _terms(local_shape=(256, 256))
    ranked = t.ranked_exchange_every(max_k=8)
    assert ranked[0][0] == t.recommend_exchange_every(max_k=8)
    times = [s for _, s in ranked]
    assert times == sorted(times)
    assert 1 in [k for k, _ in ranked]


def test_cost_carries_tiling_terms_and_recommends():
    """``tests/test_temporal.py``'s case, on the port's ``cost()``."""
    prog = P.jacobi("repro_torch", (16, 16), "periodic")
    terms = api.compile(prog, Target(device="cpu")).cost()
    assert terms.exchange_every == 1
    assert terms.messages_per_epoch == 4  # 4 faces on the trivial 2-d grid
    assert terms.step_halo == (1, 1)
    assert terms.local_shape == (16, 16)
    assert terms.redundant_compute_factor(1) == 1.0
    assert terms.redundant_compute_factor(4) > 1.0
    d = terms.as_dict()
    assert "recommended_exchange_every" in d and "t_latency" in d

    # latency-dominated regime (tiny shard, many messages): deep epochs win
    lat = RooflineTerms(
        flops=1e6, bytes_accessed=1e5, collectives={},
        exchange_every=1, messages_per_epoch=8,
        step_halo=(1, 1), local_shape=(32, 32),
    )
    assert lat.recommend_exchange_every(max_k=8) > 1
    # compute-dominated regime (huge shard FLOPs): stay at k=1
    comp = RooflineTerms(
        flops=1e13, bytes_accessed=1e5, collectives={},
        exchange_every=1, messages_per_epoch=2,
        step_halo=(4, 4), local_shape=(8, 8),
    )
    assert comp.recommend_exchange_every(max_k=8) == 1
    # infeasible depths (deep halo > shard) are never recommended
    assert not lat.feasible_exchange_every(64)


_STRUCTURAL = {
    "heat so2": (lambda pkg: P.heat(pkg, (16, 16), 2), {}),
    "heat so4": (lambda pkg: P.heat(pkg, (24, 16), 4, "periodic"), {}),
    "wave so2": (lambda pkg: P.wave(pkg, (16, 16), 2), {}),
    "wave so4": (lambda pkg: P.wave(pkg, (24, 16), 4), {}),
    "heat so4 k=2": (lambda pkg: P.heat(pkg, (24, 16), 4), {"exchange_every": 2}),
    "heat 3-D so2": (lambda pkg: P.heat(pkg, (8, 10, 12), 2), {}),
}


@pytest.mark.parametrize("name", sorted(_STRUCTURAL))
def test_cost_structural_terms_equal_the_references(name):
    """exchange_every, messages_per_epoch, step_halo, local_shape and
    redundant_compute_factor(4) of ``cost()`` are the reference's (its
    2×2 case runs in ``tests/torch_dist_worker.py``, on virtual XLA
    devices)."""
    rapi = _ref("api")
    make, kw = _STRUCTURAL[name]
    mine = api.compile(make("repro_torch"), Target(device="cpu", **kw)).cost()
    theirs = rapi.compile(make("repro"), rapi.Target(**kw)).cost()
    for attr in ("exchange_every", "messages_per_epoch", "step_halo"):
        assert getattr(mine, attr) == getattr(theirs, attr), attr
    assert tuple(mine.local_shape) == tuple(theirs.local_shape)
    assert mine.redundant_compute_factor(4) == theirs.redundant_compute_factor(4)


def test_cost_counts_a_five_point_star_by_hand():
    """Jacobi (3 adds, 1 multiply) on 16², one device: the apply reads
    its 18² window and writes 16² points; the halo pad reads the 16² core
    and writes the 18² padded buffer; no byte reaches another rank."""
    terms = api.compile(P.jacobi("repro_torch", (16, 16), "zero"), Target(device="cpu")).cost()
    assert terms.flops == 4 * 16 * 16
    assert terms.bytes_accessed == 4 * (18 * 18 + 16 * 16) * 2
    assert terms.collectives == {} and terms.dominant == "memory"
    assert terms.t_memory == terms.bytes_accessed / roofline.HBM_BW
    # float64 counts 8 bytes a point
    f64 = api.compile(P.jacobi("repro_torch", (16, 16), "zero"), Target(device="cpu")).cost(
        torch.float64)
    assert f64.bytes_accessed == 2 * terms.bytes_accessed


def test_cost_counts_a_fused_epoch_by_hand():
    """A fused k=2 epoch of the same star: the sub-steps compute 18² and
    16² points; K2 reads its 20² operand and writes the 16² escape once;
    the pad reads 16² and writes 20²."""
    prog = P.jacobi("repro_torch", (16, 16), "zero")
    terms = api.compile(prog, Target(device="cpu", backend="cuda", exchange_every=2,
                                     fused_epoch=True)).cost()
    assert terms.flops == 4 * (18 * 18 + 16 * 16)
    assert terms.bytes_accessed == 4 * (20 * 20 + 16 * 16) * 2
    assert terms.exchange_every == 2


@pytest.mark.parametrize("boundary,rects", [("zero", 2), ("periodic", 4)])
def test_cost_counts_a_padded_exchange_by_hand(boundary, rects):
    """The star on a 2×2 mesh of 8² shards: per rank the pad (8² → 10²)
    and the apply (10² window, 8² result); each send rectangle is 8
    floats, and a rank sends one per axis under zero BC (the edge ranks
    receive nothing from outside) and two per axis when periodic."""
    prog = P.jacobi("repro_torch", (16, 16), boundary)
    t = Target(mesh=_cpu_mesh((2, 2)), strategy=make_strategy_2d((2, 2)))
    terms = api.compile(prog, t).cost()
    assert terms.flops == 4 * 8 * 8
    assert terms.bytes_accessed == 4 * (10 * 10 + 8 * 8) * 2
    assert terms.collectives == {"collective-permute": 4.0 * 8 * rects}
    assert terms.messages_per_epoch == 4 and terms.local_shape == (8, 8)
    # one device emulates every exchange: nothing is sent
    assert api.compile(prog, Target(device="cpu")).cost().collectives == {}


# -------------------------------------------------------------------------
# tile validation (the reference's pallas_tile cases; K2 reads the tile)
# -------------------------------------------------------------------------


def test_tile_good_compiles():
    prog = _jacobi_prog((32, 32), name="tile_ok")
    step = api.compile(prog, Target(backend="cuda", exchange_every=2, fused_epoch=True,
                                    tile=(16, 32), device="cpu"))
    u0 = torch.from_numpy(np.random.default_rng(0).standard_normal((32, 32)).astype(np.float32))
    out = step(u0, torch.zeros_like(u0))
    assert torch.isfinite(out[0]).all()


def test_tile_wrong_rank_rejected():
    prog = _jacobi_prog((32, 32), name="tile_rank")
    with pytest.raises(TargetError, match=r"tile .* rank-2"):
        api.compile(prog, Target(backend="cuda", tile=(16,), device="cpu"))


def test_tile_nondividing_rejected_with_names():
    prog = _jacobi_prog((32, 32), name="tile_bad")
    with pytest.raises(TargetError) as e:
        api.compile(prog, Target(backend="cuda", tile=(7, 32), device="cpu"))
    msg = str(e.value)
    assert "(7, 32)" in msg            # the tile
    assert "(32, 32)" in msg           # the local shard shape
    assert "undecomposed" in msg       # the (non-)mesh axis
    assert "tile_bad" in msg


def test_tile_nonpositive_rejected():
    with pytest.raises(TargetError, match="positive"):
        Target(backend="cuda", tile=(0, 32), device="cpu")


@pytest.mark.parametrize("kw", [{"overlap": True}, {"exchange_every": 2}, {"backend": "torch"}])
def test_tile_is_checked_on_every_path(kw):
    """Where the reference accepts a shard-nondividing ``pallas_tile``
    (its Pallas blocks re-tile on the overlap and temporal paths, and jnp
    reads no tile), the port refuses it on every path: K2, the only
    reader of a tile, never re-tiles, and the tuner offers tiles on fused
    candidates only.  The rank check holds everywhere too."""
    prog = _jacobi_prog((32, 32), name="tile_paths")
    kw = {"backend": "cuda", **kw}
    with pytest.raises(TargetError, match="does not divide"):
        api._validate_for_program(prog, Target(tile=(7, 32), device="cpu", **kw))
    with pytest.raises(TargetError, match="rank-2"):
        api._validate_for_program(prog, Target(tile=(7,), device="cpu", **kw))
    api._validate_for_program(prog, Target(tile=(8, 32), device="cpu", **kw))  # divides


# -------------------------------------------------------------------------
# on the card
# -------------------------------------------------------------------------


@pytest.mark.gpu
def test_tuned_winner_on_card_is_bitwise_to_jit_false(tmp_path, monkeypatch):
    """A measured search on a 256² heat on the card with 3 survivors,
    each timed through K1/K2 and the compiled step: no survivor fails,
    the winner is the measured argmin, and its 8 steps equal
    ``Target(backend="cuda", jit=False)`` bitwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "tune"))
    dev = torch.device("cuda", 0)
    prog = P.heat("repro_torch", (256, 256), 4)
    res = tune(prog, devices=[dev], measure=True, keep_quantile=0.0, min_keep=3)
    measured = [c for c in res.candidates if c.measured_s is not None]
    assert len(measured) == 3 and not any(c.note for c in measured), res.table()
    assert res.winner.measured_s == min(c.measured_s for c in measured)
    assert res.hardware.startswith("cuda:") and res.hardware.endswith(":n1")
    gen = torch.Generator(device=dev).manual_seed(0)
    state = (torch.randn((256, 256), device=dev, generator=gen),)
    got = api.compile(prog, res.target).time_loop(state, 8)
    want = api.compile(prog, Target(backend="cuda", jit=False, device=str(dev))).time_loop(state, 8)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0])


@pytest.mark.gpu
def test_tuned_winner_over_several_cards_is_bitwise_to_one_card(tmp_path, monkeypatch):
    """With two or more cards, ``Target.auto`` and the search decompose
    over every card, op by op (``jit=False``); each survivor is timed
    through K1/K2 on its rank's card, and the winner's 8 steps equal one
    card's ``Target(backend="cuda", jit=False)`` bitwise, as does the
    baseline's."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA devices")
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "tune"))
    n = torch.cuda.device_count()
    prog = P.heat("repro_torch", (64 * n, 256), 4)
    auto = Target.auto()
    assert auto.spatial_ranks == n and not auto.jit
    res = tune(prog, measure=True, keep_quantile=0.0, min_keep=3)
    measured = [c for c in res.candidates if c.measured_s is not None]
    assert len(measured) >= 3 and not any(c.note for c in measured), res.table()
    assert all(c.target.spatial_ranks == n and not c.target.jit for c in res.candidates)
    assert res.winner.measured_s == min(c.measured_s for c in measured)
    assert res.hardware.endswith(f":n{n}")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    state = (torch.randn((64 * n, 256), device=dev, generator=gen),)
    want = api.compile(prog, Target(backend="cuda", jit=False, device=str(dev))).time_loop(state, 8)
    for target in (res.target, auto):
        got = api.compile(prog, target).time_loop(state, 8)
        torch.cuda.synchronize()
        assert torch.equal(got[0].to(dev), want[0]), target


# -------------------------------------------------------------------------
# slot-pool widths (the ensemble axis of the serving engine)
# -------------------------------------------------------------------------


def test_slot_width_candidates_divide_capacity_and_fit_inventory():
    from repro_torch.tune.space import slot_width_candidates

    assert slot_width_candidates(8, 2, 4) == [4, 2, 1]
    assert slot_width_candidates(8, 4, 6) == [2, 1]  # 6 devices short of 3×4
    assert slot_width_candidates(8, 2, 6) == [3, 2, 1]  # 4 ∤ 6 dropped
    assert slot_width_candidates(1, 1, 4) == [1]  # a single device still pools
    for s in slot_width_candidates(16, 2, 12):
        assert 12 % s == 0 and s * 2 <= 16
    ref = _ref("tune.space").slot_width_candidates
    for args in [(8, 2, 4), (8, 4, 6), (8, 2, 6), (1, 1, 4), (16, 2, 12), (3, 5, 7)]:
        assert slot_width_candidates(*args) == ref(*args)


def test_enumerate_pool_candidates_single_device():
    """On a one-device inventory the pool space is the pure-ensemble
    slot-axis candidate (a trivial spatial grid at width 1), a valid,
    compilable slot-axis Target; on four repeated devices every width
    that divides the pool appears, widest first."""
    from repro_torch.tune.space import enumerate_pool_candidates

    prog = P.jacobi("repro_torch", (16, 16))
    cands = enumerate_pool_candidates(prog, capacity=4, devices=ONE)
    assert cands, "always at least the width-1 pool"
    for c in cands:
        assert c.origin == "pool"
        assert c.target.slot_axis == "slot"
        assert "slot" in c.target.mesh.axis_names
        assert c.note.startswith("slots=")
    fps = [c.fingerprint for c in cands]
    assert len(fps) == len(set(fps))
    assert Target(device="cpu").fingerprint not in fps
    step = api.compile(prog, cands[0].target)
    u = torch.from_numpy(np.random.default_rng(0).standard_normal((4, 16, 16)).astype(np.float32))
    (got,) = step.time_loop((u,), 2)
    solo = api.compile(prog, Target(device="cpu"))
    for b in range(4):
        assert torch.equal(got[b], solo.time_loop((u[b],), 2)[0])
    wide = enumerate_pool_candidates(prog, capacity=4, devices=[CPU] * 4)
    widths = [int(c.note.split("=")[1]) for c in wide]
    assert widths == sorted(widths, reverse=True) and set(widths) == {4, 2, 1}
