"""The port's checkpointing and resilience layer
(``repro_torch.checkpoint``, ``repro_torch.resilience``,
``repro_torch.resilient_loop``/``resume``), on the CPU.

The port of ``tests/test_resilience.py`` case by case (its engine
migration cases through ``repro_torch.serve.stencil``), of its two tune-transfer
cases against ``repro_torch.tune.cache.lookup_transfer``, and of
``tests/dist_worker.py``'s ``resilience-*`` scenario on virtual CPU ranks
in process: 4 → 2 ranks, one device → 2×2 and 2×2 → one device.  Within
torch a resumed run (or a migrated request) is bitwise equal to the
uninterrupted one; a request that either package's engine evacuates, the
other's admits, within rtol=atol=1e-5 of the reference's solo run.  Across
the packages a snapshot written by either resumes in the other, within
rtol=atol=1e-5 of the reference's uninterrupted run, and both write the
same manifest keys and leaf files.  The compiled step's ring runs on the
CPU here by forcing ``_graphed`` (as ``tests/test_torch_jit.py`` does),
to show that checkpoints keep the ring and copy the state off it.
"""
import importlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.api import Target, TargetError
from repro_torch.checkpoint import Checkpointer, global_stats
from repro_torch.checkpoint.checkpointer import _flatten
from repro_torch.core.passes.decompose import make_strategy_1d, make_strategy_2d
from repro_torch.dist import Mesh, ShardedTensor, gather
from repro_torch.kernels import has_cuda
from repro_torch.resilience import (
    FaultPlan,
    ResilientLoop,
    ResumeError,
    SimulatedFault,
    resume,
    truncate_snapshot,
)

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
TOL = dict(rtol=1e-5, atol=1e-5)


def _pb(pkg):
    return importlib.import_module(f"{pkg}.frontends.oec_like").ProgramBuilder


def _heat(shape=(16, 16), alpha=0.25, name="heat_res", pkg="repro_torch"):
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
    return p.finish(boundary="periodic")


def _wave(shape=(16, 16), name="wave_res", pkg="repro_torch"):
    # p=2 inputs > q=1 output: the rotation phase advances by 1 per
    # epoch-step and must be restored exactly on resume
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
    return p.finish(boundary="zero")


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _cpu(**kw):
    return Target(device="cpu", **kw)


def _mesh(shape, names):
    n = int(np.prod(shape))
    return Mesh(np.array([CPU] * n, dtype=object).reshape(shape), names)


def _on_ranks(shape, **kw):
    if len(shape) == 1:
        return _cpu(mesh=_mesh(shape, ("x",)), strategy=make_strategy_1d(shape[0]), **kw)
    return _cpu(mesh=_mesh(shape, ("x", "y")), strategy=make_strategy_2d(tuple(shape)), **kw)


def _host(x) -> np.ndarray:
    if isinstance(x, ShardedTensor):
        x = gather(x)
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_bitwise(got, want, what):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want), (what, len(got), len(want))
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = _host(g), _host(w)
        assert np.array_equal(g, w), (
            f"{what}: buffer {i} differs (max |d| = {np.abs(g - w).max()})"
        )


def _kill(loop, epoch):
    with pytest.raises(SimulatedFault):
        loop.run()
    assert loop.events[-1][0] == "fault" and loop.events[-1][1] == epoch


# -------------------------------------------------------------------------
# driver: uninterrupted / kill-and-resume bitwise equality
# -------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 4])
def test_kill_and_resume_is_bitwise_heat(k, tmp_path):
    prog = _heat(name=f"heat_res_k{k}")
    u0 = _rand((16, 16), 0)
    tgt = _cpu(exchange_every=k)
    steps = 24
    ref = api.compile(prog, tgt).time_loop((u0,), steps)

    d = str(tmp_path / "ckpt")
    loop = ResilientLoop(
        prog, tgt, (u0,), steps, directory=d, checkpoint_every=1,
        fault_plan=FaultPlan(kill_at_epoch=(steps // k) // 2),
    )
    with pytest.raises(SimulatedFault):
        loop.run()
    assert ("fault", (steps // k) // 2, steps // 2) in loop.events

    resumed = resume(prog, d, tgt)
    assert resumed.step_count == steps // 2
    assert resumed.resumed_from == steps // 2
    assert set(resumed.timings) == {"compile_s", "place_s", "restore_s"}
    final = resumed.run()
    _assert_bitwise(final, ref, f"heat k={k} kill+resume vs time_loop")


def test_uninterrupted_resilient_run_matches_time_loop(tmp_path):
    prog = _heat(name="heat_res_full")
    u0 = _rand((16, 16), 1)
    tgt = _cpu(exchange_every=2)
    ref = api.compile(prog, tgt).time_loop((u0,), 16)
    final = ResilientLoop(
        prog, tgt, (u0,), 16, directory=str(tmp_path / "c"),
        checkpoint_every=2,
    ).run()
    _assert_bitwise(final, ref, "uninterrupted resilient run")


@pytest.mark.parametrize("k,kill_epoch", [(1, 5), (2, 3)])
def test_wave_rotation_phase_survives_resume(k, kill_epoch, tmp_path):
    """p=2 > q=1: resuming mid-run must continue the SAME buffer
    rotation — a kill at an odd step (k=1, epoch 5) leaves phase 1."""
    prog = _wave(name=f"wave_res_k{k}")
    s0 = tuple(_rand((16, 16), 10 + i) for i in range(2))
    tgt = _cpu(exchange_every=k)
    steps = 16
    ref = api.compile(prog, tgt).time_loop(s0, steps)

    d = str(tmp_path / "ckpt")
    loop = ResilientLoop(
        prog, tgt, s0, steps, directory=d, checkpoint_every=1,
        fault_plan=FaultPlan(kill_at_epoch=kill_epoch),
    )
    with pytest.raises(SimulatedFault):
        loop.run()

    resumed = resume(prog, d, tgt)
    assert resumed.step_count == kill_epoch * k
    # k=1 advances one buffer per epoch: odd kill epoch → odd phase
    want_phase = (kill_epoch * (1 if k == 1 else 2)) % 2
    assert resumed._phase == want_phase
    final = resumed.run()
    _assert_bitwise(final, ref, f"wave k={k} rotation-phase resume")


def test_resume_onto_different_exchange_every(tmp_path):
    """The snapshot is global state at an epoch-aligned step — a resumer
    may pick a different temporal-tiling depth and stay bitwise."""
    prog = _heat(name="heat_res_kchange")
    u0 = _rand((16, 16), 2)
    steps = 32
    ref = api.compile(prog, _cpu(exchange_every=4)).time_loop((u0,), steps)

    d = str(tmp_path / "ckpt")
    loop = ResilientLoop(
        prog, _cpu(exchange_every=4), (u0,), steps, directory=d,
        checkpoint_every=1, fault_plan=FaultPlan(kill_at_epoch=4),
    )
    with pytest.raises(SimulatedFault):
        loop.run()
    final = resume(prog, d, _cpu(exchange_every=2)).run()
    _assert_bitwise(final, ref, "resume k=4 -> k=2")


# -------------------------------------------------------------------------
# resume validation
# -------------------------------------------------------------------------


def test_resume_rejects_wrong_program(tmp_path):
    prog = _heat(name="heat_res_owner")
    other = _heat(alpha=0.2, name="heat_res_other")
    d = str(tmp_path / "ckpt")
    ResilientLoop(
        prog, _cpu(), (_rand((16, 16), 3),), 4, directory=d,
        checkpoint_every=1,
    ).run()
    with pytest.raises(ResumeError, match="fingerprint"):
        resume(other, d, _cpu())


def test_resume_rejects_epoch_misaligned_target(tmp_path):
    # killed at step 3 under k=1; k=3 divides step 3 but not the
    # remaining 5 of 8 steps — both alignment legs must hold
    prog = _heat(name="heat_res_align")
    d = str(tmp_path / "ckpt")
    loop = ResilientLoop(
        prog, _cpu(), (_rand((16, 16), 4),), 8, directory=d,
        checkpoint_every=1, fault_plan=FaultPlan(kill_at_epoch=3),
    )
    with pytest.raises(SimulatedFault):
        loop.run()
    with pytest.raises(ResumeError, match="whole epochs"):
        resume(prog, d, _cpu(exchange_every=3))
    with pytest.raises(ResumeError, match="epoch"):
        ResilientLoop(
            prog, _cpu(exchange_every=2), (_rand((16, 16), 4),), 8,
            start_step=3,
        )


def test_resume_without_metadata_is_rejected(tmp_path):
    d = str(tmp_path / "ckpt")
    Checkpointer(d).save(0, {"state": {"b0": np.zeros((4, 4))}},
                         blocking=True)
    with pytest.raises(ResumeError, match="metadata"):
        resume(_heat(name="heat_res_meta"), d, _cpu())


def test_input_shape_is_checked_on_every_kind_of_array():
    prog = _heat(name="heat_res_shape")
    bad = np.zeros((8, 16), np.float32)
    for arr in (bad, torch.from_numpy(bad)):
        with pytest.raises(ValueError, match="shape"):
            ResilientLoop(prog, _cpu(), (arr,), 4)
    on_two = api.compile(_heat(shape=(8, 16), name="heat_res_shape"), _on_ranks((2,)))
    (sharded,) = on_two.shard_state((bad,))
    with pytest.raises(ValueError, match="shape"):
        ResilientLoop(prog, _cpu(), (sharded,), 4)


# -------------------------------------------------------------------------
# torn writes: truncation falls back, startup GC reclaims
# -------------------------------------------------------------------------


def test_truncated_checkpoint_is_ignored_and_gcd(tmp_path):
    prog = _heat(name="heat_res_torn")
    u0 = _rand((16, 16), 5)
    tgt = _cpu(exchange_every=2)
    steps = 16
    ref = api.compile(prog, tgt).time_loop((u0,), steps)

    d = str(tmp_path / "ckpt")
    # checkpoint every epoch; the snapshot at step 10 commits and is then
    # torn, and the process dies before epoch 5 — the freshest COMMITTED
    # snapshot is step 8
    loop = ResilientLoop(
        prog, tgt, (u0,), steps, directory=d, checkpoint_every=1,
        keep_last=8,
        fault_plan=FaultPlan(kill_at_epoch=5, truncate_step=10),
    )
    with pytest.raises(SimulatedFault):
        loop.run()
    assert not os.path.exists(os.path.join(d, "step_00000010", "COMMITTED"))

    # any fresh Checkpointer's startup GC reclaims the wreck (resume()
    # constructs one first thing, so the count is observable here)
    probe = Checkpointer(d, keep_last=8)
    assert probe.stats.gcs == 1
    assert not os.path.exists(os.path.join(d, "step_00000010"))

    resumed = resume(prog, d, tgt)
    # the torn step-10 snapshot is invisible: resume restarts from step 8
    assert resumed.step_count == 8
    final = resumed.run()
    _assert_bitwise(final, ref, "torn-checkpoint fallback resume")


def test_truncate_snapshot_helper(tmp_path):
    d = str(tmp_path / "ckpt")
    ckpt = Checkpointer(d)
    ckpt.save(4, {"u": np.arange(16.0).reshape(4, 4)}, blocking=True)
    assert ckpt.available_steps() == [4]
    truncate_snapshot(d, 4)
    assert ckpt.available_steps() == []


# -------------------------------------------------------------------------
# Checkpointer hardening: retention, GC, truthful counters, manifest
# -------------------------------------------------------------------------


def test_keep_last_retention_and_counters(tmp_path):
    d = str(tmp_path / "ckpt")
    ckpt = Checkpointer(d, keep_last=2)
    before = global_stats().as_dict()
    for s in range(5):
        ckpt.save(s, {"u": np.full((2, 2), float(s))}, blocking=True)
    assert ckpt.available_steps() == [3, 4]
    assert ckpt.stats.as_dict() == {
        "saves": 5, "prunes": 3, "gcs": 0, "restores": 0,
    }
    after = global_stats().as_dict()
    assert after["saves"] - before["saves"] == 5
    assert after["prunes"] - before["prunes"] == 3


def test_startup_gc_counts_partials(tmp_path):
    d = str(tmp_path / "ckpt")
    Checkpointer(d).save(2, {"u": np.zeros((2, 2))}, blocking=True)
    # a torn dir (no COMMITTED) and an abandoned staging dir
    os.makedirs(os.path.join(d, "step_00000009"))
    os.makedirs(os.path.join(d, "step_00000011.tmp"))
    ckpt = Checkpointer(d)
    assert ckpt.stats.gcs == 2
    assert sorted(os.listdir(d)) == ["step_00000002"]


def test_manifest_extra_roundtrip(tmp_path):
    d = str(tmp_path / "ckpt")
    ckpt = Checkpointer(d)
    extra = {"program_fingerprint": "abc", "step": 6, "rotation_phase": 1}
    ckpt.save(6, {"state": {"b0": np.ones((3, 3))}}, blocking=True,
              extra=extra)
    m = ckpt.manifest()
    assert m["step"] == 6 and m["extra"] == extra
    assert list(m["leaves"]) == ["state/b0"]
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path / "empty")).manifest()


def test_keep_last_must_be_positive(tmp_path):
    with pytest.raises(ValueError, match="keep_last"):
        Checkpointer(str(tmp_path / "c"), keep_last=0)


def test_tree_keys_are_the_references():
    """Leaf keys of nested dicts, lists and tuples: the reference's
    ``jax.tree_util`` paths (dict keys sorted, ``[i]`` for indices)."""
    from repro.checkpoint.checkpointer import _flatten as ref_flatten

    tree = {"state": {"b10": 1.0, "b2": 2.0, "b0": 3.0},
            "z": [4.0, (5.0, {"q": 6.0, "a": 7.0})], "a": None, "m": 8.0}
    assert list(_flatten(tree).items()) == list(ref_flatten(tree).items())


def test_save_copies_tensors_to_the_host_and_restores_numpy(tmp_path):
    """Tensors and sharded tensors are copied to the host before ``save``
    returns (the snapshot keeps no reference to them); restore gives
    numpy arrays in the structure of ``tree_like``."""
    x = torch.arange(32, dtype=torch.float32).reshape(4, 8)
    step = api.compile(_heat(shape=(4, 8), name="heat_res_host"), _on_ranks((2,)))
    (sharded,) = step.shard_state((x,))
    ckpt = Checkpointer(str(tmp_path / "c"))
    tree = {"a": x, "b": [sharded, np.ones(3, np.float32)]}
    ckpt.save(1, tree)  # async: the writer sees the host copies only
    x.zero_()
    for t in sharded.shards:
        t.zero_()
    ckpt.wait()
    assert set(ckpt.last_save) == {"to_host_s", "write_s"}
    like = {"a": 0, "b": [0, 0]}
    got = ckpt.restore(like)
    want = np.arange(32, dtype=np.float32).reshape(4, 8)
    assert isinstance(got["a"], np.ndarray) and isinstance(got["b"], list)
    assert np.array_equal(got["a"], want) and np.array_equal(got["b"][0], want)
    assert np.array_equal(got["b"][1], np.ones(3, np.float32))
    with pytest.raises(ValueError, match="shard_state"):
        ckpt.restore(like, shardings={"a": None})


def test_a_failed_async_write_raises_at_wait(tmp_path):
    d = tmp_path / "ckpt"
    ckpt = Checkpointer(str(d))
    ckpt.save(3, {"u": np.zeros((2, 2))}, extra={"bad": object()})  # not JSON-able
    with pytest.raises(TypeError, match="JSON serializable"):
        ckpt.wait()
    ckpt.wait()  # raised once
    assert ckpt.available_steps() == [] and ckpt.stats.saves == 0


# -------------------------------------------------------------------------
# the compiled step's ring: checkpoints copy off it and keep it
# -------------------------------------------------------------------------


@pytest.mark.parametrize("make,n_in", [(_heat, 1), (_wave, 2)])
@pytest.mark.parametrize("async_saves", [False, True])
def test_checkpoints_keep_the_ring(make, n_in, async_saves, tmp_path):
    """``Target(jit=True, donate=True)`` with the ring forced on the CPU:
    every epoch runs in the one ring it built at the first epoch, the
    snapshots hold the state of their step although the ring has since
    overwritten it, and the run is bitwise the plain route's."""
    prog = make(name=f"{make.__name__}_ring_{async_saves}")
    s0 = tuple(_rand((16, 16), 60 + i) for i in range(n_in))
    tgt = _cpu(exchange_every=2, jit=True, donate=True)
    plain = api.compile(prog, _cpu(exchange_every=2, jit=False))
    step = api.compile(prog, tgt)
    step._graphed = lambda: True
    try:
        d = str(tmp_path / "ckpt")
        loop = ResilientLoop(prog, tgt, s0, 12, directory=d, checkpoint_every=1,
                             keep_last=6, async_saves=async_saves)
        loop.run(max_epochs=1)
        ring = step._ring
        assert ring is not None
        final = loop.run()
        assert step._ring is ring  # no checkpoint made the ring look held
        assert all(x.data_ptr() in {b.data_ptr() for bs in ring.bufs for b in bs}
                   for x in final)
        _assert_bitwise(final, plain.time_loop(s0, 12), "ring run vs jit=False")
        for at in (8, 10):
            snap = Checkpointer(d).restore(
                {"state": {f"b{i}": 0 for i in range(n_in)}}, step=at)
            want = plain.time_loop(s0, at)
            _assert_bitwise(tuple(snap["state"][f"b{i}"] for i in range(n_in)), want,
                            f"snapshot at step {at}")
    finally:
        del step._graphed
        step.release_graphs()


# -------------------------------------------------------------------------
# elastic resume over ranks (tests/dist_worker.py scenario_resilience_reshape)
# -------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("family", ["heat", "wave"])
def test_resume_from_four_ranks_onto_two(family, k, tmp_path):
    shape, steps = (64, 32), 32
    prog = (_heat if family == "heat" else _wave)(shape, name=f"{family}_reshape")
    rng = np.random.default_rng(13)
    n_in = 1 if family == "heat" else 2
    s0 = tuple(rng.standard_normal(shape).astype(np.float32) for _ in range(n_in))
    ref = api.compile(prog, _cpu(exchange_every=k)).time_loop(s0, steps)
    big, small = _on_ranks((4,), exchange_every=k), _on_ranks((2,), exchange_every=k)

    full = ResilientLoop(prog, big, s0, steps, directory=str(tmp_path / "full")).run()
    assert all(isinstance(x, ShardedTensor) and x.mesh is big.mesh for x in full)
    _assert_bitwise(full, ref, f"{family} k={k} uninterrupted on 4 ranks")

    kill = (steps // k) // 2
    d = str(tmp_path / "killed")
    _kill(ResilientLoop(prog, big, s0, steps, directory=d,
                        fault_plan=FaultPlan(kill_at_epoch=kill)), kill)
    resumed = resume(prog, d, small)
    assert resumed.step_count == kill * k
    _assert_bitwise(resumed.run(), ref, f"{family} k={k} 4 -> 2 ranks")


@pytest.mark.parametrize("before,after", [(None, (2, 2)), ((2, 2), None)])
def test_resume_between_one_device_and_a_2x2_mesh(before, after, tmp_path):
    shape, steps, k = (32, 32), 16, 2
    prog = _wave(shape, name="wave_2x2_reshape")
    s0 = tuple(_rand(shape, 70 + i) for i in range(2))
    tgts = {None: _cpu(exchange_every=k)}
    tgts[(2, 2)] = _on_ranks((2, 2), exchange_every=k)
    ref = api.compile(prog, tgts[None]).time_loop(s0, steps)
    d = str(tmp_path / "ckpt")
    _kill(ResilientLoop(prog, tgts[before], s0, steps, directory=d,
                        fault_plan=FaultPlan(kill_at_epoch=3)), 3)
    resumed = resume(prog, d, tgts[after])
    assert resumed._phase == (3 * 2) % 2 and resumed.step_count == 6
    _assert_bitwise(resumed.run(), ref, f"wave {before} -> {after}")


# -------------------------------------------------------------------------
# across the packages: the same snapshot layout
# -------------------------------------------------------------------------


def _ref_pkg():
    from repro import api as rapi
    from repro import resilience as rres

    return rapi, rres


@pytest.mark.parametrize("family", ["heat", "wave"])
def test_a_reference_snapshot_resumes_in_the_port(family, tmp_path):
    rapi, rres = _ref_pkg()
    make = _heat if family == "heat" else _wave
    n_in = 1 if family == "heat" else 2
    s0 = tuple(_rand((16, 16), 80 + i) for i in range(n_in))
    rprog = make(name=f"{family}_x", pkg="repro")
    prog = make(name=f"{family}_x")
    assert rprog.fingerprint == prog.fingerprint
    steps, k = 12, 2
    want = rapi.compile(rprog, rapi.Target(exchange_every=k)).time_loop(s0, steps)
    d = str(tmp_path / "ckpt")
    with pytest.raises(rres.SimulatedFault):
        rres.ResilientLoop(rprog, rapi.Target(exchange_every=k), s0, steps, directory=d,
                           fault_plan=rres.FaultPlan(kill_at_epoch=3)).run()
    resumed = resume(prog, d, _cpu(exchange_every=k))
    assert resumed.step_count == 6
    got = resumed.run()
    for g, w in zip(got, want):
        torch.testing.assert_close(torch.from_numpy(_host(g)), torch.from_numpy(np.array(w)), **TOL)


@pytest.mark.parametrize("family", ["heat", "wave"])
def test_a_port_snapshot_resumes_in_the_reference(family, tmp_path):
    rapi, rres = _ref_pkg()
    make = _heat if family == "heat" else _wave
    n_in = 1 if family == "heat" else 2
    s0 = tuple(_rand((16, 16), 90 + i) for i in range(n_in))
    rprog = make(name=f"{family}_y", pkg="repro")
    prog = make(name=f"{family}_y")
    steps = 12
    want = rapi.compile(rprog, rapi.Target()).time_loop(s0, steps)
    d = str(tmp_path / "ckpt")
    _kill(ResilientLoop(prog, _on_ranks((2,), exchange_every=2), s0, steps, directory=d,
                        fault_plan=FaultPlan(kill_at_epoch=3)), 3)
    resumed = rres.resume(rprog, d, rapi.Target())
    assert resumed.step_count == 6
    got = resumed.run()
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), **TOL)


def test_both_packages_write_the_same_snapshot_layout(tmp_path):
    rapi, rres = _ref_pkg()
    s0 = tuple(_rand((16, 16), 100 + i) for i in range(2))
    rprog, prog = _wave(name="wave_layout", pkg="repro"), _wave(name="wave_layout")
    dirs = {}
    for pkg in ("repro", "repro_torch"):
        d = dirs[pkg] = str(tmp_path / pkg)
        if pkg == "repro":
            rres.ResilientLoop(rprog, rapi.Target(exchange_every=2), s0, 8, directory=d).run()
        else:
            ResilientLoop(prog, _cpu(exchange_every=2), s0, 8, directory=d).run()
    assert sorted(os.listdir(dirs["repro"])) == sorted(os.listdir(dirs["repro_torch"]))
    for step in sorted(os.listdir(dirs["repro"])):
        files = [sorted(os.listdir(os.path.join(dirs[p], step))) for p in dirs]
        assert files[0] == files[1] == ["COMMITTED", "manifest.json", "state__b0.npy",
                                        "state__b1.npy"]
        ref_m, port_m = (json.load(open(os.path.join(dirs[p], step, "manifest.json")))
                         for p in dirs)
        assert list(ref_m) == list(port_m) == ["step", "leaves", "extra"]
        assert ref_m["leaves"] == port_m["leaves"]
        assert list(ref_m["extra"]) == list(port_m["extra"])
        same = {k: v for k, v in ref_m["extra"].items() if k != "target_fingerprint"}
        assert same == {k: v for k, v in port_m["extra"].items() if k != "target_fingerprint"}


# -------------------------------------------------------------------------
# tune transfer: cross-hardware warm start
# -------------------------------------------------------------------------


def _tune_kwargs():
    return dict(
        devices=[CPU], measure=False, backends=("torch",), exchange_every=(1, 2),
        overlap=(False,), fused_epoch=(False,),
    )


def test_tune_transfer_adopts_foreign_entry(tmp_path, monkeypatch):
    from repro_torch.tune import cache as tc
    from repro_torch.tune import cache_stats, reset_cache_stats, tune

    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "tc"))
    prog = _heat(name="heat_res_xfer")
    res = tune(prog, ranks=1, **_tune_kwargs())
    assert not res.from_cache

    # re-home the stored entry under a fake foreign hardware signature
    # (the mesh=None winner is device-independent, so it rebuilds here)
    entry = tc.load(res.cache_key)
    donor = dict(entry)
    donor["hardware"] = "gpu:NVIDIA H100 80GB HBM3:n8"
    donor["n_ranks"] = 8
    tc.store(
        tc.cache_key(prog.fingerprint, donor["hardware"], 8, donor["options"]),
        donor,
    )
    os.unlink(tc.entry_path(res.cache_key))

    reset_cache_stats()
    moved = tune(prog, ranks=1, transfer=True, **_tune_kwargs())
    stats = cache_stats().as_dict()
    assert moved.from_cache and moved.winner.origin == "transfer"
    assert stats["transfer_hits"] == 1 and stats["hits"] == 0
    # a transfer is a warm start, not a local fact: nothing re-stored
    assert stats["stores"] == 0
    assert moved.target.fingerprint == entry["winner"]["fingerprint"]

    # transfer=False (the default): the very same miss searches fresh
    reset_cache_stats()
    fresh = tune(prog, ranks=1, **_tune_kwargs())
    stats = cache_stats().as_dict()
    assert not fresh.from_cache
    assert stats["transfer_hits"] == 0 and stats["stores"] == 1


def test_tune_transfer_ignores_mismatched_entries(tmp_path, monkeypatch):
    """Different options digest or different program never transfers;
    an empty cache dir is a plain None."""
    from repro_torch.tune import cache as tc
    from repro_torch.tune import cache_stats, reset_cache_stats, tune

    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "tc"))
    prog = _heat(name="heat_res_noxfer")
    reset_cache_stats()
    assert tc.lookup_transfer(prog, 1, "deadbeef", devices=[CPU]) is None

    res = tune(prog, ranks=1, **_tune_kwargs())
    entry = tc.load(res.cache_key)
    donor = dict(entry)
    donor["hardware"] = "gpu:NVIDIA H100 80GB HBM3:n8"
    tc.store(tc.cache_key(prog.fingerprint, donor["hardware"], 8,
                          donor["options"]), donor)
    os.unlink(tc.entry_path(res.cache_key))

    # wrong options digest -> no transfer
    assert tc.lookup_transfer(prog, 1, "0000aaaa0000", devices=[CPU]) is None
    # wrong program -> no transfer
    other = _heat(alpha=0.2, name="heat_res_noxfer2")
    assert tc.lookup_transfer(other, 1, donor["options"], devices=[CPU]) is None
    assert cache_stats().transfer_hits == 0
    # the right program and options -> the donor, counted as a transfer
    got = tc.lookup_transfer(prog, 1, donor["options"], devices=[CPU])
    assert got is not None and got[1].fingerprint == entry["winner"]["fingerprint"]
    assert cache_stats().transfer_hits == 1


# -------------------------------------------------------------------------
# api surface
# -------------------------------------------------------------------------


def test_api_entry_points(tmp_path):
    import repro_torch

    prog = _heat(name="heat_res_api")
    u0 = _rand((16, 16), 40)
    ref = api.compile(prog, _cpu()).time_loop((u0,), 4)
    d = str(tmp_path / "ckpt")
    loop = repro_torch.resilient_loop(prog, _cpu(), (u0,), 4, directory=d)
    final = loop.run()
    _assert_bitwise(final, ref, "repro_torch.resilient_loop")
    resumed = repro_torch.resume(prog, d, _cpu())
    assert resumed.done  # final snapshot is at n_steps
    assert repro_torch.resilience.ResilientLoop is ResilientLoop
    compiled = api.compile(prog, _cpu())
    assert compiled.epochs(8) == 8
    assert isinstance(compiled.ret_indices, tuple)
    with pytest.raises(ValueError, match="exchange_every"):
        api.compile(prog, _cpu(exchange_every=4)).epochs(6)
    # without a target both entry points compile for the card
    if has_cuda():
        assert repro_torch.resume(prog, d).target.device.startswith("cuda")
    else:
        with pytest.raises(TargetError, match="CUDA"):
            repro_torch.resume(prog, d)
        with pytest.raises(TargetError, match="CUDA"):
            repro_torch.resilient_loop(prog, None, (u0,), 4)


def test_signatures_are_the_references():
    import inspect

    rapi, rres = _ref_pkg()
    from repro.checkpoint.checkpointer import Checkpointer as RefCheckpointer

    import repro_torch

    pairs = [
        (rres.ResilientLoop.__init__, ResilientLoop.__init__),
        (rres.resume, resume),
        (rres.FaultPlan, FaultPlan),
        (rres.truncate_snapshot, truncate_snapshot),
        (rapi.resilient_loop, repro_torch.resilient_loop),
        (rapi.resume, repro_torch.resume),
    ] + [(getattr(RefCheckpointer, n), getattr(Checkpointer, n))
         for n in ("__init__", "save", "wait", "available_steps", "latest_step",
                   "manifest", "restore")]
    import repro.obs as robs
    import repro_torch.obs as pobs

    pairs += [(getattr(robs, n), getattr(pobs, n))
              for n in ("drift_report", "to_chrome", "write_chrome", "write_jsonl",
                        "write_rank_traces", "merge_traces", "load_spans")]
    for ref_fn, port_fn in pairs:
        ref_sig, port_sig = inspect.signature(ref_fn), inspect.signature(port_fn)
        assert list(ref_sig.parameters) == list(port_sig.parameters), port_fn
        assert [p.default for p in ref_sig.parameters.values()] == [
            p.default for p in port_sig.parameters.values()], port_fn


def test_resilience_imports_no_jax():
    probe = (
        "import sys, repro_torch.resilience, repro_torch.checkpoint, repro_torch.obs\n"
        "import repro_torch\n"
        "repro_torch.resilient_loop, repro_torch.resume\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib'))"
        " or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


# -------------------------------------------------------------------------
# serve migration: evacuate -> admit across engines
# -------------------------------------------------------------------------


def test_engine_evacuate_admit_is_bitwise(tmp_path):
    from repro_torch.serve.stencil import StencilEngine, StencilEngineConfig
    from repro_torch.serve.stencil.request import EVACUATED

    prog = _heat(name="heat_res_migrate")
    tgt = _cpu(exchange_every=2)
    states = [_rand((16, 16), 20 + i) for i in range(3)]
    refs = [api.compile(prog, tgt).time_loop((s,), 12) for s in states]

    first = StencilEngine(StencilEngineConfig(slots_per_group=2))
    for s in states:
        first.submit(prog, (s,), 12, target=tgt)
    for _ in range(2):  # two slots advance to step 4; one stays queued
        first.step()
    d = str(tmp_path / "evac")
    evacuated = first.evacuate(prog.fingerprint, d)
    assert [r.steps_done for r in evacuated] == [4, 4, 0]
    assert all(r.status == EVACUATED for r in evacuated)
    assert first.pending == 0
    assert first.metrics.requests_evacuated == 3
    assert first.metrics.snapshot()["requests_evacuated"] == 3

    second = StencilEngine(StencilEngineConfig(slots_per_group=2))
    handles = second.admit_evacuated(d, prog)
    assert [h.steps_done for h in handles] == [4, 4, 0]
    second.run()
    assert second.metrics.requests_resumed == 3
    assert second.metrics.snapshot()["requests_resumed"] == 3
    for h, ref in zip(handles, refs):
        _assert_bitwise(h.result(), ref, f"migrated request {h.rid}")


def test_admit_requires_matching_program(tmp_path):
    from repro_torch.serve.stencil import StencilEngine

    prog = _heat(name="heat_res_mig_owner")
    other = _heat(alpha=0.2, name="heat_res_mig_other")
    first = StencilEngine()
    first.submit(prog, (_rand((16, 16), 30),), 4, target=_cpu())
    d = str(tmp_path / "evac")
    first.evacuate(prog.fingerprint, d)
    with pytest.raises(ResumeError, match="no matching Program"):
        StencilEngine().admit_evacuated(d, other)
    with pytest.raises(ResumeError, match="no evacuated requests"):
        StencilEngine().admit_evacuated(str(tmp_path / "nothing_here"), prog)


def test_submit_start_step_is_validated():
    from repro_torch.serve.stencil import StencilEngine

    prog = _heat(name="heat_res_startstep")
    engine = StencilEngine()
    with pytest.raises(ValueError, match="start_step"):
        engine.submit(prog, (_rand((16, 16), 31),), 8,
                      target=_cpu(exchange_every=2), start_step=3)
    with pytest.raises(ValueError, match="start_step"):
        engine.submit(prog, (_rand((16, 16), 31),), 8, target=_cpu(), start_step=8)


@pytest.mark.parametrize("family", ["heat", "wave"])
def test_a_request_the_reference_evacuates_the_port_admits(family, tmp_path):
    """The reference's engine (JAX on the CPU) runs a request 4 steps and
    evacuates it; the port's engine admits it mid-run and finishes it
    within rtol=atol=1e-5 of the reference's solo run (the reference's
    serialized target names its backend ``jnp``, so the receiving engine
    gives its own target, as a migration across hardware does)."""
    from repro.serve.stencil import StencilEngine as RefEngine
    from repro_torch.serve.stencil import StencilEngine

    rapi, _ = _ref_pkg()
    make = _heat if family == "heat" else _wave
    n_in = 1 if family == "heat" else 2
    s0 = tuple(_rand((16, 16), 110 + i) for i in range(n_in))
    rprog, prog = make(name=f"{family}_mig_in", pkg="repro"), make(name=f"{family}_mig_in")
    want = rapi.compile(rprog, rapi.Target(exchange_every=2)).time_loop(s0, 12)
    ref_eng = RefEngine()
    ref_eng.submit(rprog, s0, 12, target=rapi.Target(exchange_every=2))
    for _ in range(2):
        ref_eng.step()
    d = str(tmp_path / "evac")
    assert [r.steps_done for r in ref_eng.evacuate(rprog.fingerprint, d)] == [4]
    eng = StencilEngine()
    (h,) = eng.admit_evacuated(d, prog, target=_cpu(exchange_every=2))
    assert h.steps_done == 4
    eng.run()
    for g, w in zip(h.result(), want):
        np.testing.assert_allclose(_host(g), np.asarray(w), **TOL)


@pytest.mark.parametrize("family", ["heat", "wave"])
def test_a_request_the_port_evacuates_the_reference_admits(family, tmp_path):
    """The reverse hop: the port's engine (over two CPU ranks, so the
    pooled slot-axis dispatch runs) evacuates mid-run, the reference's
    engine admits and finishes within rtol=atol=1e-5 of its solo run."""
    from repro.serve.stencil import StencilEngine as RefEngine
    from repro_torch.serve.stencil import StencilEngine, StencilEngineConfig

    rapi, _ = _ref_pkg()
    make = _heat if family == "heat" else _wave
    n_in = 1 if family == "heat" else 2
    s0 = tuple(_rand((16, 16), 120 + i) for i in range(n_in))
    rprog, prog = make(name=f"{family}_mig_out", pkg="repro"), make(name=f"{family}_mig_out")
    want = rapi.compile(rprog, rapi.Target()).time_loop(s0, 12)
    eng = StencilEngine(StencilEngineConfig(slots_per_group=2))
    eng.submit(prog, s0, 12, target=_on_ranks((2,), exchange_every=2))
    eng.submit(prog, s0, 12, target=_on_ranks((2,), exchange_every=2))
    for _ in range(3):
        eng.step()
    d = str(tmp_path / "evac")
    assert [r.steps_done for r in eng.evacuate(prog.fingerprint, d)] == [6, 6]
    ref_eng = RefEngine()
    handles = ref_eng.admit_evacuated(d, rprog, target=rapi.Target(exchange_every=2))
    assert [h.steps_done for h in handles] == [6, 6]
    ref_eng.run()
    for h in handles:
        for g, w in zip(h.result(), want):
            np.testing.assert_allclose(np.asarray(g), np.asarray(w), **TOL)


def test_serving_signatures_are_the_references():
    """The serving engine, its migration and the API and tune pieces it
    calls take the reference's parameters, in order, with its defaults
    (the port's backends are ``torch``/``cuda``)."""
    import dataclasses
    import inspect

    import repro.api as rapi_mod
    import repro.dist.sharding as rsharding
    import repro.obs as robs
    import repro.resilience.migrate as rmigrate
    import repro.serve.stencil as rserve
    import repro.tune.space as rspace

    import repro_torch.dist.sharding as psharding
    import repro_torch.obs as pobs
    import repro_torch.resilience as pres
    import repro_torch.serve.stencil as pserve
    import repro_torch.tune.space as pspace

    pairs = [(getattr(rserve.StencilEngine, n), getattr(pserve.StencilEngine, n))
             for n in ("__init__", "submit", "step", "run", "evacuate", "admit_evacuated",
                       "resize_bucket")]
    pairs += [(getattr(rserve, n), getattr(pserve, n))
              for n in ("Scheduler", "SlotPool", "PoolSizer", "PoolSizerConfig",
                        "StepMetrics", "EngineMetrics", "RequestHandle", "Frame",
                        "StencilRequest")]
    pairs += [(getattr(rserve.Scheduler, n), getattr(pserve.Scheduler, n))
              for n in ("group_for", "enqueue", "admit", "reclaim", "retire_idle")]
    pairs += [(getattr(rserve.SlotPool, n), getattr(pserve.SlotPool, n))
              for n in ("write_slot", "read_slot", "commit_rows", "rebuild", "release")]
    pairs += [(getattr(rapi_mod, n), getattr(api, n))
              for n in ("pooled_target", "lower_ir", "cached_callable", "cache_capacity",
                        "set_cache_capacity")]
    pairs += [(rsharding.factor_slot_mesh, psharding.factor_slot_mesh),
              (rspace.slot_width_candidates, pspace.slot_width_candidates),
              (rmigrate.evacuate, pres.evacuate), (rmigrate.admit, pres.admit),
              (robs.snapshot, pobs.snapshot)]
    for ref_fn, port_fn in pairs:
        ref_sig, port_sig = inspect.signature(ref_fn), inspect.signature(port_fn)
        assert list(ref_sig.parameters) == list(port_sig.parameters), port_fn
        assert [p.default for p in ref_sig.parameters.values()] == [
            p.default for p in port_sig.parameters.values()], port_fn
    ref_pool = inspect.signature(rspace.enumerate_pool_candidates).parameters
    port_pool = inspect.signature(pspace.enumerate_pool_candidates).parameters
    assert list(ref_pool) == list(port_pool) and port_pool["backends"].default == ("torch",)
    ref_cfg = [f.name for f in dataclasses.fields(rserve.StencilEngineConfig)]
    port_cfg = [f.name for f in dataclasses.fields(pserve.StencilEngineConfig)]
    assert port_cfg == ref_cfg
    assert robs.NAMESPACES == pobs.NAMESPACES
