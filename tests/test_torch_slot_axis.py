"""Slot-axis targets and pooled distributed buckets, on CPU ranks in
process.

The port of ``tests/dist_worker.py``'s ``slot-axis``, ``serve-pooled`` and
``serve-autoscale`` scenarios.  A ``Target(slot_axis=...)`` (from
``api.pooled_target``) runs one call over ``(slot, *spatial)`` ranks on
``[B, *shape]`` tensors; each of its slots is bitwise the spatial-only
target's solo run, at slot widths 1, 2 and 4, with and without overlap
and deep-halo epochs, on the torch and cuda (plain-version) backends.  A
distributed serving bucket with several live slots dispatches once per
engine step (batched > 0, solo == 0), and autoscaling across resizes
stays bitwise.  The reference's solo run (JAX on the CPU, one device)
holds the port's pooled slots within rtol=atol=1e-5.
"""
import importlib

import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.api import Target, TargetError, pooled_target
from repro_torch.core.passes.decompose import make_strategy_1d, make_strategy_2d
from repro_torch.dist import Mesh, ShardedTensor, factor_slot_mesh, gather, read_row, write_row

CPU = torch.device("cpu")
TOL = dict(rtol=1e-5, atol=1e-5)


def _mesh(shape, names):
    n = int(np.prod(shape))
    return Mesh(np.array([CPU] * n, dtype=object).reshape(shape), names)


def _jacobi(shape, boundary, pkg="repro_torch"):
    p = importlib.import_module(f"{pkg}.frontends.oec_like").ProgramBuilder("jacobi", shape)
    u = p.input("u")
    out = p.output("out")
    t = p.load(u)
    r = p.apply(
        [t],
        lambda b, u: (u.at(-1, 0) + u.at(1, 0) + u.at(0, -1) + u.at(0, 1)) * 0.25,
    )
    p.store(r, out)
    return p.finish(boundary=boundary)


def _first(x):
    return x[0] if isinstance(x, tuple) else x


SLOT_CASES = [
    # (boundary, k, slots, extra Target knobs, spatial mesh)
    ("zero", 1, 4, {}, (2,)),
    ("periodic", 2, 2, {}, (2,)),
    ("periodic", 1, 1, {}, (2,)),
    ("zero", 1, 2, {"overlap": True}, (2,)),
    ("zero", 2, 2, {"backend": "cuda"}, (2, 2)),
    ("periodic", 4, 4, {"backend": "cuda", "fused_epoch": True}, (2,)),
]


@pytest.mark.parametrize("boundary,k,slots,kw,spatial", SLOT_CASES,
                         ids=[f"{b}-k{k}-s{s}-{'-'.join(kw) or 'torch'}-{'x'.join(map(str, m))}"
                              for b, k, s, kw, m in SLOT_CASES])
def test_slot_axis_pool_is_bitwise_per_slot_solo(boundary, k, slots, kw, spatial):
    """A slot-axis pooled target advances a ``[B, *shape]`` batch bitwise
    as ``B`` solo runs of its spatial-only sibling, at slot widths that do
    (4) and do not (2, 1 with B=4) equal the batch."""
    shape = (32, 32)
    B = 4
    prog = _jacobi(shape, boundary)
    names = ("x", "y")[: len(spatial)]
    strategy = make_strategy_1d(2) if len(spatial) == 1 else make_strategy_2d(spatial)
    solo_t = Target(mesh=_mesh(spatial, names), strategy=strategy, exchange_every=k, **kw)
    pooled_t = pooled_target(solo_t, slots=slots, devices=[CPU] * 8)
    assert pooled_t.fingerprint != solo_t.fingerprint
    assert pooled_t.mesh.shape["slot"] == slots and pooled_t.distributed
    assert pooled_t.spatial_ranks == solo_t.spatial_ranks
    solo = api.compile(prog, solo_t)
    pooled = api.compile(prog, pooled_t)
    assert pooled._n_ranks == solo._n_ranks
    rng = np.random.default_rng(7)
    u = rng.standard_normal((B,) + shape).astype(np.float32)
    got = _first(pooled.time_loop((u,), 8))
    assert tuple(got.shape) == (B,) + shape
    for i in range(B):
        assert torch.equal(got[i], _first(solo.time_loop((u[i],), 8))), i
    # the reference's solo run on one device, within the tolerance
    from repro import api as rapi

    ref = rapi.compile(_jacobi(shape, boundary, pkg="repro"), rapi.Target(exchange_every=k))
    want = np.asarray(_first(ref.time_loop((u[0],), 8)))
    np.testing.assert_allclose(got[0].numpy(), want, **TOL)


def test_slot_axis_state_stays_sharded_and_rows_read_back():
    """``advance`` keeps a slot-axis pool sharded over ``(slot, *spatial)``;
    ``read_row``/``write_row`` reach one slot's row across its ranks."""
    prog = _jacobi((16, 16), "periodic")
    t = pooled_target(Target(mesh=_mesh((2,), ("x",)), strategy=make_strategy_1d(2)), slots=2,
                      devices=[CPU] * 4)
    step = api.compile(prog, t)
    u = torch.from_numpy(np.random.default_rng(1).standard_normal((4, 16, 16)).astype(np.float32))
    (s,) = step.advance((u,))
    assert isinstance(s, ShardedTensor) and tuple(s.shards[0].shape) == (2, 8, 16)
    full = gather(s)
    for i in range(4):
        assert torch.equal(read_row(s, i), full[i])
    write_row(s, 3, u[0])
    assert torch.equal(read_row(s, 3), u[0]) and torch.equal(read_row(s, 2), full[2])


def test_pooled_target_validation():
    spatial = Target(mesh=_mesh((2,), ("x",)), strategy=make_strategy_1d(2))
    # a slot axis colliding with a spatial axis is rejected
    with pytest.raises(TargetError, match="spatial decomposition axis"):
        Target(mesh=_mesh((2,), ("x",)), strategy=make_strategy_1d(2), slot_axis="x")
    with pytest.raises(TargetError, match="collides"):
        pooled_target(spatial, axis="x")
    with pytest.raises(TargetError, match="needs a mesh"):
        Target(device="cpu", slot_axis="slot")
    with pytest.raises(TargetError, match="not in mesh axes"):
        Target(mesh=_mesh((2,), ("x",)), strategy=make_strategy_1d(2), slot_axis="slot")
    with pytest.raises(TargetError, match="distributed target"):
        pooled_target(Target(device="cpu"))
    with pytest.raises(TargetError, match="already carries"):
        pooled_target(pooled_target(spatial))
    with pytest.raises(TargetError, match="needs 8 devices, have 4"):
        pooled_target(spatial, slots=4, devices=[CPU] * 4)
    with pytest.raises(ValueError, match="positive integer"):
        factor_slot_mesh(spatial.mesh, 0)
    # width 1 reuses the spatial mesh's devices; wider ones take a prefix
    one = pooled_target(spatial)
    assert one.mesh.shape == {"slot": 1, "x": 2}
    assert pooled_target(spatial, slots=2, devices=[CPU] * 4).mesh.size == 4
    # a slot-axis artifact takes slot pools only, and a mesh without a slot
    # axis takes none
    prog = _jacobi((16, 16), "zero")
    with pytest.raises(ValueError, match="slot pools"):
        api.compile(prog, one).time_loop((np.zeros((16, 16), np.float32),), 1)
    with pytest.raises(ValueError, match="needs a slot-axis target"):
        api.compile(prog, spatial).time_loop((np.zeros((2, 16, 16), np.float32),), 1)


def _engine(**kw):
    from repro_torch.serve.stencil import StencilEngine, StencilEngineConfig

    return StencilEngine(StencilEngineConfig(**kw))


@pytest.mark.parametrize("devices", [None, 8], ids=["width-1", "width-4"])
def test_serve_pooled_distributed_bucket_dispatches_once_per_step(devices, monkeypatch):
    """A 2-rank distributed bucket with 4 live slots runs as ONE pooled
    dispatch per engine step (per-bucket counters: batched > 0, solo ==
    0); every request's final state is bitwise its solo ``time_loop``.  On
    the target mesh's own devices the slot axis has width 1; on an
    inventory of 8 it has width 4."""
    from repro_torch.serve.stencil import StencilEngine

    shape = (32, 32)
    prog = _jacobi(shape, "periodic")
    target = Target(mesh=_mesh((2,), ("x",)), strategy=make_strategy_1d(2))
    rng = np.random.default_rng(3)
    states = [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]
    if devices is not None:
        monkeypatch.setattr(StencilEngine, "_inventory", lambda self, t: [CPU] * devices)
    eng = _engine(slots_per_group=4)
    hs = [eng.submit(prog, (s,), 8, target=target) for s in states]
    done = eng.run()
    assert len(done) == 4
    bd = eng.metrics.bucket_dispatches[f"{prog.fingerprint}/{target.fingerprint}"]
    assert bd == {"batched": 8, "solo": 0}, bd
    (group,) = eng.scheduler.groups.values()
    width = group.pooled[1].target.mesh.shape["slot"]
    assert width == (1 if devices is None else 4)
    solo = api.compile(prog, target)
    for h, s in zip(hs, states):
        assert torch.equal(h.result()[0], _first(solo.time_loop((s,), 8)))


def test_serve_pooled_falls_back_to_solo_only_without_a_slot_axis(monkeypatch):
    """Where the inventory cannot hold the slot axis (``TargetError`` from
    ``pooled_target``) the bucket runs the solo loop, and stays bitwise."""
    shape = (32, 32)
    prog = _jacobi(shape, "periodic")
    target = Target(mesh=_mesh((2,), ("x",)), strategy=make_strategy_1d(2))

    def no_room(*a, **k):
        raise TargetError("no room for a slot axis")

    monkeypatch.setattr(api, "pooled_target", no_room)
    rng = np.random.default_rng(4)
    states = [rng.standard_normal(shape).astype(np.float32) for _ in range(2)]
    eng = _engine(slots_per_group=2)
    hs = [eng.submit(prog, (s,), 4, target=target) for s in states]
    eng.run()
    bd = eng.metrics.bucket_dispatches[f"{prog.fingerprint}/{target.fingerprint}"]
    assert bd == {"batched": 0, "solo": 8}, bd
    solo = api.compile(prog, target)
    for h, s in zip(hs, states):
        assert torch.equal(h.result()[0], _first(solo.time_loop((s,), 4)))


def test_serve_autoscale_distributed_bucket_stays_bitwise():
    """A queue burst against a small distributed bucket forces at least
    one grow, the long tail at least one shrink, every event carries its
    queue-depth/utilization provenance, and every request's final state
    stays bitwise its solo run across the resizes."""
    from repro_torch.serve.stencil import PoolSizerConfig

    shape = (32, 32)
    prog = _jacobi(shape, "periodic")
    target = Target(mesh=_mesh((2,), ("x",)), strategy=make_strategy_1d(2))
    rng = np.random.default_rng(5)
    states = [rng.standard_normal(shape).astype(np.float32) for _ in range(8)]
    steps = [8] * 7 + [48]
    eng = _engine(
        slots_per_group=2,
        autoscale=PoolSizerConfig(min_capacity=1, max_capacity=8, cooldown_steps=1,
                                  ewma_alpha=1.0),
    )
    hs = [eng.submit(prog, (s,), n, target=target) for s, n in zip(states, steps)]
    eng.run()
    auto = eng.metrics.snapshot()["autoscale"]
    assert auto["grows"] >= 1 and auto["shrinks"] >= 1, auto
    for e in auto["events"]:
        missing = {"queue_ewma", "utilization_ewma", "queue_depth", "live",
                   "from_capacity", "to_capacity"} - set(e)
        assert not missing, f"provenance missing {missing}"
    solo = api.compile(prog, target)
    for h, s, n in zip(hs, states, steps):
        assert torch.equal(h.result()[0], _first(solo.time_loop((s,), n)))
