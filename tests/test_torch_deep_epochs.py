"""Deep 3-D fused epochs: K2's streaming and scratch plans, planned and
run on the CPU.

A 3-D epoch's default plan is the least costly of the tiles whose
buffers fit shared memory and the streaming plans (a minor tile, the
core walked plane by plane through rings of shared memory) that fit 227
KB; where neither fits (heat so4 k=8 needs 241,328 B even for a tile of
one point, heat and wave so8 k=8 have no streaming plan either), K2
keeps buffers in device memory, its CTAs looping over the tiles
(``kernels/epoch_kernel.py``).  Here:

- every 3-D heat and wave fused epoch with so ∈ {2, 4, 8} and k ∈ {1, 2,
  4, 8} at 1024³ gets a plan (host code only): a streaming plan whose
  rings fit 227 KB, except heat and wave so8 k=8 (no stream fits) and
  wave so8 k=4 (its stream ran slower on the card), whose scratch plans
  stay under ``SCRATCH_CAP``;
- the plans that fit shared memory are what they were: the tiles and the
  generated sources (named by a hash of their lines) of chip_smoke's
  phase-6 cases;
- heat so4 k=8 and wave so8 k=4 at small grids, on one device and over a
  2×2×1 mesh of CPU ranks: the fused route bitwise equal to the unfused
  one and within 1e-5 of the reference's fused Pallas target in interpret
  mode (XLA may fuse a*b+c; eager torch rounds each op);
- the tuner's 3-D space holds fused k=8 candidates (K2's own plan only),
  and offers a streaming epoch's own plan (``None``) first.

Tensors lie on the CPU, so the K2 wrapper runs its plain version; the
generated streaming and scratch sources run on the host in
``tests/test_torch_host_kernels.py`` and on the card in ``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch

import _torch_programs as P
from repro_torch import api
from repro_torch.api import Target
from repro_torch.core.passes.decompose import make_strategy_3d
from repro_torch.dist import Mesh
from repro_torch.interop import state_from_numpy
from repro_torch.kernels import epoch_kernel as k2
from repro_torch.kernels import graphs
from repro_torch.tune.space import enumerate_candidates, tile_candidates

TOL = dict(rtol=1e-5, atol=1e-5)
CPU = torch.device("cpu")
MESH_2X2X1 = Mesh(np.array([CPU] * 4, dtype=object).reshape(2, 2, 1), ("x", "y", "z"))


def _fused(k, **kw):
    return Target(backend="cuda", exchange_every=k, fused_epoch=True, device="cpu", **kw)


def _epoch(prog, k, tile=None):
    (op,) = api.compile(prog, _fused(k, tile=tile)).kernel_epochs()
    return op


@pytest.mark.parametrize("k", [1, 2, 4, 8])
@pytest.mark.parametrize("so", [2, 4, 8])
@pytest.mark.parametrize("kind", ["heat", "wave"])
def test_every_3d_fused_epoch_at_1024_cubed_gets_a_plan(kind, so, k):
    """K2 plans every fig-7 3-D epoch at the paper's size.  Every one but
    heat and wave so8 k=8 has a streaming plan whose rings fit the 227 KB
    a CTA may use, and all but those two and wave so8 k=4 take it (among
    them heat so4 k=8 and wave so4 k=8, which no tile of shared memory
    holds, and heat so8 k=4, whose tiles shrink to 2×2×2).  Heat and wave
    so8 k=8 keep buffers in device memory, their scratch sized for one or
    two CTAs an SM, within the cap; so does wave so8 k=4, whose stream
    ran slower on the card than its scratch plan (a one-CTA-an-SM stream's
    cost weighs ``STREAM_WEIGHT`` times a scratch plan's)."""
    op = _epoch(getattr(P, kind)("repro_torch", (1024,) * 3, so), k)
    plan = k2.plan_epoch(op)
    st = k2._storage(op, plan)
    assert all(n % t == 0 for n, t in zip(plan.core.shape, plan.tile))
    assert st.smem_bytes <= k2.SMEM_PER_BLOCK
    no_stream = (kind, so, k) in {("heat", 8, 8), ("wave", 8, 8)}
    scratch = no_stream or (kind, so, k) == ("wave", 8, 4)
    assert bool(plan.ctas) == scratch and plan.stream == (not scratch)
    if scratch:
        assert plan.ctas in (k2.SMS, 2 * k2.SMS) and st.scratch_floats > 0
        assert 0 < k2.scratch_bytes(op, plan) <= k2.SCRATCH_CAP
        with pytest.raises(ValueError, match="shared memory"):
            k2.plan_epoch(op, (1, 1, 1))  # not even one point fits on chip
    if no_stream:
        with pytest.raises(ValueError, match="no streaming plan"):
            k2.plan_epoch(op, stream=True)
    elif scratch:
        stream = k2.plan_epoch(op, stream=True)
        assert stream.stream and k2._storage(op, stream).smem_bytes <= k2.SMEM_PER_BLOCK
        assert k2.STREAM_WEIGHT * k2.tile_cost(op, stream) > k2.tile_cost(op, plan)
    else:
        assert k2.scratch_bytes(op, plan) == 0 and st.depth and plan.n_tiles >= k2.MIN_CTAS
    src = k2.emit_epoch_cuda(op)
    assert ("K1_SCRATCH_TILE" in src) == scratch and ("streaming plan" in src) == plan.stream


# chip_smoke's phase-6 epochs (its stencil.index chain is the tests'
# index_chain here): the tile and the generated source's kernel name (a
# hash of its lines) that K2 gave each before scratch plans existed
PHASE6 = {
    "heat2d-so2-zero-k4": ((64, 128), "k2_epoch_bf8fbdefcc364350"),
    "heat2d-so2-periodic-k4": ((64, 128), "k2_epoch_e76601ef92018856"),
    "heat2d-so4-zero-k4": ((64, 128), "k2_epoch_571a4fbd036ff9f8"),
    "heat2d-so4-periodic-k4": ((64, 128), "k2_epoch_68fab6507586a723"),
    "heat2d-so8-zero-k4": ((64, 128), "k2_epoch_d81aa2e70e2c4714"),
    "heat2d-so8-periodic-k4": ((64, 128), "k2_epoch_295c341faf1b4494"),
    "wave2d-so4-k4": ((32, 128), "k2_epoch_2595177f441ccb2b"),
    "heat3d-so4-128-k2": ((16, 16, 16), "k2_epoch_f44e012188bcf828"),
    "index-chain-2000x1536-k1": ((80, 128), "k2_epoch_4890cc1e3be596f6"),
    "heat2d-so4-zero-k4-tile": ((32, 128), "k2_epoch_db83eb2d0949025e"),
    "heat3d-so4-128-k2-tile": ((8, 8, 32), "k2_epoch_5d0facdc95fd3d1d"),
}


def _phase6(name):
    n2 = (16384, 16384)
    if name.startswith("heat2d-so") and not name.endswith("tile"):
        so, bc = int(name.split("-")[1][2:]), name.split("-")[2]
        return P.heat("repro_torch", n2, so, bc), 4, None
    return {
        "wave2d-so4-k4": (P.wave("repro_torch", n2, 4), 4, None),
        "heat3d-so4-128-k2": (P.heat("repro_torch", (128,) * 3, 4), 2, None),
        "index-chain-2000x1536-k1": (P.index_chain("repro_torch", (2000, 1536)), 1, None),
        "heat2d-so4-zero-k4-tile": (P.heat("repro_torch", n2, 4), 4, (32, 128)),
        "heat3d-so4-128-k2-tile": (P.heat("repro_torch", (128,) * 3, 4), 2, (8, 8, 32)),
    }[name]


@pytest.mark.parametrize("name", sorted(PHASE6))
def test_plans_in_shared_memory_are_unchanged(name):
    prog, k, tile = _phase6(name)
    op = _epoch(prog, k)
    plan = k2.plan_epoch(op, tile)
    want_tile, want_name = PHASE6[name]
    assert plan.tile == want_tile and plan.ctas == 0
    assert graphs.kernel_name(k2.emit_epoch_cuda(op, tile)) == want_name


def _reference():
    from repro import api as rapi

    return rapi


# (program of a package and shape, k, epochs, single-device shape, 2×2×1
# global shape): a rank's shard of the 2×2×1 grid must be as deep as the
# epoch's halo (16); wave runs two epochs, so that its two buffers rotate
# between them
DEEP = {
    "heat-so4-k8": (lambda pkg, shape: P.heat(pkg, shape, 4), 8, 1, (24, 20, 16), (32, 32, 16)),
    "wave-so8-k4": (lambda pkg, shape: P.wave(pkg, shape, 8), 4, 2, (20, 16, 18), (32, 32, 16)),
}


@pytest.mark.parametrize("where", ["one-device", "2x2x1"])
@pytest.mark.parametrize("name", sorted(DEEP))
def test_deep_3d_epochs_fused_equal_unfused_and_reference(name, where):
    """An epoch of heat so4 k=8 and two of wave so8 k=4 (no tile fits
    shared memory on the card): the fused route bitwise equal to the unfused one
    (k K1 calls an epoch) and to the torch backend, within 1e-5 of the
    reference's fused Pallas target in interpret mode, on one device and
    over a 2×2×1 mesh of CPU ranks (against the reference on one device)."""
    rapi = _reference()
    build, k, epochs, shape, shape_2x2x1 = DEEP[name]
    if where == "2x2x1":
        shape = shape_2x2x1
    ref_prog, prog = build("repro", shape), build("repro_torch", shape)
    steps = epochs * k
    state = P.rand_state(ref_prog, 11)
    ref_target = rapi.Target(
        backend="pallas", exchange_every=k, fused_epoch=True, pallas_interpret=True
    )
    want = rapi.compile(ref_prog, ref_target).time_loop(state, steps)
    dist = {} if where == "one-device" else {
        "mesh": MESH_2X2X1, "strategy": make_strategy_3d((2, 2, 1))}
    fused = api.compile(prog, _fused(k, **dist))
    (op,) = fused.kernel_epochs()
    assert k2.plan_epoch(op).stream  # the card would stream planes
    tstate = state_from_numpy(prog, state, device="cpu")
    got = fused.time_loop(tstate, steps)
    unfused = api.compile(prog, Target(backend="cuda", exchange_every=k, device="cpu",
                                       **dist)).time_loop(tstate, steps)
    base = api.compile(prog, Target(backend="torch", device="cpu")).time_loop(tstate, steps)
    assert len(got) == len(want) == len(state)
    for g, u, b, w in zip(got, unfused, base, want):
        assert torch.equal(g, u) and torch.equal(g, b)
        torch.testing.assert_close(g, torch.from_numpy(np.array(w)), **TOL)


def test_tuner_offers_fused_k8_in_3d():
    """Heat so4 in 3-D: the tuner's space holds the fused k=8 epoch (K2's
    own plan, no explicit tile), which it used to drop because no tile fit
    shared memory; k=4 still varies K2's tile."""
    prog = P.heat("repro_torch", (32, 32, 32), 4)
    cands = enumerate_candidates(prog, devices=[CPU], backends=("cuda",), exchange_every=(4, 8),
                                 overlap=(False,), fused_epoch=(True,))
    fused = {(c.target.exchange_every, c.target.tile) for c in cands if c.target.fused_epoch}
    assert (8, None) in fused
    assert not [t for kk, t in fused if kk == 8 and t is not None]
    assert [t for kk, t in fused if kk == 4 and t is not None]
    assert tile_candidates(prog, _fused(8)) == [None]


def test_tuner_offers_a_streaming_epoch_its_own_plan_first():
    """Heat so4 k=4 at 128³ streams planes by default (a 16×16 minor tile,
    the core in 16-plane segments): the tuner offers ``None`` (the
    streaming plan) first, then two tiles of shared memory that K2 takes
    as tiled plans, in order of their cost, the same 16³ among them."""
    prog = P.heat("repro_torch", (128, 128, 128), 4)
    op = _epoch(prog, 4)
    assert k2.plan_epoch(op).stream and k2.plan_epoch(op).tile == (16, 16, 16)
    tiles = tile_candidates(prog, _fused(4))
    assert (16, 16, 16) in tiles
    assert tiles[0] is None and len(tiles) == 3
    plans = [k2.plan_epoch(op, t) for t in tiles[1:]]
    assert all(p.tile == t and not p.stream and not p.ctas for p, t in zip(plans, tiles[1:]))
    costs = [k2.tile_cost(op, p) for p in plans]
    assert costs == sorted(costs)


def test_chip_smoke_phase_20_on_the_cpu(monkeypatch, capsys):
    """``chip_smoke.deep_phase`` at 32³ on the CPU, the compiled step's ring
    forced on and each CUDA graph replaced by the stand-in of
    ``tests/test_torch_obs.py``: every check passes (the plain versions
    launch nothing, so the launch counts are 0 here), and each main-path
    case gets a kernels-line record naming its plan: streaming for all
    but heat so8 k=8's scratch plan."""
    import contextlib
    import sys
    from pathlib import Path

    from repro_torch.obs import trace as obs
    from test_torch_obs import _stand_in_graph

    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(root))
    real_init = api._Ring.__init__

    def init(ring, stencil, *args):
        real_init(ring, stencil, *args)
        ring.capture = True

    monkeypatch.setattr(api.CompiledStencil, "_graphed",
                        lambda self: self.target.jit and not obs.enabled())
    monkeypatch.setattr(api._Ring, "__init__", init)
    monkeypatch.setattr(api._Ring, "_graph", _stand_in_graph)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    try:
        records = chip_smoke.deep_phase(CPU, card="the CPU", n3=32, small=32)
    finally:
        api.clear_cache()
    out = capsys.readouterr().out
    assert "phase 20:" in out and "bitwise equal to one device" in out
    assert out.count("jit=True, donate=True: bitwise jit=False") == 6
    assert [r["name"].split("[")[1].split(" ")[0] for r in records] == [
        "heat3d_so4", "heat3d_so4", "heat3d_so8", "heat3d_so8", "wave3d_so4", "wave3d_so8"]
    assert [r["name"].rsplit(" ", 1)[1] for r in records] == [
        "stream]", "stream]", "scratch]", "stream]", "stream]", "stream]"]  # 32³'s plans
    assert out.count(", streaming: K2 bitwise its plain version") == 4
    assert "streaming forced: K2 bitwise its plain version" in out
    assert all(r["launches"] == 0 and r["max_abs_err"] == 0 for r in records)
