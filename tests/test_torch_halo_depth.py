"""A per-step halo deeper than a shard (at ``exchange_every=1``) is
refused with ``TargetError``, on the CPU.

A rank takes its halo from its immediate neighbour's core only, so a
decomposition whose shard is thinner than the step's accumulated halo
cannot be right: the reference accepts it and returns wrong numbers
(``src/repro/api.py:917``); the port refuses it for every target with a
decomposed dim, k = 1 included.  The smallest case: 8 points, one apply
``u[-3]*0.25 + u[3]*0.5``; over 4 periodic ranks (shard 2) the unrefused
run gave ``[2, 1.75, 3, 0.25, 4, 0.75, 1, 1.25]`` against
``[3.5, 4.25, 5, 3.75, 4.5, 1.25, 2, 2.75]`` on one device.  Over 2 ranks
(shard 4) it is bitwise its one-device run.  Targets on one device stay
accepted, and the tuner's space drops the over-deep meshes.
"""
import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.api import Target, TargetError
from repro_torch.core.passes import temporal
from repro_torch.core.passes.decompose import make_strategy_1d, make_strategy_3d
from repro_torch.dist import Mesh
from repro_torch.frontends.oec_like import ProgramBuilder
from repro_torch.tune.space import enumerate_candidates

CPU = torch.device("cpu")


def _shift_program(n=8, r=3, boundary="periodic", rank=1):
    pb = ProgramBuilder(f"shift_r{r}_{rank}d_{boundary}", (n,) * rank)
    u, out = pb.input("u"), pb.output("out")

    def fn(b, v):
        lo = tuple(-r if d == 0 else 0 for d in range(rank))
        hi = tuple(r if d == rank - 1 else 0 for d in range(rank))
        return v.at(*lo) * 0.25 + v.at(*hi) * 0.5

    pb.store(pb.apply([pb.load(u)], fn), out)
    return pb.finish(boundary=boundary)


def _chain_program(n=8, applies=3, boundary="zero"):
    """``applies`` chained radius-1 smoothers: a per-step halo of ``applies``."""
    pb = ProgramBuilder(f"chain{applies}_{boundary}", (n,))
    u, out = pb.input("u"), pb.output("out")
    h = pb.load(u)
    for _ in range(applies):
        h = pb.apply([h], lambda b, v: v.at(-1) * 0.25 + v.at(0) * 0.5 + v.at(1) * 0.25)
    pb.store(h, out)
    return pb.finish(boundary=boundary)


def _target(ranks, rank=1):
    if ranks == 1:
        return Target(device="cpu")
    if rank == 1:
        mesh = Mesh(np.array([CPU] * ranks, dtype=object), ("x",))
        return Target(device="cpu", mesh=mesh, strategy=make_strategy_1d(ranks))
    mesh = Mesh(np.array([CPU] * 8, dtype=object).reshape(2, 2, 2), ("x", "y", "z"))
    return Target(device="cpu", mesh=mesh, strategy=make_strategy_3d((2, 2, 2)))


def _run(program, target):
    rng = np.random.default_rng(0)
    shape = program.field_args[0].type.bounds.shape
    u = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return api.compile(program, target)(u, torch.zeros(shape))[0]


@pytest.mark.parametrize("boundary", ["periodic", "zero"])
def test_the_eight_point_case_raises_over_four_ranks_and_is_bitwise_over_two(boundary):
    p = _shift_program(boundary=boundary)
    with pytest.raises(TargetError, match=r"per-step halo 3 along dim 0 \(mesh axis 'x'\) exceeds "
                                          r"the local shard extent 2"):
        api.compile(p, _target(4))
    assert torch.equal(_run(p, _target(2)), _run(p, _target(1)))
    if boundary == "periodic":
        u = torch.arange(1, 9, dtype=torch.float32)
        got = api.compile(p, _target(1))(u, torch.zeros(8))[0]
        assert got.tolist() == [3.5, 4.25, 5, 3.75, 4.5, 1.25, 2, 2.75]


@pytest.mark.parametrize("program, ranks", [
    (lambda: _chain_program(applies=3), 4),
    (lambda: _shift_program(r=5), 2),
    (lambda: _shift_program(r=5, boundary="zero"), 2),
    (lambda: _shift_program(n=4, r=3, rank=3), 8),
], ids=["chain_of_three_over_4", "radius5_over_2_periodic", "radius5_over_2_zero", "3d_over_2x2x2"])
def test_over_deep_programs_raise_and_run_on_one_device(program, ranks):
    p = program()
    rank = p.rank
    with pytest.raises(TargetError, match="exceeds the local shard extent"):
        api.compile(p, _target(ranks, rank))
    out = _run(p, _target(1))  # one device: accepted
    assert torch.isfinite(out).all()


@pytest.mark.parametrize("program, ranks", [
    (lambda: _shift_program(r=2), 4),
    (lambda: _shift_program(r=3, n=16), 4),
    (lambda: _chain_program(applies=3), 2),
], ids=["radius2_over_4", "radius3_shard4", "chain_of_three_over_2"])
def test_halos_that_fit_their_shard_are_bitwise_their_one_device_run(program, ranks):
    p = program()
    assert torch.equal(_run(p, _target(ranks)), _run(p, _target(1)))


def test_programs_epoch_halo_cannot_analyse_take_the_emitted_exchanges(monkeypatch):
    """Where ``epoch_halo`` raises, the widths come from the lowered IR's
    swaps and exchanges: the same verdicts."""

    def cannot(func, k):
        raise temporal.TemporalTilingError("not analysable")

    monkeypatch.setattr(temporal, "epoch_halo", cannot)
    with pytest.raises(TargetError, match="per-step halo 3 along dim 0"):
        api.compile(_shift_program(boundary="zero"), _target(4))
    with pytest.raises(TargetError, match="per-step halo 3 along dim 0"):
        api.compile(_chain_program(applies=3), _target(4))
    p = _shift_program()
    assert torch.equal(_run(p, _target(2)), _run(p, _target(1)))


def test_the_tuner_space_drops_the_over_deep_mesh():
    p = _shift_program()
    kw = dict(backends=("torch",), exchange_every=(1,), overlap=(False,), fused_epoch=(False,))
    four = enumerate_candidates(p, devices=[CPU] * 4, ranks=4, **kw)
    assert four[0].note.startswith("auto invalid") and four[0].target.mesh is None
    assert all(c.target.mesh is None for c in four)
    two = enumerate_candidates(p, devices=[CPU] * 2, ranks=2, **kw)
    assert any(c.target.mesh is not None for c in two)
