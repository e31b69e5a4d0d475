"""Deep-halo epochs in the port: exchange once, step k times.

The port of ``tests/test_temporal.py``'s property harness: random stencil
programs (``_strategies.program_descriptors``: rank 1 or 2, a DAG of 1–3
applies with offsets within radius 2, either boundary) must give
bitwise-identical results for ``exchange_every`` k ∈ {1, 2, 4} against the
one-exchange-per-step baseline, on one device and on 2- and 4-rank CPU
meshes (``random_program("repro_torch", ...)`` draws the same programs as
``_strategies.build_program``).  A depth whose accumulated halo outgrows
the domain (or a rank's shard) is refused with the reference's
``TargetError``.

Against the reference, one case per program family (rank, applies,
boundary) at k = 2 and 4: the port's epochs within rtol=atol=1e-5 of the
reference's ``jit=False`` run (XLA may fuse ``a*b+c``; torch rounds each
op), and the same deep-halo refusals.
"""
import numpy as np
import pytest
import torch

import _torch_programs as P
from _hypothesis_compat import given, settings
from _strategies import build_program, exchange_everys, program_descriptors
from repro import api as rapi
from repro_torch import api
from repro_torch.api import Target, TargetError
from repro_torch.core.passes.decompose import make_strategy_1d, make_strategy_2d
from repro_torch.core.passes.temporal import epoch_halo
from repro_torch.dist import Mesh

CPU = torch.device("cpu")
TOL = dict(rtol=1e-5, atol=1e-5)


def _mesh_kw(rank: int, ranks: int) -> dict:
    """A CPU mesh of ``ranks`` ranks over a rank-``rank`` program (none for
    one rank): 1-D programs split dim 0 ``ranks`` ways; 2-D ones split
    dim 0 in two and, for four ranks, dim 1 in two as well."""
    if ranks == 1:
        return {"device": "cpu"}
    if rank == 1:
        shape, names, strategy = (ranks,), ("x",), make_strategy_1d(ranks)
    else:
        shape = (2, ranks // 2)
        names, strategy = ("x", "y"), make_strategy_2d(shape)
    devices = np.array([CPU] * ranks, dtype=object).reshape(shape)
    return {"mesh": Mesh(devices, names), "strategy": strategy}


def _epochs(step, u0: torch.Tensor, n_calls: int) -> torch.Tensor:
    """``n_calls`` calls of a one-input step, each fed the last result."""
    u = u0
    for _ in range(n_calls):
        (u,) = step.step()(u)
    return u


def _rejects_deep_halo(prog, k, **kw) -> bool:
    try:
        api.compile(prog, Target(exchange_every=k, **kw))
    except TargetError as e:
        assert "deep halo" in str(e), e
        return True
    return False


@settings(max_examples=60, deadline=None)
@given(descriptor=program_descriptors, k=exchange_everys)
def test_epoch_equals_steps_bitwise(descriptor, k):
    """exchange_every=k over 2·k steps is bitwise-equal to the k=1
    baseline for a random program, on 1, 2 and 4 ranks; a depth the
    domain cannot hold is refused, never computed."""
    seed, rank, n_applies, boundary = descriptor
    prog = P.random_program("repro_torch", seed, rank, n_applies, boundary)
    shape = prog.field_args[0].type.bounds.shape
    lo, hi = epoch_halo(prog.func, k)
    if any(max(l, h) > n for l, h, n in zip(lo, hi, shape)):
        with pytest.raises(TargetError, match="deep halo"):
            api.compile(prog, Target(exchange_every=k, device="cpu"))
        return
    rng = np.random.default_rng(seed + 1)
    u0 = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    steps = 2 * k  # two epochs: exercises epoch-to-epoch rotation too
    want = _epochs(api.compile(prog, Target(device="cpu")), u0, steps)
    for ranks in (1, 2, 4):
        kw = _mesh_kw(rank, ranks)
        if _rejects_deep_halo(prog, k, **kw):
            # the halo fits the domain but not a rank's shard
            assert ranks > 1
            continue
        base = api.compile(prog, Target(**kw))
        tiled = api.compile(prog, Target(exchange_every=k, **kw))
        assert torch.equal(_epochs(base, u0, steps), want), ranks
        got = _epochs(tiled, u0, steps // k)
        assert torch.equal(got, want), (ranks, float((got - want).abs().max()))


FAMILIES = [(rank, n, bc) for rank in (1, 2) for n in (1, 2, 3) for bc in ("zero", "periodic")]


@pytest.mark.parametrize("rank,n_applies,boundary", FAMILIES)
def test_epochs_match_the_reference(rank, n_applies, boundary):
    """One seeded program per family: the port's epochs at k = 2 and 4
    within rtol=atol=1e-5 of the reference's ``jit=False`` run of the same
    program and input, and a depth the reference refuses ("deep halo") is
    refused by the port too."""
    seed = 1000 * rank + 10 * n_applies + (boundary == "zero")
    ref_prog = build_program(seed, rank, n_applies, boundary)
    prog = P.random_program("repro_torch", seed, rank, n_applies, boundary)
    assert prog.fingerprint == ref_prog.fingerprint
    shape = prog.field_args[0].type.bounds.shape
    u0 = np.random.default_rng(seed + 1).standard_normal(shape).astype(np.float32)
    for k in (2, 4):
        try:
            ref = rapi.compile(ref_prog, rapi.Target(exchange_every=k, jit=False))
        except rapi.TargetError as e:
            assert "deep halo" in str(e)
            with pytest.raises(TargetError, match="deep halo"):
                api.compile(prog, Target(exchange_every=k, device="cpu"))
            continue
        want = u0
        for _ in range(2):
            want = np.array(ref(want, np.zeros_like(u0))[0])
        got = _epochs(api.compile(prog, Target(exchange_every=k, device="cpu")),
                      torch.from_numpy(u0), 2)
        torch.testing.assert_close(got, torch.from_numpy(want), **TOL)
