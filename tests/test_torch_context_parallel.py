"""Sequence-dimension context parallelism (``repro_torch.dist.
context_parallel``) on CPU ranks: the halo exchange through the shared
``dmp``/``comm`` machinery, the Mamba causal conv and sliding-window
attention over 8 sequence ranks bitwise against one rank, and within
1e-5 of the reference (its single-device path, which its own
``tests/cp_worker.py`` holds bitwise against its 8 devices).

The port refuses a halo deeper than a shard (the reference computes such
a case wrong, silently): over 4 shards of a 16-long sequence, window 6 or
9 and conv width 6 raise ``ValueError``; window 5 and conv width 5 (halo
4 = the shard length) still run, bitwise against one shard.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from repro.dist import context_parallel as rcp
from repro.kernels.ref import sliding_window_attention_ref as rwindow_ref
from repro.models.mamba import _causal_conv as rcausal_conv
from repro_torch.dist import Mesh
from repro_torch.dist.context_parallel import (
    SeqHaloSpec,
    causal_conv_cp,
    comm_ir_text,
    seq_halo_exchange,
    sliding_window_attention_cp,
)
from repro_torch.kernels.ref import sliding_window_attention_ref
from repro_torch.models.mamba import _causal_conv


def _mesh(n, axis="seq"):
    return Mesh(np.array([torch.device("cpu")] * n, dtype=object), (axis,))


def _jmesh1():
    return JMesh(np.array(jax.devices()[:1]), ("x",))


def _randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("boundary", ["zero", "periodic"])
def test_exchange_equals_slicing_the_global_array(boundary):
    B, S, C, n, lo, hi = 2, 64, 6, 8, 3, 2
    x = _randn(0, B, S, C)
    spec = SeqHaloSpec(axis="seq", n_shards=n, halo_lo=lo, halo_hi=hi, seq_dim=1,
                       boundary=boundary)
    S_loc = S // n
    shards = [torch.from_numpy(x[:, r * S_loc:(r + 1) * S_loc]) for r in range(n)]
    got = seq_halo_exchange(shards, spec, distributed=True)
    if boundary == "periodic":
        pad = np.concatenate([x[:, -lo:], x, x[:, :hi]], axis=1)
    else:
        pad = np.pad(x, ((0, 0), (lo, hi), (0, 0)))
    for r in range(n):
        assert np.array_equal(got[r].numpy(), pad[:, r * S_loc:r * S_loc + lo + S_loc + hi]), r


def test_causal_conv_over_8_ranks_is_one_rank_bitwise_and_the_reference():
    x, w, b = _randn(1, 2, 64, 16), _randn(2, 4, 16), _randn(3, 16)
    tx, tw, tb = map(torch.from_numpy, (x, w, b))
    want = _causal_conv(tx, tw, tb)[0]
    got = causal_conv_cp(tx, tw, tb, _mesh(8), "seq")
    assert torch.equal(got, want)
    assert torch.equal(causal_conv_cp(tx, tw, tb, _mesh(1, "x"), "x"), want)
    ref = np.asarray(rcausal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))[0])
    torch.testing.assert_close(got, torch.from_numpy(np.array(ref)), rtol=1e-5, atol=1e-5)


def test_window_attention_over_8_ranks_is_one_rank_bitwise_and_the_reference():
    B, S, H, D, W = 2, 64, 2, 8, 8
    q, k, v = (_randn(s, B, S, H, D) for s in (4, 5, 6))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    one = sliding_window_attention_cp(tq, tk, tv, W, _mesh(1, "x"), "x")
    got = sliding_window_attention_cp(tq, tk, tv, W, _mesh(8), "seq")
    assert torch.equal(got, one)
    ref = rcp.sliding_window_attention_cp(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), W,
                                          _jmesh1(), "x")
    torch.testing.assert_close(got, torch.from_numpy(np.array(ref)), rtol=1e-5, atol=1e-5)


def test_window_attention_agrees_with_dense_and_the_ported_oracle():
    B, S, H, D, W = 2, 64, 2, 8, 8
    q, k, v = (_randn(s, B, S, H, D) for s in (7, 8, 9))
    s = np.einsum("bthd,bshd->bhts", q, k) / np.sqrt(D)
    pos = np.arange(S)
    mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - W)
    s = np.where(mask[None, None], s, -1e30)
    p = np.exp(s - s.max(-1, keepdims=True))
    dense = np.einsum("bhts,bshd->bthd", p / p.sum(-1, keepdims=True), v)
    got = sliding_window_attention_cp(*map(torch.from_numpy, (q, k, v)), W, _mesh(8), "seq")
    torch.testing.assert_close(got, torch.from_numpy(dense.astype(np.float32)), rtol=2e-5,
                               atol=2e-5)
    for b in range(B):  # the oracle takes [heads, seq, dim]
        qh, kh, vh = (torch.from_numpy(a[b].transpose(1, 0, 2).copy()) for a in (q, k, v))
        oracle = sliding_window_attention_ref(qh, kh, vh, W)
        torch.testing.assert_close(got[b].transpose(0, 1), oracle, rtol=1e-5, atol=1e-5)
        want = rwindow_ref(*(jnp.asarray(a[b].transpose(1, 0, 2)) for a in (q, k, v)), W)
        torch.testing.assert_close(oracle, torch.from_numpy(np.array(want)), rtol=1e-5,
                                   atol=1e-5)


def test_comm_ir_equals_the_reference():
    for shape, spec in (((2, 8, 6), dict(n_shards=8, halo_lo=3)),
                        ((2, 1, 16, 2, 4), dict(n_shards=4, halo_lo=5, seq_dim=2)),
                        ((4, 8), dict(n_shards=2, halo_lo=1, halo_hi=2, boundary="periodic"))):
        got = comm_ir_text(shape, SeqHaloSpec(axis="seq", **spec))
        assert got == rcp.comm_ir_text(shape, rcp.SeqHaloSpec(axis="seq", **spec))
        assert "comm.halo_pad" in got and "comm.exchange_start" in got and "comm.wait" in got


@pytest.mark.parametrize("W", [6, 9])
def test_a_window_deeper_than_a_shard_raises(W):
    q, k, v = (torch.from_numpy(_randn(s, 1, 16, 1, 4)) for s in (10, 11, 12))
    with pytest.raises(ValueError, match=r"axis 'seq'.*lo=%d.*shard length 4.*over 4 shards"
                       % (W - 1)):
        sliding_window_attention_cp(q, k, v, W, _mesh(4), "seq")


def test_a_conv_deeper_than_a_shard_raises():
    x, w, b = (torch.from_numpy(a) for a in (_randn(13, 1, 16, 3), _randn(14, 6, 3),
                                              _randn(15, 3)))
    with pytest.raises(ValueError, match="shard length 4"):
        causal_conv_cp(x, w, b, _mesh(4), "seq")


def test_a_halo_of_one_shard_length_still_runs_bitwise():
    q, k, v = (torch.from_numpy(_randn(s, 1, 16, 1, 4)) for s in (16, 17, 18))
    assert torch.equal(sliding_window_attention_cp(q, k, v, 5, _mesh(4), "seq"),
                       sliding_window_attention_cp(q, k, v, 5, _mesh(1, "x"), "x"))
    x, w, b = (torch.from_numpy(a) for a in (_randn(19, 1, 16, 3), _randn(20, 5, 3),
                                              _randn(21, 3)))
    assert torch.equal(causal_conv_cp(x, w, b, _mesh(4), "seq"), _causal_conv(x, w, b)[0])


def test_a_mesh_with_another_axis_exchanges_along_the_sequence_axis_only():
    mesh = Mesh(np.array([torch.device("cpu")] * 8, dtype=object).reshape(2, 4), ("data", "seq"))
    x, w, b = (torch.from_numpy(a) for a in (_randn(22, 2, 32, 5), _randn(23, 3, 5),
                                              _randn(24, 5)))
    assert torch.equal(causal_conv_cp(x, w, b, mesh, "seq"), _causal_conv(x, w, b)[0])
    q, k, v = (torch.from_numpy(_randn(s, 2, 32, 2, 4)) for s in (25, 26, 27))
    assert torch.equal(sliding_window_attention_cp(q, k, v, 6, mesh, "seq"),
                       sliding_window_attention_cp(q, k, v, 6, _mesh(1, "x"), "x"))
