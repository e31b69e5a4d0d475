"""The port's model layers (``repro_torch.models``) against the
reference's (``repro.models``) on the CPU: windowed chunked attention, the
online-softmax decode, the SSD scan, the mLSTM chunk scan, the sLSTM, MoE
with capacity drops and its aux losses, and top-k ties, in float32 within
rtol = atol = 1e-4; three configs end to end in bfloat16, their own dtype;
and ``repro_torch.interop.params_from_numpy``'s refusals.

In bfloat16 the two sides round the same float32 values to bfloat16 at the
same points, but a value that lands within a float32 summation-order
difference of a rounding boundary rounds to neighbouring bfloat16 values
(one ulp: 2**-9 at the logits' magnitude of ~0.5) on the two sides, and the
flips propagate through the layers.  Measured: dense configs differ by at
most ~3 such ulps (0.003-0.006), xlstm-1.3b by ~9 (0.018; its per-head norm
amplifies, see ``test_torch_models.py``).  The bar is atol = rtol = 0.03
(15 ulps) and a mean absolute difference under 5e-3.  The three are
qwen2-7b (the dense main config), gemma2-27b (softcaps and local windows)
and xlstm-1.3b (recurrent): an MoE config's top-k routing is a discrete
choice that a one-ulp flip of a near-tied router probability changes
(jamba-v0.1-52b: one token of 32 sent to another expert, logits 0.36
apart), which no tolerance on values describes.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as rattn
from repro.models import lm as rlm
from repro.models import mamba as rmamba
from repro.models import moe as rmoe
from repro.models import xlstm as rxlstm
from repro_torch.interop import params_from_numpy
from repro_torch.models import attention, lm, mamba, moe, xlstm
from _torch_lm import Pair, cfgs, to_numpy

TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=3e-2, atol=3e-2)
BF16_MEAN = 5e-3


def _close(got, want, tol=TOL, what=""):
    want = torch.from_numpy(np.array(want, np.float32))
    torch.testing.assert_close(got.float(), want, **tol, msg=lambda m: f"{what}: {m}")


@pytest.mark.parametrize("arch", ["qwen2-7b", "gemma2-27b", "xlstm-1.3b"])
def test_bfloat16_matches_reference(arch):
    p = Pair(arch, dtype="bfloat16", seed=5)
    (rt, rm), (t, m) = p.inputs()
    want, _ = rlm.forward_train(p.rparams, p.rcfg, rt, rm, q_chunk=8)
    got, _ = lm.forward_train(p.params, p.cfg, t, m, q_chunk=8)
    _close(got, want, BF16_TOL, f"{arch} bf16 train logits")
    rlogits, rcache = rlm.forward_prefill(p.rparams, p.rcfg, rt[:, :-1], rm, q_chunk=8)
    logits, cache = lm.forward_prefill(p.params, p.cfg, t[:, :-1], m, q_chunk=8)
    _close(logits, rlogits, BF16_TOL, f"{arch} bf16 prefill logits")
    n = rt.shape[1] - 1
    rcache = rlm.grow_cache(p.rcfg, rcache, n + 1, n)
    cache = lm.grow_cache(p.cfg, cache, n + 1, n)
    want_d, _ = rlm.decode_step(p.rparams, p.rcfg, rt[:, -1], jnp.int32(n), rcache)
    got_d, _ = lm.decode_step(p.params, p.cfg, t[:, -1], n, cache)
    _close(got_d, want_d, BF16_TOL, f"{arch} bf16 decode logits")
    for g, w in ((got, want), (logits, rlogits), (got_d, want_d)):
        v = p.cfg.vocab_size
        diff = (g[..., :v].float() - torch.from_numpy(np.array(w[..., :v], np.float32))).abs()
        assert float(diff.mean()) < BF16_MEAN, (arch, float(diff.mean()))


# --------------------------------------------------------------------------
# layer cases
# --------------------------------------------------------------------------


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("window,q_chunk,softcap", [(5, 4, 0.0), (0, 8, 30.0), (3, 16, 0.0)])
def test_chunked_attention_windowed(window, q_chunk, softcap):
    rng = np.random.default_rng(11)
    q, k, v = _rand(rng, 2, 16, 4, 8), _rand(rng, 2, 16, 2, 8), _rand(rng, 2, 16, 2, 8)
    kw = dict(causal=True, window=window, attn_softcap=softcap, q_chunk=q_chunk)
    want = rattn.chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   dtype=jnp.float32, **kw)
    got = attention.chunked_attention(torch.from_numpy(q), torch.from_numpy(k),
                                      torch.from_numpy(v), dtype=torch.float32, **kw)
    _close(got, want)
    kw = dict(causal=False, kv_len=11, q_offset=3, q_chunk=q_chunk)
    want = rattn.chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   dtype=jnp.float32, **kw)
    got = attention.chunked_attention(torch.from_numpy(q), torch.from_numpy(k),
                                      torch.from_numpy(v), dtype=torch.float32, **kw)
    _close(got, want)


@pytest.mark.parametrize("window", [0, 24])
def test_online_softmax_decode(monkeypatch, window):
    """``DECODE_KV_CHUNK`` patched on both sides (T=64 → 8 chunks of 8):
    the port's online-softmax decode against the reference's, and against
    its own dense path; the cache writes are the same."""
    rcfg, cfg = cfgs("qwen2-7b", dtype="float32", local_window=window)
    kind = "attn_local" if window else "attn"
    rp = rattn.attn_init(jax.random.PRNGKey(0), rcfg)
    p = {k: torch.from_numpy(np.array(v)) for k, v in rp.items()}
    rng = np.random.default_rng(1)
    x = _rand(rng, 3, 1, cfg.d_model)
    ck = _rand(rng, 3, 64, cfg.n_kv_heads, cfg.head_dim_)
    cv = _rand(rng, 3, 64, cfg.n_kv_heads, cfg.head_dim_)
    pos = np.array([40, 55, 63], np.int32)

    def port():
        return attention.decode_self_attention(
            p, torch.from_numpy(x), torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy()),
            torch.from_numpy(pos), cfg, kind=kind, dtype=torch.float32)

    monkeypatch.setattr(attention, "DECODE_KV_CHUNK", 10**9)
    dense, k1, _ = port()
    monkeypatch.setattr(attention, "DECODE_KV_CHUNK", 8)
    monkeypatch.setattr(rattn, "DECODE_KV_CHUNK", 8)
    chunked, k2, _ = port()
    want, rk, _ = rattn.decode_self_attention(
        rp, jnp.asarray(x), jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(pos), rcfg,
        kind=kind, dtype=jnp.float32)
    torch.testing.assert_close(chunked, dense, rtol=1e-5, atol=1e-5)
    _close(chunked, want)
    assert torch.equal(k1, k2)
    _close(k2, rk, dict(rtol=0, atol=0))


def test_ssd_scan():
    rng = np.random.default_rng(2)
    Bt, L, nh, P, N = 2, 16, 3, 8, 4
    x, Bm, Cm = _rand(rng, Bt, L, nh, P), _rand(rng, Bt, L, N), _rand(rng, Bt, L, N)
    dt = np.abs(_rand(rng, Bt, L, nh)) * 0.1
    A = -np.linspace(0.5, 2.0, nh).astype(np.float32)
    h0 = _rand(rng, Bt, nh, N, P)
    for chunk in (4, 16):
        want_y, want_h = rmamba.mamba_ssd_scan(*map(jnp.asarray, (x, dt, Bm, Cm, A)), chunk=chunk,
                                               h0=jnp.asarray(h0))
        y, h = mamba.mamba_ssd_scan(*map(torch.from_numpy, (x, dt, Bm, Cm, A)), chunk=chunk,
                                    h0=torch.from_numpy(h0))
        _close(y, want_y)
        _close(h, want_h)


def test_mlstm_chunk_scan():
    rng = np.random.default_rng(3)
    Bt, L, nh, hd = 2, 16, 2, 8
    q, k, v = (_rand(rng, Bt, L, nh, hd) for _ in range(3))
    logf = np.log(1 / (1 + np.exp(-_rand(rng, Bt, L, nh) - 2))).astype(np.float32)
    logi = _rand(rng, Bt, L, nh)
    state = (_rand(rng, Bt, nh, hd, hd), np.abs(_rand(rng, Bt, nh, hd)))
    for chunk in (4, 16):
        want_h, (wC, wn) = rxlstm.mlstm_chunk_scan(
            *map(jnp.asarray, (q, k, v, logf, logi)), chunk, tuple(map(jnp.asarray, state)))
        h, (C, n) = xlstm.mlstm_chunk_scan(
            *map(torch.from_numpy, (q, k, v, logf, logi)), chunk, tuple(map(torch.from_numpy, state)))
        _close(h, want_h)
        _close(C, wC)
        _close(n, wn)


def test_slstm():
    rcfg, cfg = cfgs("xlstm-1.3b", dtype="float32")
    rp = rxlstm.slstm_init(jax.random.PRNGKey(4), rcfg)
    p = {k: torch.from_numpy(np.array(v)) for k, v in rp.items()}
    rng = np.random.default_rng(4)
    x = _rand(rng, 2, 7, cfg.d_model)
    nh, hd = cfg.n_heads, cfg.d_model // cfg.n_heads
    state = tuple(_rand(rng, 2, nh, hd) * s for s in (1.0, 1.0, 1.0, 0.1))
    for st in (None, state):
        want, wstate = rxlstm.slstm_apply(rp, jnp.asarray(x), rcfg, jnp.float32,
                                          None if st is None else tuple(map(jnp.asarray, st)))
        got, gstate = xlstm.slstm_apply(p, torch.from_numpy(x), cfg, torch.float32,
                                        None if st is None else tuple(map(torch.from_numpy, st)))
        _close(got, want)
        for g, w in zip(gstate, wstate):
            _close(g, w)


@pytest.mark.parametrize("capacity_factor", [0.5, 1.0, 8.0])
def test_moe_capacity_drops_and_aux(capacity_factor):
    """Capacity dropping follows the reference's cumsum order exactly (the
    same assignments kept), and the aux losses agree."""
    rcfg, cfg = cfgs("olmoe-1b-7b", dtype="float32")
    rcfg = dataclasses.replace(rcfg, moe=dataclasses.replace(rcfg.moe, capacity_factor=capacity_factor))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=capacity_factor))
    rp = rmoe.moe_init(jax.random.PRNGKey(5), rcfg)
    p = {k: torch.from_numpy(np.array(v)) for k, v in rp.items()}
    x = _rand(np.random.default_rng(5), 2, 12, cfg.d_model)
    want, raux = rmoe.moe_apply(rp, jnp.asarray(x), rcfg, jnp.float32)
    got, aux = moe.moe_apply(p, torch.from_numpy(x), cfg, torch.float32)
    _close(got, want)
    for k in raux:
        _close(aux[k], raux[k])
    # the same assignments are kept on both sides
    xt = x.reshape(-1, cfg.d_model)
    _, ridx, _ = rmoe._route(rp, jnp.asarray(xt), rcfg, jnp.float32)
    _, idx, _ = moe._route(p, torch.from_numpy(xt), cfg, torch.float32)
    assert np.array_equal(idx.numpy(), np.asarray(ridx))
    E, K = cfg.moe.num_experts, cfg.moe.top_k
    C = min(max(1, int(24 * K * capacity_factor) // E), 24)
    _, rdest, rkept = rmoe._dispatch_scatter(jnp.asarray(xt), ridx, E, C)
    _, dest, kept = moe._dispatch_scatter(torch.from_numpy(xt), idx, E, C)
    assert np.array_equal(kept.numpy(), np.asarray(rkept))
    assert np.array_equal(dest.numpy(), np.asarray(rdest))
    if capacity_factor < 1.0:
        assert not kept.all()  # some assignments dropped


def test_top_k_orders_ties_by_index():
    probs = np.array([[0.25, 0.25, 0.1, 0.25, 0.15], [0.1, 0.3, 0.3, 0.0, 0.3]], np.float32)
    want_v, want_i = jax.lax.top_k(jnp.asarray(probs), 3)
    got_v, got_i = moe.top_k(torch.from_numpy(probs), 3)
    assert np.array_equal(got_i.numpy(), np.asarray(want_i))
    assert np.array_equal(got_v.numpy(), np.asarray(want_v))


# --------------------------------------------------------------------------
# params_from_numpy
# --------------------------------------------------------------------------


def test_params_from_numpy_copies_and_refuses():
    rcfg, cfg = cfgs("qwen2-7b", dtype="float32")
    tree = to_numpy(rlm.init_params(jax.random.PRNGKey(0), rcfg))
    tree = jax.tree.map(np.array, tree)  # writable copies
    params = params_from_numpy(cfg, tree, device="cpu")
    wq = tree["cells"]["slot0"]["attn"]["wq"]
    assert torch.equal(params["cells"]["slot0"]["attn"]["wq"], torch.from_numpy(wq))
    wq[0, 0, 0, 0] = 123.0
    assert params["cells"]["slot0"]["attn"]["wq"][0, 0, 0, 0] != 123.0  # a copy

    def edit(fn):
        t = jax.tree.map(lambda a: a, tree)
        fn(t)
        return t

    with pytest.raises(KeyError, match="missing leaves \\['cells.slot0.attn.bq'\\]"):
        params_from_numpy(cfg, edit(lambda t: t["cells"]["slot0"]["attn"].pop("bq")), device="cpu")
    with pytest.raises(KeyError, match="extra leaves \\['cells.slot0.attn.extra'\\]"):
        params_from_numpy(cfg, edit(lambda t: t["cells"]["slot0"]["attn"].__setitem__(
            "extra", np.zeros(3, np.float32))), device="cpu")
    with pytest.raises(ValueError, match="shape"):
        params_from_numpy(cfg, edit(lambda t: t.__setitem__("final_norm", np.zeros(3, np.float32))),
                          device="cpu")
    with pytest.raises(TypeError, match="float32"):
        params_from_numpy(cfg, edit(lambda t: t.__setitem__(
            "final_norm", t["final_norm"].astype(np.float64))), device="cpu")
    with pytest.raises(TypeError, match="numpy array"):
        params_from_numpy(cfg, edit(lambda t: t.__setitem__(
            "final_norm", torch.zeros(cfg.d_model))), device="cpu")
