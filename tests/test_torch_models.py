"""The port's language models (``repro_torch.models.lm``) against the
reference's (``repro.models.lm``), on the CPU at the reduced sizes of
``reduced_config``, in float32.

The reference's parameters are carried across with
``repro_torch.interop.params_from_numpy``; inputs are made from seeds with
numpy.  Every config's ``forward_train``, ``forward_prefill`` (logits and
every cache leaf) and ``decode_step`` (one position for the batch, and one
per row, two steps) agree within rtol = atol = 1e-4: both sides compute in
float32 and differ only in summation order and in the last ulp of their
exp/tanh (XLA fuses and reorders; eager torch rounds each op).

One allowance is added to atol: ``noise``, the largest change of the same
outputs when the port's parameters move by a relative 2**-24 (half a
float32 ulp) of seeded noise — how far rounding alone moves this input.
It is ~1e-6 for nine configs.  For xlstm-1.3b it is ~1e-4: at its random
initialisation some mLSTM head outputs are nearly zero (per-head variance
~1e-6, the norm's eps), so the per-head norm scales rounding differences
by ~10**3 per layer.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm import B, Pair, to_numpy
from repro.configs import get_config as rget_config
from repro.configs.base import reduced_config as rreduced
from repro.configs.registry import ARCHS as RARCHS
from repro.models import lm as rlm
from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.base import reduced_config
from repro_torch.models import lm

TOL = dict(rtol=1e-4, atol=1e-4)
# the reference's entry points, compiled once per config and shape
R_TRAIN = jax.jit(rlm.forward_train, static_argnums=(1,), static_argnames=("q_chunk", "remat"))
R_PREFILL = jax.jit(rlm.forward_prefill, static_argnums=(1,), static_argnames=("q_chunk",))
R_DECODE = jax.jit(rlm.decode_step, static_argnums=(1,))


def _close(got, want, noise=0.0, what=""):
    want = torch.from_numpy(np.array(want, np.float32))
    torch.testing.assert_close(got.float(), want, rtol=TOL["rtol"], atol=TOL["atol"] + noise,
                               msg=lambda m: f"{what}: {m}")


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return Pair(request.param)


def test_configs_equal_the_reference_field_for_field():
    assert ARCHS == RARCHS
    for arch in ARCHS:
        port, ref = get_config(arch), rget_config(arch)
        assert dataclasses.asdict(port) == dataclasses.asdict(ref), arch
        assert repr(port) == repr(ref), arch  # the serving engine's cache key
        assert port.param_count() == ref.param_count(), arch
        assert port.active_param_count() == ref.active_param_count(), arch
        assert dataclasses.asdict(reduced_config(port)) == dataclasses.asdict(rreduced(ref))


def test_init_params_has_the_reference_tree(pair):
    """Random init draws the reference's paths and shapes on the device asked
    for, from the generator given (the same seed, the same draws)."""
    gen = torch.Generator().manual_seed(3)
    mine = lm.leaves(lm.init_params(pair.cfg, generator=gen, device="cpu"))
    want = lm.leaves(pair.params)
    assert list(mine) == list(want)
    for path, t in mine.items():
        assert t.shape == want[path].shape and t.dtype == torch.float32, path
        assert t.device.type == "cpu"
    again = lm.leaves(lm.init_params(pair.cfg, torch.Generator().manual_seed(3), "cpu"))
    assert all(torch.equal(again[k], v) for k, v in mine.items())


def test_forward_train_matches_reference(pair):
    (rt, rm), (t, m) = pair.inputs()
    want, raux = R_TRAIN(pair.rparams, pair.rcfg, rt, rm, q_chunk=8)

    def run(params):
        return lm.forward_train(params, pair.cfg, t, m, q_chunk=8)

    got, aux = run(pair.params)
    noise = pair.noise(run)
    assert tuple(got.shape) == want.shape
    _close(got, want, noise, f"{pair.arch} logits")
    assert sorted(aux) == sorted(raux)
    for k in aux:
        _close(aux[k], raux[k], noise, f"{pair.arch} {k}")


def test_forward_prefill_matches_reference(pair):
    (rt, rm), (t, m) = pair.inputs()
    rlogits, rcache = R_PREFILL(pair.rparams, pair.rcfg, rt, rm, q_chunk=8)

    def run(params):
        return lm.forward_prefill(params, pair.cfg, t, m, q_chunk=8)

    logits, cache = run(pair.params)
    noise = pair.noise(run)
    _close(logits, rlogits, noise, f"{pair.arch} logits")
    got, want = lm.leaves(cache), lm.leaves(to_numpy(rcache))
    assert sorted(got) == sorted(want)
    for path, t in got.items():
        assert t.dtype == getattr(torch, str(want[path].dtype)), path
        _close(t, want[path], noise, f"{pair.arch} cache {path}")


@pytest.mark.parametrize("per_slot", [False, True], ids=["one_position", "per_slot"])
def test_decode_step_matches_reference(pair, per_slot):
    """Two decode steps after the prefill (the second reads what the first
    wrote), with the reference's greedy token fed to both sides."""
    (rt, rm), (t, m) = pair.inputs()
    n = pair.n
    tok0 = np.random.default_rng(7).integers(0, pair.cfg.vocab_size, size=(B,)).astype(np.int32)
    pos0 = np.array([n, n - 3], np.int32) if per_slot else np.int32(n)
    _, rcache = R_PREFILL(pair.rparams, pair.rcfg, rt, rm, q_chunk=8)
    rcache = rlm.grow_cache(pair.rcfg, rcache, n + 4, n)
    tok, pos, wants = tok0, pos0, []
    for _ in range(2):
        want, rcache = R_DECODE(pair.rparams, pair.rcfg, jnp.asarray(tok), jnp.asarray(pos), rcache)
        wants.append(want)
        tok = np.asarray(want[:, : pair.cfg.vocab_size]).argmax(-1).astype(np.int32)
        pos = pos + 1
    feeds = [tok0] + [np.asarray(w[:, : pair.cfg.vocab_size]).argmax(-1) for w in wants[:1]]

    def run(params):
        _, cache = lm.forward_prefill(params, pair.cfg, t, m, q_chunk=8)
        cache = lm.grow_cache(pair.cfg, cache, n + 4, n)
        outs = []
        for step, tk in enumerate(feeds):
            logits, cache = lm.decode_step(params, pair.cfg, torch.from_numpy(tk).long(),
                                           torch.as_tensor(pos0 + step), cache)
            outs.append(logits)
        return outs, cache

    (got, cache) = run(pair.params)
    noise = pair.noise(run)
    for step, (g, w) in enumerate(zip(got, wants)):
        _close(g, w, noise, f"{pair.arch} decode logits, step {step}")
    want_cache = lm.leaves(to_numpy(rcache))
    for path, t in lm.leaves(cache).items():
        _close(t, want_cache[path], noise, f"{pair.arch} cache {path}")
