"""The port's language-model serving engine (``repro_torch.serve.Engine``)
against the reference's (``repro.serve.Engine``): continuous batching is
*transparent* — every request's greedy completion equals its
single-request run, whatever else shares the batch — and equals the
reference engine's completion token for token, in float32 with the
reference's parameters carried across (port of ``tests/test_serve.py``).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from _torch_lm import cfgs, to_numpy
from repro.models import lm as rlm
from repro.serve import Engine as REngine
from repro.serve import EngineConfig as REngineConfig
from repro_torch import api
from repro_torch.interop import params_from_numpy
from repro_torch.models import lm
from repro_torch.serve import Engine, EngineConfig


def _setup(arch, seed=0):
    # fp32 so that greedy argmax is deterministic across batching layouts
    rcfg, cfg = cfgs(arch, dtype="float32")
    rparams = rlm.init_params(jax.random.PRNGKey(seed), rcfg)
    return rcfg, cfg, rparams, params_from_numpy(cfg, to_numpy(rparams), device="cpu")


def _reference_greedy(params, cfg, prompt, n_new, max_len=64):
    """Single-request prefill + sequential decode (no batching), on the port."""
    toks = torch.tensor([prompt], dtype=torch.long)
    logits, cache = lm.forward_prefill(params, cfg, toks, q_chunk=8)
    cache = lm.grow_cache(cfg, cache, max_len, len(prompt))
    out = [int(torch.argmax(logits[0, : cfg.vocab_size]))]
    pos = len(prompt)
    for _ in range(n_new - 1):
        logits, cache = lm.decode_step(params, cfg, torch.tensor([out[-1]]), pos, cache)
        out.append(int(torch.argmax(logits[0, : cfg.vocab_size])))
        pos += 1
    return out


def _run(engine, prompts):
    rids = [engine.add_request(p) for p in prompts]
    done = engine.run()
    assert len(done) == len(prompts)
    by_rid = {r.rid: r.out for r in done}
    return [by_rid[r] for r in rids]


@pytest.mark.parametrize(
    "arch", ["qwen2-7b", "jamba-v0.1-52b", "gemma2-27b", "xlstm-1.3b", "olmoe-1b-7b"]
)
def test_continuous_batching_matches_solo_and_reference(arch):
    rcfg, cfg, rparams, params = _setup(arch)
    rng = np.random.default_rng(1)
    # three distinct lengths: configs other than pure global attention
    # prefill each length exactly (one reference compile per length)
    prompts = [list(rng.integers(0, cfg.vocab_size, size=n)) for n in (5, 11, 3, 11, 5)]
    n_new = 6
    kw = dict(max_slots=2, max_len=64, max_new_tokens=n_new, prefill_buckets=(8, 16))

    solo = [_reference_greedy(params, cfg, p, n_new) for p in prompts]
    got = _run(Engine(params, cfg, EngineConfig(**kw)), prompts)
    want = _run(REngine(rparams, rcfg, REngineConfig(**kw)), prompts)
    for i, (g, s, w) in enumerate(zip(got, solo, want)):
        assert g == s, f"{arch} request {i}: engine {g} != solo greedy {s}"
        assert g == w, f"{arch} request {i}: port engine {g} != reference engine {w}"


def test_slots_are_recycled():
    _, cfg, _, params = _setup("qwen2-7b")
    eng = Engine(params, cfg, EngineConfig(max_slots=2, max_len=64, max_new_tokens=3,
                                           prefill_buckets=(8,)))
    rng = np.random.default_rng(2)
    prompts = [list(rng.integers(0, cfg.vocab_size, size=4)) for _ in range(5)]
    seen = set()
    for p in prompts:
        eng.add_request(p)
    while eng.queue or eng.active:
        eng.step()
        assert len(eng.active) <= 2  # never more slots in flight than the pool
        seen |= {r.slot for r in eng.active.values()}
    assert len(eng.finished) == 5 and seen == {0, 1}
    assert sorted(eng.free) == [0, 1]
    assert all(len(r.out) == 3 and r.done for r in eng.finished)


def test_eos_frees_slot_early():
    _, cfg, _, params = _setup("qwen2-7b")
    rng = np.random.default_rng(3)
    prompt = list(rng.integers(0, cfg.vocab_size, size=4))
    ref = _reference_greedy(params, cfg, prompt, 8)
    eos = ref[2]  # force an early stop at the 3rd generated token
    assert eos not in ref[:2]
    eng = Engine(params, cfg, EngineConfig(max_slots=1, max_len=64, max_new_tokens=8, eos_id=eos,
                                           prefill_buckets=(8,)))
    eng.add_request(prompt)
    done = eng.run()
    assert done[0].out == ref[:3]
    assert eng.free == [0] and not eng.active


def test_cache_stats_count_the_engine_callables():
    """The decode callable is built once per config and the prefill callable
    once per (config, bucket); a second engine over the same config hits."""
    _, cfg, _, params = _setup("qwen2-7b")
    cfg = dataclasses.replace(cfg, name="qwen2-7b-cache-stats")  # a key of its own
    api.clear_cache()
    rng = np.random.default_rng(4)
    ecfg = EngineConfig(max_slots=2, max_len=64, max_new_tokens=2, prefill_buckets=(8, 16))
    eng = Engine(params, cfg, ecfg)
    assert (api.cache_stats().misses, api.cache_stats().hits) == (1, 0)
    for n in (3, 12, 5):  # buckets 8, 16, 8
        eng.add_request(list(rng.integers(0, cfg.vocab_size, size=n)))
    eng.run()
    assert api.cache_stats().misses == 3  # decode, prefill 8, prefill 16
    assert api.cache_stats().hits == 1    # the second bucket-8 prompt
    Engine(params, cfg, ecfg)
    assert (api.cache_stats().misses, api.cache_stats().hits) == (3, 2)


def test_init_params_defaults_to_the_card(monkeypatch):
    """Without a device, init_params (and an engine's cache) asks for the
    card, and raises where there is none rather than run on the CPU."""
    _, cfg = cfgs("qwen2-7b")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.init_cache(cfg, 2, 16)
    params = lm.init_params(cfg, device="cpu")
    assert params["embed"].device.type == "cpu"
    assert Engine(params, cfg, EngineConfig()).cache["slot0"]["k"].device.type == "cpu"


def test_chip_smoke_phase_14_on_the_cpu(capsys):
    """``chip_smoke.lm_phase`` with every config at its reduced size and
    short prompts, on the CPU: every case's checks pass and its lines are
    logged."""
    import sys
    from pathlib import Path

    from repro_torch.configs.base import reduced_config

    root = str(Path(__file__).resolve().parents[1])
    sys.path.insert(0, root)
    try:
        import chip_smoke
    finally:
        sys.path.remove(root)
    chip_smoke.lm_phase(torch.device("cpu"), card="the CPU", cut=reduced_config,
                        prompt_lens=(3, 14), max_len=64, n_new=4, buckets=(8, 16))
    out = capsys.readouterr().out
    assert "phase 14:" in out and "decode tokens/s" in out and "time to first token" in out
    assert out.count("case 2, request") == 6
    assert out.count("case 3, ") == 2 * 9 and out.count("reduced: n_layers") == 9
    assert out.count("case 4, ") == 10
