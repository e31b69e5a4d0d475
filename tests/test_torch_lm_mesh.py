"""Language-model decode and forward passes under a mesh of CPU ranks
(``repro_torch.dist.use_mesh``), against the flat pass and the
reference's single device.

The ranks of a ``Mesh`` whose devices are all the CPU share it, as ranks
on one card do.  Reduced yi-9b with 2 KV heads on a (data=2, model=4)
mesh takes the sequence-sharded layouts (``"seq"`` for B=4, ``"seq_all"``
for B=1), as ``tests/lm_dist_worker.py`` does for the reference: the
distributed flash-decode agrees with the reference's single-device decode
and the port's flat decode within 2e-5.  The ``"heads"`` and ``"batch"``
layouts compute as the flat path does, bitwise, and ``shard`` changes no
value: a prefill and a train forward of a dense model under the mesh are
the flat ones, bitwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm import cfgs, to_numpy
from repro.models import lm as rlm
from repro_torch.dist import Mesh, kv_cache_layout, use_mesh
from repro_torch.dist.sharding import recording
from repro_torch.interop import params_from_numpy
from repro_torch.models import lm

MESH = Mesh(np.array([torch.device("cpu")] * 8, dtype=object).reshape(2, 4), ("data", "model"))


def _setup(seed, B, T, **kw):
    rcfg, cfg = cfgs("yi-9b", dtype="float32", n_layers=2, **kw)
    rparams = rlm.init_params(jax.random.PRNGKey(seed), rcfg)
    params = params_from_numpy(cfg, to_numpy(rparams), device="cpu")
    rng = np.random.default_rng(seed)
    cache = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in lm.leaves(lm.init_cache(cfg, B, T, device="meta")).items()}
    tok = rng.integers(0, cfg.vocab_size, B).astype(np.int32)
    return rcfg, cfg, rparams, params, cache, tok


def _tree(flat: dict):
    out: dict = {}
    for path, v in flat.items():
        *head, last = path.split(".")
        d = out
        for k in head:
            d = d.setdefault(k, {})
        d[last] = v
    return out


def _port_cache(cache):
    return _tree({k: torch.from_numpy(v.copy()) for k, v in cache.items()})


def _decode(cfg, params, cache, tok, pos, mesh=None):
    c = _port_cache(cache)
    if mesh is None:
        return lm.decode_step(params, cfg, torch.from_numpy(tok).long(), pos, c)
    with use_mesh(mesh):
        return lm.decode_step(params, cfg, torch.from_numpy(tok).long(), pos, c)


@pytest.mark.parametrize("B,T,pos,layout", [(4, 32, 20, "seq"), (1, 64, 50, "seq_all")])
def test_sequence_sharded_decode_matches_reference_and_flat(B, T, pos, layout):
    rcfg, cfg, rparams, params, cache, tok = _setup(0 if layout == "seq" else 1, B, T,
                                                    n_kv_heads=2)
    assert kv_cache_layout(B, T, cfg.n_kv_heads, MESH) == layout
    rlogits, rcache = rlm.decode_step(rparams, rcfg, jnp.asarray(tok), jnp.int32(pos),
                                      _tree({k: jnp.asarray(v) for k, v in cache.items()}))
    flat_logits, flat_cache = _decode(cfg, params, cache, tok, pos)
    logits, new_cache = _decode(cfg, params, cache, tok, pos, MESH)
    want = torch.from_numpy(np.array(rlogits))
    torch.testing.assert_close(logits, want, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(logits, flat_logits, rtol=2e-5, atol=2e-5)
    rleaves = lm.leaves(to_numpy(rcache))
    for k, v in lm.leaves(new_cache).items():
        torch.testing.assert_close(v, torch.from_numpy(np.array(rleaves[k])), rtol=2e-5,
                                   atol=2e-5, msg=lambda m, k=k: f"cache {k}: {m}")
        torch.testing.assert_close(v, lm.leaves(flat_cache)[k], rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("B,T,kh,layout", [(4, 32, 4, "heads"), (4, 30, 2, "batch")])
def test_heads_and_batch_layouts_equal_flat_bitwise(B, T, kh, layout):
    _, cfg, _, params, cache, tok = _setup(2, B, T, n_kv_heads=kh)
    assert kv_cache_layout(B, T, kh, MESH) == layout
    flat_logits, flat_cache = _decode(cfg, params, cache, tok, 17)
    with recording() as log:
        logits, new_cache = _decode(cfg, params, cache, tok, 17, MESH)
    assert torch.equal(logits, flat_logits)
    for k, v in lm.leaves(new_cache).items():
        assert torch.equal(v, lm.leaves(flat_cache)[k]), k
    # the cache constraint of the layout was recorded for every layer
    assert sum(1 for shape, _ in log if shape == (B, T, kh, cfg.head_dim_)) == 2 * cfg.n_layers


def test_decode_writes_the_cache_in_place_without_a_copy():
    _, cfg, _, params, cache, tok = _setup(3, 4, 32, n_kv_heads=2)
    c = _port_cache(cache)
    ptrs = {k: v.data_ptr() for k, v in lm.leaves(c).items()}
    with use_mesh(MESH):
        _, out = lm.decode_step(params, cfg, torch.from_numpy(tok).long(), 5, c)
    assert {k: v.data_ptr() for k, v in lm.leaves(out).items()} == ptrs


def test_shard_changes_no_value_in_prefill_and_train():
    rcfg, cfg = cfgs("qwen2-7b", dtype="float32")
    params = params_from_numpy(cfg, to_numpy(rlm.init_params(jax.random.PRNGKey(4), rcfg)),
                               device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab_size, (4, 16)))
    flat = lm.forward_prefill(params, cfg, tokens, q_chunk=8)
    flat_train = lm.forward_train(params, cfg, tokens, remat=False, q_chunk=8)
    with use_mesh(MESH), recording() as log:
        got = lm.forward_prefill(params, cfg, tokens, q_chunk=8)
        got_train = lm.forward_train(params, cfg, tokens, remat=False, q_chunk=8)
    assert torch.equal(got[0], flat[0]) and torch.equal(got_train[0], flat_train[0])
    for k, v in lm.leaves(got[1]).items():
        assert torch.equal(v, lm.leaves(flat[1])[k]), k
    assert len(log) > 0


def test_granite_prefill_under_expert_parallelism_matches_flat():
    rcfg, cfg = cfgs("granite-moe-1b-a400m", dtype="float32")
    params = params_from_numpy(cfg, to_numpy(rlm.init_params(jax.random.PRNGKey(5), rcfg)),
                               device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab_size, (4, 16)))
    flat_logits, _ = lm.forward_prefill(params, cfg, tokens, q_chunk=8)
    with use_mesh(MESH):
        logits, _ = lm.forward_prefill(params, cfg, tokens, q_chunk=8)
    torch.testing.assert_close(logits, flat_logits, rtol=1e-5, atol=1e-5)


def test_chip_smoke_phase_16_on_the_cpu(capsys):
    """``chip_smoke.lm_mesh_phase`` with the configs at their reduced sizes
    and every shape cut, on the CPU: every case's checks pass and its
    lines are logged."""
    import sys
    from pathlib import Path

    from repro_torch.configs.base import reduced_config

    root = str(Path(__file__).resolve().parents[1])
    sys.path.insert(0, root)
    try:
        import chip_smoke
    finally:
        sys.path.remove(root)
    chip_smoke.lm_mesh_phase(torch.device("cpu"), card="the CPU", cut=reduced_config,
                             layers=(2, 2, 2), decode=(4, 64), long=(1, 128), prefill=(4, 16),
                             small_decode=(2, 32), conv=(64, 16), window=(64, 8, 4))
    out = capsys.readouterr().out
    assert "phase 16:" in out and "layout seq (" in out and "layout seq_all (" in out
    assert "ep_block;" in out and "ep_block_small;" in out
    assert out.count("case 4 ") == 2 and "ValueError" in out
