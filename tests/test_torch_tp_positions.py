"""One position per row in the tensor-parallel decode
(``launch.steps.ShardedDecode``, ``models.tp.decode_step``) on stacked CPU
ranks, at reduced sizes (2 KV heads, B = 4), in float32.

Each row is prefilled alone at its own length, its cache grown to T and
the rows stacked, so the rows decode at four depths, two of them past
gemma2's local window of 8 (its rolling cache wraps per row).  Held to:

- the flat port's ``lm.decode_step`` with the same ``[B]`` positions
  (itself held to the reference's engine token for token,
  ``tests/test_torch_serve_lm.py``): logits within 1e-5, every cache
  leaf within 1e-5 / 1e-4, for qwen2, gemma2 (local window, softcap),
  jamba (attention among mamba and MoE layers; the flat side under
  ``use_mesh`` of the same mesh, as ``tests/test_torch_tensor_parallel.py``
  holds it) and seamless (cross-attention), under each cache layout that
  ``kv_cache_layout`` picks: (2, 2) ``heads``, (2, 4) ``seq``, (1, 4)
  ``seq_all`` and (4, 1) ``batch``;
- the scalar path bitwise: a ``[B]`` of equal positions gives the logits
  and the cache of the scalar position;
- the reference's ``repro.models.lm.decode_step`` with a ``[B]`` position,
  its parameters carried across by ``interop.params_from_numpy``: within
  the flat decode's bar in ``tests/test_torch_models.py`` (rtol = atol =
  1e-4 plus the measured rounding noise);
- ``build_step("decode")``'s placed step with a ``[B]`` position placed by
  its spec, against the step on global tensors.

The same decode over four gloo processes, bitwise the stacked ranks, is
phase 18 (h) of ``chip_smoke.py``, rehearsed by
``tests/test_torch_tensor_parallel.py``."""
import contextlib
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm import Pair, to_numpy
from repro.models import lm as rlm
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig, reduced_config
from repro_torch.dist import Mesh, use_mesh
from repro_torch.dist.sharding import gather_placed, gather_tree, kv_cache_layout, place, place_tree
from repro_torch.launch.steps import ShardedDecode, build_step
from repro_torch.models import lm

B = 4
# each row's prompt length: rows 1 and 3 past gemma2's local window of 8
LENS = (5, 12, 3, 17)
T = 24
STEPS = 2
MEMORY = 8  # seamless's audio frames a row
ARCHS = ("qwen2-7b", "gemma2-27b", "jamba-v0.1-52b", "seamless-m4t-large-v2")
LAYOUTS = {(2, 2): "heads", (2, 4): "seq", (1, 4): "seq_all", (4, 1): "batch"}


def cpu_mesh(shape):
    return Mesh(np.array([torch.device("cpu")] * math.prod(shape), dtype=object).reshape(shape),
                ("data", "model"))


def config(arch):
    return dataclasses.replace(reduced_config(get_config(arch)), dtype="float32")


def flat_context(cfg, mesh):
    return use_mesh(mesh) if cfg.moe is not None else contextlib.nullcontext()


def rows_prefilled(cfg, params, seed=0):
    """Each row's prompt prefilled alone, its cache grown to ``T``, the rows
    stacked: ``(cache, positions [B], first tokens [B])``."""
    rng = np.random.default_rng(seed)
    caches, first = [], []
    for n in LENS:
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, n)))
        frames = None
        if cfg.is_encoder_decoder:
            frames = torch.from_numpy(
                rng.standard_normal((1, MEMORY, cfg.modality_dim)).astype(np.float32))
        logits, c = lm.forward_prefill(params, cfg, toks, frames, q_chunk=8)
        caches.append(lm.grow_cache(cfg, c, T, n))
        first.append(int(logits[0, :cfg.vocab_size].argmax()))
    cache = {k: {n: torch.cat([c[k][n] for c in caches], dim=1) for n in caches[0][k]}
             for k in caches[0]}
    return cache, torch.tensor(LENS), torch.tensor(first)


@pytest.fixture(scope="module", params=ARCHS)
def prefilled(request):
    cfg = config(request.param)
    params = lm.init_params(cfg, generator=torch.Generator().manual_seed(1), device="cpu")
    return (request.param, cfg, params) + rows_prefilled(cfg, params)


def decoder(cfg, mesh, params, cache):
    dec = ShardedDecode(cfg, mesh, B, T, memory_len=MEMORY if cfg.is_encoder_decoder else 0)
    return dec, place_tree(params, dec.param_specs, mesh), place_tree(cache, dec.cache_specs, mesh)


@pytest.mark.parametrize("shape", list(LAYOUTS), ids=lambda s: f"{s[0]}x{s[1]}")
def test_per_row_decode_matches_flat(prefilled, shape):
    """``STEPS`` decode steps, each row at its own position, the flat run's
    greedy tokens fed to both runs."""
    arch, cfg, params, f_cache, pos, tok = prefilled
    mesh = cpu_mesh(shape)
    assert kv_cache_layout(B, T, cfg.n_kv_heads, mesh) == LAYOUTS[shape]
    f_cache = lm.tree_map(torch.clone, f_cache)
    dec, placed, cache = decoder(cfg, mesh, params, f_cache)
    for step in range(STEPS):
        with flat_context(cfg, mesh):
            f_logits, f_cache = lm.decode_step(params, cfg, tok, pos, f_cache)
        logits = dec(placed, place(tok, mesh, dec.token_spec), pos, cache)
        torch.testing.assert_close(gather_placed(logits, mesh, dec.logits_spec), f_logits,
                                   rtol=1e-5, atol=1e-5, msg=lambda m: f"{arch} step {step}: {m}")
        tok, pos = f_logits[:, :cfg.vocab_size].argmax(-1), pos + 1
    got = lm.leaves(gather_tree(cache, dec.cache_specs, mesh))
    for path, want in lm.leaves(f_cache).items():
        torch.testing.assert_close(got[path], want, rtol=1e-5, atol=1e-4, msg=path)


@pytest.mark.parametrize("shape", list(LAYOUTS), ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ARCHS[:2])
def test_equal_positions_are_the_scalar_path_bitwise(arch, shape):
    """A ``[B]`` of equal positions (past the local window) gives bitwise
    the logits and the cache of the scalar position."""
    cfg, mesh = config(arch), cpu_mesh(shape)
    params = lm.init_params(cfg, generator=torch.Generator().manual_seed(2), device="cpu")
    cache, _, tok = rows_prefilled(cfg, params, seed=3)
    p = max(LENS)
    outs = []
    for pos in (p, torch.tensor(p), torch.full((B,), p)):
        dec, placed, c = decoder(cfg, mesh, params, cache)
        outs.append((dec(placed, place(tok, mesh, dec.token_spec), pos, c), c))
    (want, w_cache), *others = outs
    for logits, c in others:
        assert torch.equal(logits, want)
        for path, t in lm.leaves(c).items():
            assert torch.equal(t, lm.leaves(w_cache)[path]), path


def test_per_row_decode_matches_the_reference():
    """Reduced qwen2-7b prefilled by the reference (B = 4, S = 16), then two
    decode steps with one position a row (``[16, 13, 9, 5]``: each row's
    prefill entries past its position are masked, then overwritten), the
    reference's greedy token fed to both: the sharded decode on each
    layout against the reference's ``decode_step`` on a ``[B]`` position."""
    pair = Pair("qwen2-7b")
    S, T_ = 16, 20
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, pair.cfg.vocab_size, (B, S)).astype(np.int32)
    pos0 = np.array([16, 13, 9, 5], np.int32)
    _, rcache = jax.jit(rlm.forward_prefill, static_argnums=(1,), static_argnames=("q_chunk",))(
        pair.rparams, pair.rcfg, jnp.asarray(tokens), None, q_chunk=8)
    rcache = rlm.grow_cache(pair.rcfg, rcache, T_, S)
    cache0 = lm.tree_map(torch.from_numpy, to_numpy(rcache))
    r_decode = jax.jit(rlm.decode_step, static_argnums=(1,))
    feeds, wants = [rng.integers(0, pair.cfg.vocab_size, (B,)).astype(np.int32)], []
    for step in range(2):
        want, rcache = r_decode(pair.rparams, pair.rcfg, jnp.asarray(feeds[-1]),
                                jnp.asarray(pos0 + step), rcache)
        wants.append(np.asarray(want, np.float32))
        feeds.append(np.asarray(want[:, :pair.cfg.vocab_size]).argmax(-1).astype(np.int32))
    want_cache = lm.leaves(to_numpy(rcache))

    def flat_run(params):
        cache = lm.tree_map(torch.clone, cache0)
        outs = []
        for step in range(2):
            logits, cache = lm.decode_step(params, pair.cfg, torch.from_numpy(feeds[step]).long(),
                                           torch.from_numpy(pos0 + step), cache)
            outs.append(logits)
        return outs

    noise = pair.noise(flat_run)
    tol = dict(rtol=1e-4, atol=1e-4 + noise)
    for shape, layout in LAYOUTS.items():
        mesh = cpu_mesh(shape)
        assert kv_cache_layout(B, T_, pair.cfg.n_kv_heads, mesh) == layout
        dec = ShardedDecode(pair.cfg, mesh, B, T_)
        placed = place_tree(pair.params, dec.param_specs, mesh)
        cache = place_tree(lm.tree_map(torch.clone, cache0), dec.cache_specs, mesh)
        for step in range(2):
            tok = place(torch.from_numpy(feeds[step]).long(), mesh, dec.token_spec)
            logits = dec(placed, tok, torch.from_numpy(pos0 + step), cache)
            torch.testing.assert_close(gather_placed(logits, mesh, dec.logits_spec),
                                       torch.from_numpy(wants[step]), **tol,
                                       msg=lambda m: f"{layout} step {step}: {m}")
        for path, t in lm.leaves(gather_tree(cache, dec.cache_specs, mesh)).items():
            torch.testing.assert_close(t, torch.from_numpy(np.asarray(want_cache[path])), **tol,
                                       msg=lambda m: f"{layout} cache {path}: {m}")


def test_build_step_decode_takes_a_position_per_row():
    """``build_step("decode")``'s placed step on (2, 4) CPU ranks with a
    ``[B]`` position placed by its spec (``P()``: size-1 mesh dims in
    front), and with the global ``[B]`` tensor: the logits and the cache
    gathered equal the step on global tensors within 2e-5; a position
    tensor of another length is refused."""
    mesh = cpu_mesh((2, 4))
    cfg = config("yi-9b")
    gen = torch.Generator().manual_seed(8)
    params = lm.init_params(cfg, generator=torch.Generator().manual_seed(1), device="cpu")
    fn, args, in_specs, out_specs = build_step(cfg, ShapeConfig("d", 32, B, "decode"), mesh)
    cache = lm.tree_map(lambda t: torch.randn(t.shape, generator=gen), args[1]["cache"])
    batch = {"token": torch.randint(0, cfg.vocab_size, (B,), generator=gen),
             "pos": torch.tensor([20, 3, 31, 9]), "cache": cache}
    logits, f_cache = fn(params, dict(batch, cache=lm.tree_map(torch.clone, cache)))
    dec_spec = (out_specs[0][0], "model")
    p_params, p_batch = fn.place(params, batch)
    assert tuple(p_batch["pos"].shape) == (1, 1, B)
    for pos in (p_batch["pos"], batch["pos"]):
        p_cache = place_tree(cache, in_specs[1]["cache"], mesh)
        p_logits, p_cache = fn.placed(p_params, dict(p_batch, pos=pos, cache=p_cache))
        torch.testing.assert_close(gather_placed(p_logits, mesh, dec_spec), logits,
                                   rtol=2e-5, atol=2e-5)
        got = lm.leaves(gather_tree(p_cache, in_specs[1]["cache"], mesh))
        for path, want in lm.leaves(f_cache).items():
            torch.testing.assert_close(got[path], want, rtol=2e-5, atol=2e-5, msg=path)
    with pytest.raises(ValueError, match="one per row"):
        fn.placed(p_params, dict(p_batch, pos=torch.tensor([1, 2])))
