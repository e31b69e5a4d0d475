"""The port's optimizer, gradient compression and data pipeline
(``repro_torch.train.optimizer``, ``repro_torch.dist.compression``,
``repro_torch.data.pipeline``) against the reference's, on the CPU, with
inputs made from seeds with numpy; and the cases of
``tests/test_substrate.py`` on the port.

- the schedule, the global norm and clip, and ``adamw_update`` fed the same
  gradients for three steps agree within rtol = atol = 1e-6 (both compute
  in float32; XLA may contract a multiply-add);
- ``_decay_mask`` gives the reference's answer on every leaf path of the
  ten reduced configs;
- ``int8_roundtrip`` and ``topk_sparsify`` are bitwise the reference's,
  ties at the top-k threshold included;
- batches (synthetic, from a token file, with modality inputs) are bitwise
  the reference's, and ``PrefetchLoader`` yields steps in order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, strategies as st

from repro.configs import get_config as rget_config
from repro.configs.base import reduced_config as rreduced
from repro.data import pipeline as rpipe
from repro.dist import compression as rcomp
from repro.models import lm as rlm
from repro.train import optimizer as ropt
from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.base import reduced_config
from repro_torch.data.pipeline import DataConfig, PrefetchLoader, make_source
from repro_torch.dist.compression import int8_roundtrip, topk_sparsify
from repro_torch.models import lm
from repro_torch.train import optimizer as opt

TOL = dict(rtol=1e-6, atol=1e-6)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, what=""):
    torch.testing.assert_close(got, _t(want), **TOL, msg=lambda m: f"{what}: {m}")


# -------------------------------------------------------------------------
# optimizer against the reference
# -------------------------------------------------------------------------


def test_schedule_matches_reference():
    for kw in (dict(), dict(peak_lr=1e-3, warmup_steps=100, decay_steps=1000),
               dict(warmup_steps=0, decay_steps=1), dict(min_lr_ratio=0.0, warmup_steps=3)):
        rcfg, cfg = ropt.OptimizerConfig(**kw), opt.OptimizerConfig(**kw)
        for step in (0, 1, 2, 3, 50, 99, 100, 101, 999, 5000, 9999, 10_000, 20_000):
            want = ropt.schedule(rcfg, jnp.int32(step))
            got = opt.schedule(cfg, torch.tensor(step, dtype=torch.int32))
            assert got.dtype == torch.float32
            torch.testing.assert_close(got, _t(want), rtol=1e-6, atol=0)


def _grads_like(params, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(v.shape) * scale).astype(np.float32)
            for k, v in lm.leaves(params).items()}


def _nest(flat: dict) -> dict:
    out: dict = {}
    for path, v in flat.items():
        *parents, name = path.split(".")
        node = out
        for k in parents:
            node = node.setdefault(k, {})
        node[name] = v
    return out


@pytest.mark.parametrize("scale", [1e-3, 10.0], ids=["unclipped", "clipped"])
def test_adamw_update_matches_reference(scale):
    """Three AdamW steps on granite-moe's reduced parameters (every kind of
    leaf path), fed the same seeded gradients on both sides."""
    rcfg = rreduced(rget_config("granite-moe-1b-a400m"))
    rparams = rlm.init_params(jax.random.PRNGKey(0), rcfg)
    params = lm.tree_map(torch.from_numpy, jax.tree.map(np.array, rparams))
    ocfg = dict(peak_lr=1e-2, warmup_steps=1, decay_steps=4)
    rstate, state = ropt.init_opt_state(rparams), opt.init_opt_state(params)
    for step in range(3):
        g = _nest(_grads_like(params, step, scale))
        rparams, rstate, rm = ropt.adamw_update(ropt.OptimizerConfig(**ocfg),
                                                jax.tree.map(jnp.asarray, g), rstate, rparams)
        params, state, m = opt.adamw_update(opt.OptimizerConfig(**ocfg),
                                            lm.tree_map(torch.from_numpy, g), state, params)
        assert (float(rm["grad_norm"]) > 1.0) == (scale > 1)
        for k in ("grad_norm", "lr"):
            _close(m[k], rm[k], k)
        assert int(state["count"]) == int(rstate["count"]) == step + 1
        assert state["count"].dtype == torch.int32
        for name, got, want in (("params", params, rparams), ("m", state["m"], rstate["m"]),
                                ("v", state["v"], rstate["v"])):
            want = lm.leaves(jax.tree.map(np.array, want))
            got = lm.leaves(got)
            assert sorted(got) == sorted(want)
            for k in got:
                _close(got[k], want[k], f"step {step} {name} {k}")


def test_global_norm_matches_reference():
    rng = np.random.default_rng(1)
    tree = {"a": rng.standard_normal((7, 5)).astype(np.float32),
            "b": {"c": (rng.standard_normal(11) * 100).astype(np.float32)}}
    want = ropt.global_norm(jax.tree.map(jnp.asarray, tree))
    got = opt.global_norm(lm.tree_map(torch.from_numpy, tree))
    _close(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_decay_mask_matches_reference_on_every_leaf(arch):
    rcfg = rreduced(rget_config(arch))
    shapes = jax.eval_shape(lambda: rlm.init_params(jax.random.PRNGKey(0), rcfg))
    want = {".".join(str(k.key) for k in path): ropt._decay_mask(path)
            for path, _ in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    got = {".".join(path): opt._decay_mask(path)
           for path, _ in opt.paths(lm.init_params(reduced_config(get_config(arch)), device="meta"))}
    assert got == want
    assert True in got.values() and False in got.values()


def test_paths_follow_the_reference_flatten_order():
    rcfg = rreduced(rget_config("jamba-v0.1-52b"))
    shapes = jax.eval_shape(lambda: rlm.init_params(jax.random.PRNGKey(0), rcfg))
    want = [tuple(str(k.key) for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(shapes)[0]]
    got = [path for path, _ in opt.paths(
        lm.init_params(reduced_config(get_config("jamba-v0.1-52b")), device="meta"))]
    assert got == want


# -------------------------------------------------------------------------
# tests/test_substrate.py's optimizer cases, on the port
# -------------------------------------------------------------------------


def test_adamw_minimizes_quadratic():
    cfg = opt.OptimizerConfig(peak_lr=0.1, warmup_steps=0, weight_decay=0.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = opt.init_opt_state(params)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}  # d/dw |w|²
        params, state, _ = opt.adamw_update(cfg, grads, state, params)
    assert float(params["w"].abs().max()) < 1e-2


def test_grad_clip_bounds_update():
    cfg = opt.OptimizerConfig(peak_lr=1.0, warmup_steps=0, grad_clip_norm=1.0)
    params = {"w": torch.zeros(4)}
    state = opt.init_opt_state(params)
    huge = {"w": torch.full((4,), 1e6)}
    new, new_state, metrics = opt.adamw_update(cfg, huge, state, params)
    assert float(metrics["grad_norm"]) > 1.0  # pre-clip norm reported
    # the update is functional: nothing it was given changed
    assert torch.equal(params["w"], torch.zeros(4)) and int(state["count"]) == 0
    assert torch.equal(huge["w"], torch.full((4,), 1e6))
    # clipped m is the unit-norm gradient's share
    torch.testing.assert_close(new_state["m"]["w"], torch.full((4,), 0.1 * 0.5))


def test_schedule_warmup_and_decay():
    cfg = opt.OptimizerConfig(peak_lr=1e-3, warmup_steps=100, decay_steps=1000)
    lr0 = float(opt.schedule(cfg, 0))
    lr_peak = float(opt.schedule(cfg, 100))
    lr_end = float(opt.schedule(cfg, 999))
    assert lr0 < lr_peak
    assert abs(lr_peak - 1e-3) / 1e-3 < 0.05
    assert lr_end < lr_peak
    assert lr_end >= cfg.peak_lr * cfg.min_lr_ratio * 0.9


def test_weight_decay_skips_norms_and_biases():
    assert opt._decay_mask(("cells", "slot0", "attn", "wq")) is True
    assert opt._decay_mask(("cells", "slot0", "norm_mixer")) is False


# -------------------------------------------------------------------------
# gradient compression: bitwise against the reference
# -------------------------------------------------------------------------


def _compression_tree(seed):
    rng = np.random.default_rng(seed)
    return {
        "w": (rng.standard_normal((32, 16)) * 10 ** rng.uniform(-3, 3)).astype(np.float32),
        "ties": rng.integers(-3, 4, size=(9, 13)).astype(np.float32),  # ties at every level
        "sparse": np.where(rng.random(200) < 0.05, rng.standard_normal(200), 0).astype(np.float32),
        "zero": np.zeros((4, 4), np.float32),
        "halves": np.append(np.arange(-20, 21) / 2.0, 127.0).astype(np.float32),  # scale 1: x on .5
        "scalar": np.array(3.0, np.float32),
        "ids": np.arange(6, dtype=np.int32),
    }


def _same_tree(got, want):
    want = jax.tree.map(np.array, want)
    for k, g in got.items():
        w = want[k]
        assert g.dtype == getattr(torch, str(w.dtype)) and tuple(g.shape) == w.shape, k
        assert torch.equal(g, torch.from_numpy(np.array(w))), k


@pytest.mark.parametrize("seed", range(4))
def test_int8_roundtrip_is_the_reference_bitwise(seed):
    tree = _compression_tree(seed)
    _same_tree(int8_roundtrip(lm.tree_map(torch.from_numpy, tree)),
               rcomp.int8_roundtrip(jax.tree.map(jnp.asarray, tree)))


@pytest.mark.parametrize("keep", [0.01, 0.1, 0.37, 0.5, 1.0])
def test_topk_sparsify_is_the_reference_bitwise(keep):
    for seed in range(3):
        tree = _compression_tree(seed)
        _same_tree(topk_sparsify(lm.tree_map(torch.from_numpy, tree), keep_fraction=keep),
                   rcomp.topk_sparsify(jax.tree.map(jnp.asarray, tree), keep_fraction=keep))


def test_topk_keeps_exactly_k_with_ties_in_index_order():
    x = torch.tensor([1.0, 3.0, 2.0, 3.0, 3.0, 0.0, 3.0])
    y = topk_sparsify({"g": x}, keep_fraction=3 / 7)["g"]
    assert y.tolist() == [0.0, 3.0, 0.0, 3.0, 3.0, 0.0, 0.0]


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 2**16), scale=st.floats(1e-3, 1e3))
def test_int8_roundtrip_error_bounded(seed, scale):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.standard_normal((32, 16)) * scale).astype(np.float32))
    y = int8_roundtrip({"g": x})["g"]
    err = float((y - x).abs().max())
    assert err <= float(x.abs().max()) / 127 * 1.01 + 1e-9


def test_topk_sparsify_keeps_largest():
    x = torch.arange(100, dtype=torch.float32)
    y = topk_sparsify({"g": x}, keep_fraction=0.1)["g"]
    assert int((y != 0).sum()) == 10
    assert float(y[-1]) == 99.0 and float(y[0]) == 0.0


# -------------------------------------------------------------------------
# data pipeline: bitwise against the reference
# -------------------------------------------------------------------------


def _both(**kw):
    return make_source(DataConfig(**kw)), rpipe.make_source(rpipe.DataConfig(**kw))


def _same_batch(got, want):
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("kw", [
    dict(seq_len=16, global_batch=4, vocab_size=100, seed=1),
    dict(seq_len=16, global_batch=2, vocab_size=50, modality_tokens=4, modality_dim=8),
    dict(seq_len=12, global_batch=3, vocab_size=7, seed=5, modality_dim=6, modality_is_frames=True),
], ids=["text", "vision", "audio_frames"])
def test_synthetic_batches_are_the_reference_bitwise(kw):
    port, ref = _both(**kw)
    for step in (0, 1, 7, 1000):
        _same_batch(port.batch_at(step), ref.batch_at(step))


def test_file_tokens_are_the_reference_bitwise(tmp_path):
    path = str(tmp_path / "toks.bin")
    np.random.default_rng(0).integers(0, 1 << 20, size=333, dtype=np.uint32).tofile(path)
    port, ref = _both(seq_len=16, global_batch=3, vocab_size=1000, path=path)
    assert port.windows == ref.windows == 20
    for step in (0, 1, 6, 7, 50):
        _same_batch(port.batch_at(step), ref.batch_at(step))


def test_synthetic_batches_deterministic():
    cfg = DataConfig(seq_len=16, global_batch=4, vocab_size=100, seed=1)
    src = make_source(cfg)
    b1, b2 = src.batch_at(3), src.batch_at(3)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    b3 = src.batch_at(4)
    assert not np.array_equal(b1["tokens"], b3["tokens"])
    assert b1["tokens"].shape == (4, 16)
    assert b1["tokens"].min() >= 0 and b1["tokens"].max() < 100


def test_file_tokens_windows(tmp_path):
    path = str(tmp_path / "toks.bin")
    np.arange(160, dtype=np.uint32).tofile(path)
    src = make_source(DataConfig(seq_len=16, global_batch=2, vocab_size=1 << 20, path=path))
    b = src.batch_at(0)
    np.testing.assert_array_equal(b["tokens"][0], np.arange(16))
    np.testing.assert_array_equal(b["tokens"][1], np.arange(16, 32))
    assert src.batch_at(5)["tokens"].shape == (2, 16)  # wraps around at the end of the file


def test_prefetch_loader_orders_steps():
    cfg = DataConfig(seq_len=8, global_batch=2, vocab_size=50)
    loader = PrefetchLoader(make_source(cfg), start_step=10, depth=2)
    it = iter(loader)
    got = [next(it) for _ in range(4)]
    loader.stop()
    assert [s for s, _ in got] == [10, 11, 12, 13]
    ref = rpipe.make_source(rpipe.DataConfig(seq_len=8, global_batch=2, vocab_size=50))
    for s, b in got:
        _same_batch(b, ref.batch_at(s))


def test_modality_batches():
    cfg = DataConfig(seq_len=16, global_batch=2, vocab_size=50, modality_tokens=4, modality_dim=8)
    b = make_source(cfg).batch_at(0)
    assert b["tokens"].shape == (2, 12)  # text shortened by vision tokens
    assert b["modality"].shape == (2, 4, 8)
