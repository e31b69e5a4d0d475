"""Tensor and data parallelism of the language models on stacked CPU
ranks (``models.tp``, ``train_step.ShardedTrainStep``,
``launch.steps.ShardedPrefill``/``ShardedDecode``): the ten reduced
configs in float32 on (data=2, model=2) and (1, 4), against the flat
port.

The weights and the state are placed as each rank's block of the
reference's ``param_pspecs``/``state_pspecs`` (``dist.sharding.place``);
the results are gathered back and held against the flat port on the same
seeded inputs: the loss within 1e-5 and every gradient leaf within 1e-4 of
its largest magnitude (xlstm within its measured noise, as the flat
port's own tests hold it), the prefill logits and every cache leaf and
two decode steps' logits within 1e-5.  The MoE configs are held against
the flat port under ``use_mesh`` of the same mesh: its expert-parallel
branch, whose aux losses are data shard 0's, as the sharded step's and
the reference's GSPMD step's are (``tests/torch_tp_worker.py`` holds the
sharded step against the reference's).  Also: the sharded global norm,
the placed leaves' shapes, GQA with 2 KV heads on 4 ranks, mamba's
``[x; z]`` split, the padded vocab's mask on a vocab block, and phase 18
of ``chip_smoke.py`` at reduced sizes."""
import contextlib
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import reduced_config
from repro_torch.configs.registry import ARCHS
from repro_torch.dist import Mesh, use_mesh
from repro_torch.dist import param_specs as pspecs
from repro_torch.dist.sharding import (
    block_shape, default_rules, gather_placed, gather_tree, place, place_tree, placed_shape,
    tensor_parallel,
)
from repro_torch.launch.steps import ShardedDecode, ShardedPrefill
from repro_torch.models import lm, tp
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import (
    ShardedTrainStep, TrainOptions, init_train_state, make_loss_fn, value_and_grad,
)

B, S = 4, 16
MESHES = [(2, 2), (1, 4)]
# the flat port's own rounding noise against the reference is ~1e-4 for
# xlstm (tests/test_torch_train_step.py); the sharded step moves its
# gradients by as much
GRAD_TOL = {"xlstm-1.3b": 1e-3}


def cpu_mesh(shape):
    return Mesh(np.array([torch.device("cpu")] * math.prod(shape), dtype=object).reshape(shape),
                ("data", "model"))


def config(arch):
    return dataclasses.replace(reduced_config(get_config(arch)), dtype="float32")


def inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    n_text = S - (cfg.num_modality_tokens if cfg.modality == "vision" else 0)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, n_text)))}
    if cfg.modality == "vision":
        batch["modality"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.num_modality_tokens, cfg.modality_dim)).astype(np.float32))
    elif cfg.modality == "audio":
        batch["modality"] = torch.from_numpy(
            rng.standard_normal((B, S, cfg.modality_dim)).astype(np.float32))
    return batch


def flat_context(cfg, mesh):
    return use_mesh(mesh) if cfg.moe is not None else contextlib.nullcontext()


def params_of(cfg, seed=1):
    return lm.init_params(cfg, generator=torch.Generator().manual_seed(seed), device="cpu")


def cell_of(params, mesh, block):
    """Supercell 0's ``block`` of slot 0 and its specs (the cells dim
    stripped)."""
    specs = pspecs.param_pspecs(params, default_rules(), mesh)["cells"]["slot0"][block]
    return (lm.tree_map(lambda t: t[0], params["cells"]["slot0"][block]),
            lm.tree_map(lambda s: type(s)(*tuple(s)[1:]), specs))


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_flat(arch, shape):
    cfg, mesh = config(arch), cpu_mesh(shape)
    params, batch = params_of(cfg), inputs(cfg)
    opts = TrainOptions(remat=True, q_chunk=8)
    with flat_context(cfg, mesh):
        (f_loss, f_metrics), f_grads = value_and_grad(make_loss_fn(cfg, opts))(params, batch)
    step = ShardedTrainStep(cfg, opt.OptimizerConfig(), opts, mesh, B)
    placed = place_tree(params, step.state_specs["params"], mesh)
    (loss, metrics), grads = step.value_and_grad(placed, step.place_batch(batch))
    torch.testing.assert_close(loss, f_loss, rtol=0, atol=1e-5)
    for k, v in f_metrics.items():
        torch.testing.assert_close(metrics[k], v, rtol=0, atol=1e-5, msg=k)
    got = gather_tree(grads, step.state_specs["params"], mesh)
    tol = GRAD_TOL.get(arch, 1e-4)
    for path, want in lm.leaves(f_grads).items():
        g = lm.leaves(got)[path]
        err = float((g - want).abs().max()) / max(float(want.abs().max()), 1e-30)
        assert err <= tol, (path, err)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_flat(arch, shape):
    cfg, mesh = config(arch), cpu_mesh(shape)
    params, batch = params_of(cfg), inputs(cfg)
    with flat_context(cfg, mesh):
        f_logits, f_cache = lm.forward_prefill(params, cfg, batch["tokens"], batch.get("modality"),
                                               q_chunk=8)
    pre = ShardedPrefill(cfg, mesh, B, S, q_chunk=8)
    placed = place_tree(params, pre.param_specs, mesh)
    logits, cache = pre(placed, {k: place(v, mesh, pre.batch_specs[k]) for k, v in batch.items()})
    torch.testing.assert_close(gather_placed(logits, mesh, pre.logits_spec), f_logits,
                               rtol=1e-5, atol=1e-5)
    got = lm.leaves(gather_tree(cache, pre.cache_specs, mesh))
    for path, want in lm.leaves(f_cache).items():
        # the mLSTM's C grows to ~1e2: its float32 rounding, relative
        torch.testing.assert_close(got[path], want, rtol=1e-5, atol=1e-4, msg=path)
    T = S + 4
    f_cache = lm.grow_cache(cfg, f_cache, T, S)
    dec = ShardedDecode(cfg, mesh, B, T, memory_len=S if cfg.is_encoder_decoder else 0)
    cache = place_tree(f_cache, dec.cache_specs, mesh)
    rng = np.random.default_rng(3)
    for pos in (S, S + 1):
        tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B,)))
        with flat_context(cfg, mesh):
            f_logits, f_cache = lm.decode_step(params, cfg, tok, pos, f_cache)
        logits = dec(placed, place(tok, mesh, dec.token_spec), pos, cache)
        torch.testing.assert_close(gather_placed(logits, mesh, dec.logits_spec), f_logits,
                                   rtol=1e-5, atol=1e-5)
    got = lm.leaves(gather_tree(cache, dec.cache_specs, mesh))
    for path, want in lm.leaves(f_cache).items():
        # the mLSTM's C grows to ~1e2: its float32 rounding, relative
        torch.testing.assert_close(got[path], want, rtol=1e-5, atol=1e-4, msg=path)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_global_norm_over_blocks_equals_flat(shape):
    cfg, mesh = config("jamba-v0.1-52b"), cpu_mesh(shape)
    g = torch.Generator().manual_seed(4)
    tree = lm.tree_map(lambda t: torch.randn(t.shape, generator=g), params_of(cfg))
    specs = pspecs.param_pspecs(tree, default_rules(), mesh)
    got = opt.global_norm(place_tree(tree, specs, mesh), specs, mesh)
    torch.testing.assert_close(got, opt.global_norm(tree), rtol=1e-6, atol=0)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_placed_leaves_have_their_spec_block_shapes(shape):
    mesh = cpu_mesh(shape)
    for arch in ("qwen2-7b", "jamba-v0.1-52b", "xlstm-1.3b", "granite-moe-1b-a400m"):
        cfg = config(arch)
        state = init_train_state(torch.Generator().manual_seed(0), cfg, device="cpu")
        placed, specs = pspecs.place_state(state, default_rules(), mesh)
        params, p_specs = pspecs.place_params(state["params"], default_rules(), mesh)
        assert p_specs == specs["params"]
        for path, x in lm.leaves(params).items():
            assert torch.equal(x, lm.leaves(placed["params"])[path]), path
        for (path, x), (_, leaf), (_, spec) in zip(opt.paths(placed), opt.paths(state),
                                                   opt.paths(specs)):
            assert tuple(x.shape) == placed_shape(leaf.shape, mesh, spec), path
            L = len(mesh.axis_names)
            if x.ndim:
                assert tuple(x.shape[L:]) == block_shape(leaf.shape, mesh, spec), path
        for path, x in opt.paths(gather_tree(placed, specs, mesh)):
            leaf = state
            for k in path:
                leaf = leaf[k]
            assert torch.equal(x, leaf), path
    # the model axis splits what the reference's specs split: a quarter of
    # qwen2's attention heads, its MLP and its vocab a rank on (1, 4)
    cfg = config("qwen2-7b")
    specs = pspecs.param_pspecs(params_of(cfg), default_rules(), cpu_mesh((1, 4)))
    assert tuple(specs["cells"]["slot0"]["attn"]["wq"]) == (None, None, "model", None)
    assert tuple(specs["cells"]["slot0"]["attn"]["wk"]) == (None, None, None, None)  # 2 KV heads
    assert tuple(specs["embed"]) == ("model", None)


def test_gqa_queries_read_their_groups_kv_head():
    """2 KV heads on model=4: ``wk``/``wv`` whole on every rank (the spec
    drops), each rank's one query head reads KV head ``rank // 2``."""
    cfg = config("qwen2-7b")
    assert (cfg.n_heads, cfg.n_kv_heads) == (4, 2)
    mesh = cpu_mesh((1, 4))
    from repro_torch.dist.sharding import _map_specs, enter, leave
    from repro_torch.models.attention import self_attention

    p, specs = cell_of(params_of(cfg), mesh, "attn")
    g = torch.Generator().manual_seed(5)
    p = lm.tree_map(lambda t: t + torch.randn(t.shape, generator=g), p)  # non-zero biases
    assert tuple(specs["wq"]) == (None, "model", None) and tuple(specs["wk"]) == (None,) * 3
    x = torch.randn(2, 8, cfg.d_model, generator=g)
    want, _ = self_attention(p, x, cfg, kind="attn", dtype=torch.float32, q_chunk=8)

    with tensor_parallel(mesh):
        body = _map_specs(lambda t, s: enter(place(t, mesh, s), mesh, s), p, specs)
        xs = enter(place(x, mesh, (None, None, None)), mesh, (None, None, None))
        y, k, _ = tp.self_attention(body, xs, cfg, "attn", torch.float32, 8, mesh)
        got = leave(y, mesh, (None, None, None))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert k.shape[-2] == 2  # every rank computed both KV heads


def test_mamba_splits_in_proj_by_channel_blocks():
    """Mamba's ``in_proj`` is ``[x; z]``: on model=4 a rank's column block
    is half of one of them, so the product is all-gathered and each rank
    takes its channels of x and of z (32 of a 64-channel head here)."""
    cfg = config("jamba-v0.1-52b")
    from repro_torch.models import mamba as mamba_mod
    from repro_torch.dist.sharding import _map_specs, enter, leave

    g = torch.Generator().manual_seed(6)
    x = torch.randn(2, 8, cfg.d_model, generator=g)
    for shape in MESHES:
        mesh = cpu_mesh(shape)
        p, specs = cell_of(params_of(cfg), mesh, "mamba")
        want, (conv, h) = mamba_mod.mamba_apply(p, x, cfg, torch.float32)
        assert tuple(specs["in_proj"]) == (None, "model")
        with tensor_parallel(mesh):
            body = _map_specs(lambda t, s: enter(place(t, mesh, s), mesh, s), p, specs)
            xs = enter(place(x, mesh, (None, None, None)), mesh, (None, None, None))
            y, (c_loc, h_all) = tp.mamba(body, xs, cfg, torch.float32, mesh)
            got = leave(y, mesh, (None, None, None))
            conv_got = leave(c_loc, mesh, (None, None, "model"))
            h_got = leave(h_all, mesh, (None, None, None, None))
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(conv_got, conv, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(h_got, h, rtol=1e-5, atol=1e-5)


def test_padded_vocab_is_masked_by_global_index_on_a_vocab_block():
    """Vocab 128 padded to 512 on model=4: rank 0's block holds the real
    ids, ranks 1-3 hold padding only, every padded column is -1e9 below
    its product."""
    cfg = config("qwen2-7b")
    mesh = cpu_mesh((1, 4))
    params = params_of(cfg)
    specs = pspecs.param_pspecs(params, default_rules(), mesh)
    x = torch.randn(2, 3, cfg.d_model, generator=torch.Generator().manual_seed(7))
    from repro_torch.dist.sharding import _map_specs, enter, leave

    with tensor_parallel(mesh):
        body = _map_specs(lambda t, s: enter(t, mesh, s), place_tree(params, specs, mesh), specs)
        xs = enter(place(x, mesh, (None, None, None)), mesh, (None, None, None))
        full = leave(tp.logits(body, cfg, xs, torch.float32, mesh), mesh, (None, None, "model"))
    want = lm._logits(params, cfg, x, torch.float32)
    torch.testing.assert_close(full, want, rtol=1e-5, atol=1e-5)
    assert bool((full[..., cfg.vocab_size:] < -1e8).all())
    assert bool((full[..., :cfg.vocab_size] > -1e8).all())


def test_chip_smoke_phase_18_on_the_cpu(capsys):
    """``chip_smoke.tp_phase`` (one card's part, (a)-(c)) with the configs
    at their reduced sizes on the CPU: every check passes and its lines
    are logged."""
    import sys
    from pathlib import Path

    root = str(Path(__file__).resolve().parents[1])
    sys.path.insert(0, root)
    try:
        import chip_smoke
    finally:
        sys.path.remove(root)
    chip_smoke.tp_phase(torch.device("cpu"), card="the CPU", cut=reduced_config, dense_layers=2,
                        moe_layers=2, trainer_layers=1, tokens=(2, 16))
    out = capsys.readouterr().out
    assert "phase 18:" in out and out.count("from flat), every gradient leaf") == 3
    assert "resumed on (2, 2) and on one device" in out


_PHASE18 = """
import sys, torch
sys.path[:0] = [{root!r}, {src!r}]
import chip_smoke
from repro_torch.configs.base import reduced_config

if __name__ == "__main__":
    chip_smoke.tp_phase(torch.device("cpu"), card="the CPU", cut=reduced_config, dense_layers=2,
                        moe_layers=2, trainer_layers=1, tokens=(2, 16), full_layers=4,
                        full_tokens=(2, 32), processes=4)
    print("PHASE 18 OK")
"""


def test_chip_smoke_phase_18_processes_on_the_cpu(tmp_path):
    """``chip_smoke.tp_phase`` with its process part, (d)-(f), over four
    gloo processes at reduced sizes: every block bitwise the stacked
    ranks, the snapshot resumed across layouts, and (f)'s gates (the
    sharded float32 forward within 1e-5 of flat, the planted fault seen
    by that limit, step 1's bf16 loss nearer flat than the fault's); a
    rehearsal of the phase four cards run over NCCL."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = tmp_path / "phase18.py"
    script.write_text(_PHASE18.format(root=root, src=os.path.join(root, "src")))
    env = dict(os.environ, TMPDIR=str(tmp_path))
    proc = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                          timeout=240, env=env)
    assert proc.returncode == 0 and "PHASE 18 OK" in proc.stdout, (
        f"STDOUT:\n{proc.stdout[-4000:]}\nSTDERR:\n{proc.stderr[-4000:]}"
    )
    assert "with the psum dropped" in proc.stdout


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_loss_is_the_train_steps_loss(shape):
    """``ShardedTrainStep.loss`` (the forward alone) gives bitwise the loss
    and metrics that ``value_and_grad`` computes with its gradients."""
    cfg, mesh = config("qwen2-7b"), cpu_mesh(shape)
    step = ShardedTrainStep(cfg, opt.OptimizerConfig(), TrainOptions(remat=True, q_chunk=8), mesh,
                            B)
    placed = place_tree(params_of(cfg), step.state_specs["params"], mesh)
    batch = step.place_batch(inputs(cfg))
    loss, metrics = step.loss(placed, batch)
    (want, want_metrics), _ = step.value_and_grad(placed, batch)
    assert not loss.requires_grad and torch.equal(loss, want)
    for k, v in want_metrics.items():
        assert torch.equal(metrics[k], v), k


def test_trainer_takes_a_device_or_state_shardings(tmp_path):
    """A ``Trainer`` given both a device and ``state_shardings`` refuses:
    the state's mesh names the devices."""
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig, shardings_of

    cfg, mesh = config("qwen2-7b"), cpu_mesh((1, 4))
    step = ShardedTrainStep(cfg, opt.OptimizerConfig(), TrainOptions(q_chunk=8), mesh, B)
    with pytest.raises(ValueError, match="a device or state_shardings, not both"):
        Trainer(step, lambda: None, DataConfig(seq_len=S, global_batch=B,
                                               vocab_size=cfg.vocab_size),
                TrainerConfig(total_steps=1, checkpoint_dir=str(tmp_path)), device="cpu",
                state_shardings=shardings_of(step.state_specs, mesh))


def test_build_step_runs_on_placed_blocks():
    """``build_step``'s train, prefill and decode steps on placed tensors
    (``step.placed`` on ``step.place``'s blocks) of CPU ranks (2, 4):
    their results gathered equal the steps on global tensors within 1e-5
    (train: the cross-entropy; the aux losses are data shard 0's on both)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.steps import build_step

    mesh = cpu_mesh((2, 4))
    gen = torch.Generator().manual_seed(8)
    cfg = config("granite-moe-1b-a400m")
    fn, args, in_specs, _ = build_step(cfg, ShapeConfig("t", 16, 4, "train"), mesh)
    state = init_train_state(torch.Generator().manual_seed(1), cfg, device="cpu")
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 16), generator=gen,
                                     dtype=torch.int32)}
    new, metrics = fn(state, batch)
    p_new, p_metrics = fn.placed(*fn.place(state, batch))
    for k in ("ce", "z_loss", "moe_lb_loss", "moe_z_loss"):
        torch.testing.assert_close(p_metrics[k], metrics[k], rtol=0, atol=1e-5, msg=k)
    got = gather_tree(p_new["params"], in_specs[0]["params"], mesh)
    for path, want in lm.leaves(new["params"]).items():
        torch.testing.assert_close(lm.leaves(got)[path], want, rtol=1e-4, atol=1e-6, msg=path)

    cfg = config("yi-9b")
    params = params_of(cfg)
    fn, args, in_specs, _ = build_step(cfg, ShapeConfig("p", 16, 4, "prefill"), mesh)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 16), generator=gen)}
    logits, _ = fn(params, batch)
    p_logits, _ = fn.placed(*fn.place(params, batch))
    torch.testing.assert_close(gather_placed(p_logits, mesh, fn.placed.logits_spec), logits,
                               rtol=1e-5, atol=1e-5)
    fn, args, in_specs, out_specs = build_step(cfg, ShapeConfig("d", 32, 4, "decode"), mesh)
    cache = lm.tree_map(lambda t: torch.randn(t.shape, generator=gen), args[1]["cache"])
    batch = {"token": torch.randint(0, cfg.vocab_size, (4,), generator=gen),
             "pos": torch.tensor(20), "cache": cache}
    placed = fn.place(params, batch)
    logits, _ = fn(params, dict(batch, cache=lm.tree_map(torch.clone, cache)))
    p_logits, p_cache = fn.placed(*placed)
    dec_spec = (out_specs[0][0], "model")
    torch.testing.assert_close(gather_placed(p_logits, mesh, dec_spec), logits,
                               rtol=2e-5, atol=2e-5)
