"""MoE in the tensor-parallel body on every layout the reference takes
(``models.tp.moe``): the reference's rule (``repro.models.moe.moe_apply``)
takes expert parallelism only where E % model == 0 and model > 1, and
otherwise its single-rank route, which GSPMD runs over the global token
set (capacity ``B·S·K·cf // E`` of all ``B·S`` tokens, slots in global
token order, aux losses over every token).

Reduced granite-moe-1b-a400m and olmoe-1b-7b (4 experts, top-2) on
stacked (data=2, model=1), (4, 1), (1, 3) and (1, 8) CPU ranks, reduced
jamba on (2, 1) and (1, 8), in float32, at the configs' capacity factor
(2.0: nothing drops) and at 0.5 (tokens drop, so the global capacity is
what is held), each against the flat port without a mesh (the reference's
single-rank route): the ``ShardedTrainStep`` loss and metrics within 1e-5,
every gradient leaf within 1e-4 of its largest magnitude, the
``ShardedPrefill`` logits and cache and two ``ShardedDecode`` steps'
logits within 1e-5; each rank drops the assignments the flat run drops.
Also: which route ``tp.moe`` takes against the reference's rule, the EP
layouts still on ``ep_blocks``, ``lm.forward_train`` in a body that is
not told the global rows (``tp.global_rows``), and, in
subprocesses (``tests/torch_tp_worker.py``), the sharded step on (2, 1)
against the reference's own GSPMD step (``gspmd-moe``) and two gloo
worlds, (2, 1) and (1, 3), bitwise the stacked ranks (``moe``)."""
import contextlib
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.dist.sharding import (
    gather_placed, gather_tree, place, place_tree, tensor_parallel,
)
from repro_torch.launch.steps import ShardedDecode, ShardedPrefill
from repro_torch.models import lm, tp
from repro_torch.models import moe as moe_mod
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import (
    ShardedTrainStep, TrainOptions, make_loss_fn, value_and_grad,
)
from test_torch_tensor_parallel import B, S, config, cpu_mesh, inputs, params_of

WORKER = os.path.join(os.path.dirname(__file__), "torch_tp_worker.py")
SINGLE_RANK = [(2, 1), (4, 1), (1, 3), (1, 8)]
CASES = ([(a, m) for a in ("granite-moe-1b-a400m", "olmoe-1b-7b") for m in SINGLE_RANK]
         + [("jamba-v0.1-52b", m) for m in ((2, 1), (1, 8))])
# None: the config's capacity factor (2.0, nothing drops); 0.5: tokens drop
CAPACITIES = [None, 0.5]


def _ids(case):
    arch, shape = case
    return f"{arch.split('-')[0]}-{shape[0]}x{shape[1]}"


def moe_config(arch, capacity):
    cfg = config(arch)
    if capacity is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=capacity))


@contextlib.contextmanager
def counting_drops():
    """The dropped assignments of every dispatch in scope, a call each (a
    stacked rank calls it once for its own tokens, ``per_rank``)."""
    drops, dispatch = [], moe_mod._dispatch_scatter

    def counted(xt, gate_idx, E, C):
        buf, dest, kept = dispatch(xt, gate_idx, E, C)
        drops.append(int((~kept).sum()))
        return buf, dest, kept

    moe_mod._dispatch_scatter = counted
    try:
        yield drops
    finally:
        moe_mod._dispatch_scatter = dispatch


@pytest.mark.parametrize("capacity", CAPACITIES, ids=lambda c: f"cf{c or 'cfg'}")
@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_train_step_matches_flat(case, capacity):
    arch, shape = case
    cfg, mesh = moe_config(arch, capacity), cpu_mesh(shape)
    params, batch = params_of(cfg), inputs(cfg)
    opts = TrainOptions(remat=True, q_chunk=8)
    (f_loss, f_metrics), f_grads = value_and_grad(make_loss_fn(cfg, opts))(params, batch)
    step = ShardedTrainStep(cfg, opt.OptimizerConfig(), opts, mesh, B)
    placed = place_tree(params, step.state_specs["params"], mesh)
    (loss, metrics), grads = step.value_and_grad(placed, step.place_batch(batch))
    torch.testing.assert_close(loss, f_loss, rtol=0, atol=1e-5)
    assert set(metrics) == set(f_metrics)
    for k, v in f_metrics.items():
        torch.testing.assert_close(metrics[k], v, rtol=0, atol=1e-5, msg=k)
    got = lm.leaves(gather_tree(grads, step.state_specs["params"], mesh))
    for path, want in lm.leaves(f_grads).items():
        err = float((got[path] - want).abs().max()) / max(float(want.abs().max()), 1e-30)
        assert err <= 1e-4, (path, err)


@pytest.mark.parametrize("capacity", CAPACITIES, ids=lambda c: f"cf{c or 'cfg'}")
@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_prefill_and_decode_match_flat(case, capacity):
    arch, shape = case
    cfg, mesh = moe_config(arch, capacity), cpu_mesh(shape)
    params, batch = params_of(cfg), inputs(cfg)
    with counting_drops() as f_drops:
        f_logits, f_cache = lm.forward_prefill(params, cfg, batch["tokens"], q_chunk=8)
    pre = ShardedPrefill(cfg, mesh, B, S, q_chunk=8)
    placed = place_tree(params, pre.param_specs, mesh)
    with counting_drops() as drops:
        logits, cache = pre(placed, {"tokens": place(batch["tokens"], mesh,
                                                     pre.batch_specs["tokens"])})
    # every rank routes all B·S tokens with the global capacity: it drops
    # what the flat run drops, layer by layer
    assert drops == [d for d in f_drops for _ in range(mesh.size)], (drops, f_drops)
    if capacity is not None:
        assert min(f_drops) > 0, f_drops
    torch.testing.assert_close(gather_placed(logits, mesh, pre.logits_spec), f_logits,
                               rtol=1e-5, atol=1e-5)
    got = lm.leaves(gather_tree(cache, pre.cache_specs, mesh))
    for path, want in lm.leaves(f_cache).items():
        torch.testing.assert_close(got[path], want, rtol=1e-5, atol=1e-5, msg=path)
    T = S + 4
    f_cache = lm.grow_cache(cfg, f_cache, T, S)
    dec = ShardedDecode(cfg, mesh, B, T)
    cache = place_tree(f_cache, dec.cache_specs, mesh)
    rng = np.random.default_rng(3)
    for pos in (S, S + 1):
        tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B,)))
        f_logits, f_cache = lm.decode_step(params, cfg, tok, pos, f_cache)
        logits = dec(placed, place(tok, mesh, dec.token_spec), pos, cache)
        torch.testing.assert_close(gather_placed(logits, mesh, dec.logits_spec), f_logits,
                                   rtol=1e-5, atol=1e-5)


MESH_GRID = [(1, 1), (2, 1), (1, 2), (1, 3), (2, 3), (1, 4), (1, 6), (2, 4), (1, 8), (1, 16)]


@pytest.mark.parametrize("shape", MESH_GRID, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("experts", [4, 16, 32, 64])
def test_the_route_is_the_references_rule(experts, shape, monkeypatch):
    """``tp.moe`` takes expert parallelism exactly where the reference's
    ``moe_apply`` does (E % model == 0 and model > 1), else the
    single-rank route; it raises on no layout."""
    cfg = config("granite-moe-1b-a400m")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, num_experts=experts))
    mesh = cpu_mesh(shape)
    taken = []

    def ep_blocks(*args):
        def block(*_):
            taken.append("ep")
            return x, None, None

        return block, block

    def single_rank(*args):
        taken.append("single")
        return x, {}

    monkeypatch.setattr(moe_mod, "ep_blocks", ep_blocks)
    monkeypatch.setattr(tp, "moe_single_rank", single_rank)
    x = torch.zeros(*shape, 1, 2, cfg.d_model)
    with tensor_parallel(mesh):
        tp.moe({"router": None, "wi": None, "wu": None, "wo": None}, x, cfg, torch.float32, mesh,
               shape[0])
    model = shape[1]
    assert taken == ["ep" if experts % model == 0 and model > 1 else "single"]


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_expert_parallel_layouts_keep_ep_blocks(shape, monkeypatch):
    """The EP layouts of the reduced configs (4 experts on a model axis
    of 2 or 4) still run ``ep_blocks`` and never the single-rank route."""
    cfg, mesh = config("granite-moe-1b-a400m"), cpu_mesh(shape)
    params, batch = params_of(cfg), inputs(cfg)
    calls = {"ep": 0, "single": 0}
    ep_blocks, single_rank = moe_mod.ep_blocks, tp.moe_single_rank

    def count_ep(*args):
        calls["ep"] += 1
        return ep_blocks(*args)

    def count_single(*args):
        calls["single"] += 1
        return single_rank(*args)

    monkeypatch.setattr(moe_mod, "ep_blocks", count_ep)
    monkeypatch.setattr(tp, "moe_single_rank", count_single)
    pre = ShardedPrefill(cfg, mesh, B, S, q_chunk=8)
    pre(place_tree(params, pre.param_specs, mesh),
        {"tokens": place(batch["tokens"], mesh, pre.batch_specs["tokens"])})
    assert calls == {"ep": cfg.n_layers, "single": 0}, calls


@pytest.mark.parametrize("shape", [(2, 1), (1, 3)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_lm_forward_train_in_the_body_takes_the_global_rows(shape):
    """``lm.forward_train`` inside a tensor-parallel body, which is not
    told the global rows (``tp.global_rows``), gives the sharded step's
    loss and aux losses bitwise."""
    from repro_torch.dist.sharding import P, enter, leave
    from repro_torch.train.train_step import MOE_LB_WEIGHT, Z_LOSS, _unflatten

    cfg, mesh = moe_config("granite-moe-1b-a400m", 0.5), cpu_mesh(shape)
    params, batch = params_of(cfg), inputs(cfg)
    step = ShardedTrainStep(cfg, opt.OptimizerConfig(), TrainOptions(q_chunk=8), mesh, B)
    placed = place_tree(params, step.state_specs["params"], mesh)
    placed_batch = step.place_batch(batch)
    want, want_metrics = step.loss(placed, placed_batch)
    specs = lm.leaves(step.state_specs["params"])
    with torch.no_grad(), tensor_parallel(mesh):
        body = _unflatten({k: enter(v, mesh, specs[k]) for k, v in lm.leaves(placed).items()})
        tokens = enter(placed_batch["tokens"], mesh, step.mb_specs["tokens"])
        logits, aux = lm.forward_train(body, cfg, tokens, q_chunk=8)
        ce, zl = tp.cross_entropy(cfg, logits, tokens, B, mesh, Z_LOSS)
        aux = {k: leave(v, mesh, P()) for k, v in aux.items()}
        loss = (leave(ce, mesh, P()) + leave(zl, mesh, P()) + MOE_LB_WEIGHT * aux["moe_lb_loss"]
                + aux["moe_z_loss"])
    assert torch.equal(loss, want)
    for k, v in aux.items():
        assert torch.equal(v, want_metrics[k]), k


def test_global_rows_are_the_local_rows_times_the_batch_axes():
    """``tp.global_rows`` (what ``lm.forward_train`` in a body, not told
    the rows, assumes): the local rows times the batch axes' ranks, under
    the single-pod and the multi-pod rules."""
    from repro_torch.dist import Mesh
    from repro_torch.dist.sharding import default_rules

    mesh = cpu_mesh((2, 4))
    with tensor_parallel(mesh):
        assert [tp.global_rows(n, mesh) for n in (1, 2, 3)] == [2, 4, 6]
    pods = Mesh(np.array([torch.device("cpu")] * 12, dtype=object).reshape(3, 2, 2),
                ("pod", "data", "model"))
    with tensor_parallel(pods, default_rules(multi_pod=True)):
        assert tp.global_rows(2, pods) == 12


def _run(scenario, directory, timeout=240):
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, WORKER, scenario, str(directory)],
                          capture_output=True, text=True, timeout=timeout, env=env)
    assert proc.returncode == 0 and "ALL OK" in proc.stdout, (
        f"STDOUT:\n{proc.stdout[-4000:]}\nSTDERR:\n{proc.stderr[-4000:]}"
    )


@pytest.mark.parametrize("scenario", ["moe", "gspmd-moe"])
def test_single_rank_route_over_processes_and_against_the_reference(scenario, tmp_path):
    """``moe``: reduced granite and jamba at capacity factor 0.5 on a
    (2, 1) world of two gloo processes and a (1, 3) world of three, the
    train step's loss, metrics and gradients, the prefill's logits and
    cache and two decode steps bitwise the stacked ranks; ``gspmd-moe``:
    two of the port's stacked (2, 1) steps of reduced granite at capacity
    factor 0.5 against the reference's GSPMD step from the same state (the
    reference's single-rank route), within the bars of ``gspmd``."""
    _run(scenario, tmp_path)
