"""The sharded train step's microbatches and int8 gradient compression
(``train_step.ShardedTrainStep`` with ``TrainOptions(microbatches=n,
grad_compression="int8")``).

On stacked CPU ranks, (data=2, model=2) and (1, 4), reduced qwen2-7b,
granite-moe-1b-a400m, jamba-v0.1-52b and xlstm-1.3b in float32 against
the flat port's microbatched loss and gradients with the same options
(the MoE configs under ``use_mesh`` of the same mesh, as
``tests/test_torch_tensor_parallel.py`` holds them): the loss and every
metric within 1e-5, every gradient leaf before compression within 1e-4
of its largest magnitude (xlstm 5e-3: the flat port's own gradients move
by more than 1e-3 when its parameters move by one ulp); after int8
compression every element within one quantization step (``max|g| /
127`` of the flat leaf, plus the difference of the two leaves' maxima,
which moves every quantized value with the scale, and the dequantized
values' float32 rounding) of the flat quantization, and equal to it where the gradients before compression are
equal and so is the leaf's scale.  A granite case shows the microbatch is global rows:
each data rank's rows split ``n`` ways would change the MoE aux loss.
The dry run counts the microbatches' FLOPs and the int8 pmax.  Over 4
gloo processes (``tests/torch_mb_worker.py train``) every block is
bitwise the stacked ranks'; and two steps of the stacked (2, 4) step
against the reference's GSPMD step with the same options (``gspmd``: 8
virtual XLA devices): the metrics within 1e-5, the gradients before
compression within 1e-4 of each leaf's max, the compressed gradients the
reference's int8 codes, and the new state within 1e-6 of the reference's
``adamw_update`` of the port's own compressed gradients (the worker's
docstring states each rule).  The file runs with one intra-op thread.
"""
import contextlib
import dataclasses
import functools
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig, reduced_config
from repro_torch.dist import Mesh, use_mesh
from repro_torch.dist.compression import int8_roundtrip
from repro_torch.dist.sharding import counting_collectives, gather_tree, place_tree
from repro_torch.launch.steps import build_step
from repro_torch.models import lm
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import (
    ShardedTrainStep, TrainOptions, make_loss_fn, value_and_grad,
)

WORKER = os.path.join(os.path.dirname(__file__), "torch_mb_worker.py")
B, S = 8, 16
ARCHS = ["qwen2-7b", "granite-moe-1b-a400m", "jamba-v0.1-52b", "xlstm-1.3b"]
MESHES = [(2, 2), (1, 4)]
OPTIONS = {"mb2": (2, None), "mb4": (4, None), "int8": (1, "int8"), "mb2-int8": (2, "int8")}
# xlstm: the reduced model's gradients are ill-conditioned: the flat port
# against itself with every parameter moved by at most one ulp differs by
# more than 1e-3 of a leaf's largest magnitude on this file's batch
# (test_xlstm_gradients_move_under_one_ulp), and the sharded step, whose
# psums round otherwise, reads as far from flat
GRAD_TOL = {"xlstm-1.3b": 5e-3}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the tensors are small, and several test
    processes share the machine's cores (a thread pool a process spins and
    waits far longer than it computes)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def cpu_mesh(shape):
    return Mesh(np.array([torch.device("cpu")] * math.prod(shape), dtype=object).reshape(shape),
                ("data", "model"))


def config(arch):
    return dataclasses.replace(reduced_config(get_config(arch)), dtype="float32")


def tokens_of(cfg, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)))


def flat_context(cfg, mesh):
    return use_mesh(mesh) if cfg.moe is not None else contextlib.nullcontext()


@functools.lru_cache(maxsize=None)
def flat_case(arch, shape, n):
    """The flat microbatched step's loss, metrics and gradients (before
    compression) of ``arch``'s parameters on this file's batch; shared by
    the option sets with the same microbatches (compression comes after)."""
    cfg = config(arch)
    opts = TrainOptions(remat=True, q_chunk=8, microbatches=n)
    params = lm.init_params(cfg, generator=torch.Generator().manual_seed(1), device="cpu")
    with flat_context(cfg, cpu_mesh(shape)):
        return flat_microbatched(cfg, opts, params, {"tokens": tokens_of(cfg)})


def flat_microbatched(cfg, opts, params, batch):
    """``make_train_step``'s microbatch loop (before compression): the
    loss and metrics averaged, ``g / n`` accumulated in order."""
    grad_fn = value_and_grad(make_loss_fn(cfg, opts))
    n = opts.microbatches
    acc, losses, metricses = None, [], []
    for i in range(n):
        mb = {k: x.reshape((n, x.shape[0] // n) + tuple(x.shape[1:]))[i] for k, x in batch.items()}
        (loss, metrics), grads = grad_fn(params, mb)
        acc = lm.tree_map(torch.zeros_like, grads) if acc is None else acc
        acc = lm.tree_map(lambda a, g: a.add_(g / n), acc, grads)
        losses.append(loss)
        metricses.append(metrics)
    metrics = {k: torch.stack([m[k] for m in metricses]).mean() for k in metricses[0]}
    return torch.stack(losses).mean(), metrics, acc


def check_compressed(got_c, want_c, got, want, path):
    """One quantization step of the flat leaf at every element, plus the
    difference of the two leaves' maxima (a value of ``q`` steps moves by
    ``q / 127`` of it when the scale moves, ``|q| <= 127``) and the
    float32 rounding of the two dequantized values (each at most the
    leaf's max, so within ``max * 2**-24`` of exact); equal where the
    uncompressed gradients and the scales are."""
    m_got, m_want = float(got.abs().max()), float(want.abs().max())
    step = m_want / 127.0
    d = float((got_c - want_c).abs().max())
    bound = step + abs(m_got - m_want) + m_want * 2.0**-23
    assert d <= bound, (path, d, step, m_got - m_want)
    if m_got == m_want:
        same = got == want
        assert torch.equal(got_c[same], want_c[same]), path


@pytest.mark.parametrize("option", list(OPTIONS))
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_matches_the_flat_microbatched_step(arch, shape, option):
    n, comp = OPTIONS[option]
    cfg, mesh = config(arch), cpu_mesh(shape)
    opts = TrainOptions(remat=True, q_chunk=8, microbatches=n, grad_compression=comp)
    params = lm.init_params(cfg, generator=torch.Generator().manual_seed(1), device="cpu")
    batch = {"tokens": tokens_of(cfg)}
    f_loss, f_metrics, f_grads = flat_case(arch, shape, n)
    step = ShardedTrainStep(cfg, opt.OptimizerConfig(), opts, mesh, B)
    placed = place_tree(params, step.state_specs["params"], mesh)
    (loss, metrics), grads = step.value_and_grad(placed, step.place_batch(batch))
    torch.testing.assert_close(loss, f_loss, rtol=0, atol=1e-5)
    for k, v in f_metrics.items():
        torch.testing.assert_close(metrics[k], v, rtol=0, atol=1e-5, msg=k)
    specs = step.state_specs["params"]
    got = lm.leaves(gather_tree(grads, specs, mesh))
    tol = GRAD_TOL.get(arch, 1e-4)
    for path, want in lm.leaves(f_grads).items():
        err = float((got[path] - want).abs().max()) / max(float(want.abs().max()), 1e-30)
        assert err <= tol, (path, err)
    if comp:
        got_c = lm.leaves(gather_tree(step.compress(grads), specs, mesh))
        for path, want_c in lm.leaves(int8_roundtrip(f_grads)).items():
            check_compressed(got_c[path], want_c, got[path], lm.leaves(f_grads)[path], path)


def test_xlstm_gradients_move_under_one_ulp():
    """Why xlstm's gradients are held at ``GRAD_TOL``: the flat port's own
    gradients move by more than 1e-3 of a leaf's largest magnitude, and
    less than the tolerance, when every parameter moves by at most one
    ulp."""
    cfg = config("xlstm-1.3b")
    params = lm.init_params(cfg, generator=torch.Generator().manual_seed(1), device="cpu")
    g = torch.Generator().manual_seed(5)
    moved = lm.tree_map(
        lambda t: t * (1 + torch.randint(-1, 2, t.shape, generator=g).float() * 2.0**-23), params)
    opts = TrainOptions(remat=True, q_chunk=8)
    batch = {"tokens": tokens_of(cfg)}
    _, _, want = flat_microbatched(cfg, opts, params, batch)
    _, _, got = flat_microbatched(cfg, opts, moved, batch)
    worst = max(float((lm.leaves(got)[p] - w).abs().max()) / float(w.abs().max())
                for p, w in lm.leaves(want).items())
    assert 1e-3 < worst < GRAD_TOL["xlstm-1.3b"], worst


def test_a_microbatch_is_global_rows():
    """Granite on (2, 2), 2 microbatches: the sharded step's aux losses are
    the flat microbatched step's; each data rank's own rows split in two
    (the batch permuted so) give other aux losses."""
    cfg, mesh = config("granite-moe-1b-a400m"), cpu_mesh((2, 2))
    opts = TrainOptions(remat=False, q_chunk=8, microbatches=2)
    params = lm.init_params(cfg, generator=torch.Generator().manual_seed(1), device="cpu")
    tokens = tokens_of(cfg, 5)
    step = ShardedTrainStep(cfg, opt.OptimizerConfig(), opts, mesh, B)
    placed = place_tree(params, step.state_specs["params"], mesh)
    _, metrics = step.loss(placed, step.place_batch({"tokens": tokens}))
    # data rank d holds rows [4d, 4d + 4); split per rank, microbatch i
    # would be rows {4d + 2i, 4d + 2i + 1 : d}
    per_rank = torch.cat([tokens[[4 * d + 2 * i + j for d in range(2) for j in range(2)]]
                          for i in range(2)])
    with use_mesh(mesh):
        want = flat_microbatched(cfg, opts, params, {"tokens": tokens})[1]
        other = flat_microbatched(cfg, opts, params, {"tokens": per_rank})[1]
    for k in ("moe_lb_loss", "moe_z_loss"):
        torch.testing.assert_close(metrics[k], want[k], rtol=0, atol=1e-6, msg=k)
    assert abs(float(other["moe_lb_loss"]) - float(want["moe_lb_loss"])) > 1e-4


def test_the_dry_run_counts_microbatches_and_the_int8_pmax():
    cfg, mesh = config("granite-moe-1b-a400m"), cpu_mesh((2, 2))
    shape = ShapeConfig("t", S, B, "train")
    got = {}
    for name, opts in (("one", TrainOptions(q_chunk=8)),
                       ("mb2", TrainOptions(q_chunk=8, microbatches=2)),
                       ("mb2-int8", TrainOptions(q_chunk=8, microbatches=2,
                                                 grad_compression="int8"))):
        fn, args, _, _ = build_step(cfg, shape, mesh, train_options=opts)
        assert fn.placed.options == opts
        flops = FlopCounterMode(display=False)
        with counting_collectives() as coll, flops:
            fn.placed(*fn.place(*args))
        got[name] = (flops.get_total_flops(), coll["all-reduce"])
    # two microbatches of B/2 rows: the FLOPs of one of B rows
    assert got["mb2"][0] == got["one"][0] > 0
    # int8: one 4-byte pmax a leaf sharded over an axis of size > 1
    specs = fn.placed.state_specs["params"]
    sharded = sum(1 for s in lm.leaves(specs).values()
                  if any(a is not None for a in tuple(s)))
    assert got["mb2-int8"][1] - got["mb2"][1] == 4 * sharded > 0


def test_microbatches_must_split_over_the_data_ranks():
    with pytest.raises(ValueError, match="8 rows in 8 microbatches of 1 rows.*2 data ranks"):
        ShardedTrainStep(config("qwen2-7b"), opt.OptimizerConfig(),
                         TrainOptions(microbatches=8), cpu_mesh((2, 2)), B)


@pytest.mark.parametrize("scenario", ["train", "gspmd"])
def test_over_processes_and_against_the_reference(scenario, tmp_path):
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, WORKER, scenario, str(tmp_path)],
                          capture_output=True, text=True, timeout=240, env=env)
    assert proc.returncode == 0 and "ALL OK" in proc.stdout, (
        f"STDOUT:\n{proc.stdout[-4000:]}\nSTDERR:\n{proc.stderr[-4000:]}"
    )
