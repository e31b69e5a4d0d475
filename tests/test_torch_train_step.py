"""The port's loss, gradients and train step (``repro_torch.train``)
against the reference's (``repro.train``), on the CPU at the reduced
sizes of ``reduced_config``.

Gradients: ``torch.autograd`` through ``lm.forward_train`` against
``jax.value_and_grad`` of the reference's ``make_loss_fn``, both in
float32 on the reference's parameters (``tests/_torch_lm.py``'s ``Pair``).
The loss and its metrics agree within rtol = atol = 1e-4; every gradient
leaf within rtol = atol = 1e-4 of that leaf's largest magnitude (the leaf
divided by it), plus ``noise``: how far the same scaled gradients move
when the port's parameters move by a relative 2**-24 of seeded noise
(``Pair.noise``; ~1e-3 for xlstm-1.3b, whose per-head norm scales
rounding by ~10**3 a layer, PERF.md; ~1e-6 for the rest).

In bfloat16 (the configs' dtype) both sides round their products and
activations at the same points, but a last-bit difference in float32
flips a bfloat16 rounding now and then (2**-8 relative): the bf16 case
holds the loss within 1e-3 and every leaf within 2**-5 of its max.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm import Pair, to_numpy
from repro.train import optimizer as ropt
from repro.train import train_step as rts
from repro_torch.configs import ARCHS
from repro_torch.interop import train_state_from_numpy
from repro_torch.models import lm
from repro_torch.train import optimizer as opt
from repro_torch.train import train_step as ts

TOL = 1e-4


def _batches(pair):
    (rt, rm), (t, m) = pair.inputs()
    rb = {"tokens": rt} if rm is None else {"tokens": rt, "modality": rm}
    b = {"tokens": t} if m is None else {"tokens": t, "modality": m}
    return rb, b


def _close(got, want, what, noise=0.0, rtol=TOL, atol=TOL):
    want = torch.from_numpy(np.array(want, np.float32))
    torch.testing.assert_close(got.float(), want, rtol=rtol, atol=atol + noise,
                               msg=lambda m: f"{what}: {m}")


def _scale(a) -> float:
    return max(float(np.abs(np.asarray(a)).max()), 1e-30)


def _grads_close(pair, grads, rgrads, noise_of=None, tol=TOL):
    want = lm.leaves(to_numpy(rgrads))
    got = lm.leaves(grads)
    assert list(got) == list(lm.leaves(pair.params))
    assert sorted(got) == sorted(want)
    scale = {k: _scale(v) for k, v in want.items()}
    noise = 0.0
    if noise_of is not None:
        noise = pair.noise(lambda p: {k: v / scale[k] for k, v in lm.leaves(noise_of(p)).items()})
    for k, g in got.items():
        assert g.dtype == torch.float32 and g.shape == want[k].shape, k
        _close(g / scale[k], want[k] / scale[k], f"{pair.arch} grad {k}", noise, tol, tol)
    return noise


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return Pair(request.param)


def test_loss_and_grads_match_reference(pair):
    rb, b = _batches(pair)
    options = dict(q_chunk=8)
    rfn = jax.jit(jax.value_and_grad(rts.make_loss_fn(pair.rcfg, rts.TrainOptions(**options)),
                                     has_aux=True))
    (rloss, rmetrics), rgrads = rfn(pair.rparams, rb)
    fn = ts.value_and_grad(ts.make_loss_fn(pair.cfg, ts.TrainOptions(**options)))
    (loss, metrics), grads = fn(pair.params, b)
    noise_of = (lambda p: fn(p, b)[1]) if pair.arch == "xlstm-1.3b" else None
    noise = _grads_close(pair, grads, rgrads, noise_of)
    _close(loss, rloss, f"{pair.arch} loss", noise)
    assert sorted(metrics) == sorted(rmetrics)
    for k in metrics:
        _close(metrics[k], rmetrics[k], f"{pair.arch} {k}", noise)
    # the parameters given are left as they were, with no grad attached
    assert all(not t.requires_grad for t in lm.leaves(pair.params).values())


def test_remat_is_bitwise(pair):
    """Recomputing each supercell in the backward changes no bit of the
    loss, the metrics or any gradient."""
    _, b = _batches(pair)
    out = [ts.value_and_grad(ts.make_loss_fn(pair.cfg, ts.TrainOptions(q_chunk=8, remat=r)))(
        pair.params, b) for r in (True, False)]
    (loss1, m1), g1 = out[0]
    (loss2, m2), g2 = out[1]
    assert torch.equal(loss1, loss2)
    assert all(torch.equal(m1[k], m2[k]) for k in m1)
    l1, l2 = lm.leaves(g1), lm.leaves(g2)
    assert all(torch.equal(l1[k], l2[k]) for k in l1)


def _ref_state(pair):
    return {"params": pair.rparams, "opt_state": ropt.init_opt_state(pair.rparams),
            "step": jnp.zeros((), jnp.int32)}


def _state_close(pair, state, rstate, lr_bound):
    """One AdamW step from zero moments: m and v are gradients scaled,
    so they agree as the gradients do; each parameter moves by lr times
    m̂/(√v̂ + eps), within ±lr, so the parameters agree within ``lr_bound``."""
    want = to_numpy(rstate)
    for name in ("m", "v"):
        w = lm.leaves(want["opt_state"][name])
        for k, t in lm.leaves(state["opt_state"][name]).items():
            s = _scale(w[k])
            _close(t / s, w[k] / s, f"{pair.arch} {name} {k}")
    w = lm.leaves(want["params"])
    for k, t in lm.leaves(state["params"]).items():
        _close(t, w[k], f"{pair.arch} param {k}", atol=lr_bound)
    assert int(state["step"]) == int(want["step"]) == 1
    assert int(state["opt_state"]["count"]) == int(want["opt_state"]["count"]) == 1


@pytest.mark.parametrize("arch", ["qwen2-7b", "granite-moe-1b-a400m", "internvl2-2b"])
def test_train_step_matches_reference(arch):
    pair = Pair(arch)
    rb, b = _batches(pair)
    ocfg = ropt.OptimizerConfig()
    rstate, rmetrics = jax.jit(rts.make_train_step(pair.rcfg, ocfg, rts.TrainOptions(q_chunk=8)))(
        _ref_state(pair), rb)
    state0 = train_state_from_numpy(pair.cfg, to_numpy(_ref_state(pair)), device="cpu")
    step = ts.make_train_step(pair.cfg, opt.OptimizerConfig(**dataclasses.asdict(ocfg)),
                              ts.TrainOptions(q_chunk=8))
    state, metrics = step(state0, b)
    assert sorted(metrics) == sorted(rmetrics)
    for k in metrics:
        _close(metrics[k], rmetrics[k], f"{arch} {k}")
    _state_close(pair, state, rstate, 2 * float(rmetrics["lr"]))
    # functional: the state given is untouched
    again = train_state_from_numpy(pair.cfg, to_numpy(_ref_state(pair)), device="cpu")
    for k, t in lm.leaves(again).items():
        assert torch.equal(t, lm.leaves(state0)[k]), k


@pytest.mark.parametrize("options", [dict(microbatches=2), dict(grad_compression="int8"),
                                     dict(microbatches=2, grad_compression="int8")],
                         ids=["microbatches2", "int8", "microbatches2_int8"])
def test_microbatches_and_compression_match_reference(options):
    """Microbatching accumulates ``acc + g / n`` and averages the metrics as
    the reference does; int8 compression quantizes the gradients, where a
    last-bit difference may move an element by one step (max|g| / 127):
    m and v are held within that step, the parameters within 2 lr."""
    pair = Pair("granite-moe-1b-a400m")
    rb, b = _batches(pair)
    ocfg = ropt.OptimizerConfig(peak_lr=1e-2, warmup_steps=0)
    rstep = jax.jit(rts.make_train_step(pair.rcfg, ocfg, rts.TrainOptions(q_chunk=8, **options)))
    rstate, rmetrics = rstep(_ref_state(pair), rb)
    state0 = train_state_from_numpy(pair.cfg, to_numpy(_ref_state(pair)), device="cpu")
    step = ts.make_train_step(pair.cfg, opt.OptimizerConfig(**dataclasses.asdict(ocfg)),
                              ts.TrainOptions(q_chunk=8, **options))
    state, metrics = step(state0, b)
    assert sorted(metrics) == sorted(rmetrics)
    for k in metrics:
        _close(metrics[k], rmetrics[k], f"{options} {k}")
    lr = float(rmetrics["lr"])
    if "grad_compression" not in options:
        _state_close(pair, state, rstate, 2 * lr)
        return
    want = to_numpy(rstate)
    for name in ("m", "v"):
        w = lm.leaves(want["opt_state"][name])
        for k, t in lm.leaves(state["opt_state"][name]).items():
            if name == "m":  # m = (1 - b1) g: one step of g is max|m| / 127
                bound = float(np.abs(w[k]).max()) / 127
            else:  # v = (1 - b2) g²: one step q of g moves it by (1 - b2)(2 max|g| + q) q
                g = float(np.sqrt(w[k] / (1 - ocfg.b2)).max())
                bound = (1 - ocfg.b2) * (2 * g + g / 127) * g / 127
            _close(t, w[k], f"{options} {name} {k}", atol=1.01 * bound + 1e-12)
    w = lm.leaves(want["params"])
    for k, t in lm.leaves(state["params"]).items():
        _close(t, w[k], f"{options} param {k}", atol=2 * lr)


def test_loss_decreases_over_steps():
    """Eight steps on a fixed batch (``tests/test_models.py``'s overfit
    check): the loss falls."""
    pair = Pair("qwen2-7b", seed=2)
    _, b = _batches(pair)
    state = ts.init_train_state(torch.Generator().manual_seed(2), pair.cfg, "cpu")
    step = ts.make_train_step(pair.cfg, opt.OptimizerConfig(peak_lr=1e-2), ts.TrainOptions(q_chunk=8))
    losses = []
    for _ in range(8):
        state, metrics = step(state, b)
        losses.append(float(metrics["loss"]))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    assert int(state["step"]) == 8


def test_bf16_grads_within_stated_tolerance():
    """qwen2-7b reduced, in bfloat16: loss within 1e-3, every gradient leaf
    within 2**-5 of its max (module docstring)."""
    pair = Pair("qwen2-7b", dtype="bfloat16")
    rb, b = _batches(pair)
    rfn = jax.jit(jax.value_and_grad(rts.make_loss_fn(pair.rcfg, rts.TrainOptions(q_chunk=8)),
                                     has_aux=True))
    (rloss, _), rgrads = rfn(pair.rparams, rb)
    (loss, _), grads = ts.value_and_grad(ts.make_loss_fn(pair.cfg, ts.TrainOptions(q_chunk=8)))(
        pair.params, b)
    _close(loss, rloss, "bf16 loss", rtol=1e-3, atol=1e-3)
    _grads_close(pair, grads, rgrads, tol=2.0**-5)
