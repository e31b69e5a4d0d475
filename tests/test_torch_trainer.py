"""The port's fault-tolerant trainer (``repro_torch.train.trainer``) on the
CPU, at the reduced size of qwen2-7b in float32: kill-and-resume is
bitwise the uninterrupted run, SIGTERM leaves a committed checkpoint, the
NaN guard keeps the old state bit for bit and aborts after
``max_nan_steps``, the step-time watchdog flags a straggler, and a
checkpoint written by the reference's ``Trainer`` resumes in the port's
with the reference's next losses (within 1e-4).  The trainer's state is
the port's nested dicts of tensors; batches come from the port's data
pipeline (the reference's, bitwise: ``tests/test_torch_train.py``)."""
import os
import signal
import time

import jax
import numpy as np
import pytest
import torch

from _torch_lm import cfgs
from repro.train import optimizer as ropt
from repro.train import train_step as rts
from repro.train.trainer import Trainer as RTrainer
from repro.train.trainer import TrainerConfig as RTrainerConfig
from repro.data.pipeline import DataConfig as RDataConfig
from repro_torch.checkpoint import Checkpointer
from repro_torch.data.pipeline import DataConfig
from repro_torch.models import lm
from repro_torch.train import optimizer as opt
from repro_torch.train import train_step as ts
from repro_torch.train.trainer import Trainer, TrainerConfig

CPU = torch.device("cpu")
RCFG, CFG = cfgs("qwen2-7b", dtype="float32")
OPT = dict(peak_lr=1e-2, warmup_steps=2)
DATA = dict(seq_len=16, global_batch=2, vocab_size=CFG.vocab_size, seed=3)


def _step(**kw):
    return ts.make_train_step(CFG, opt.OptimizerConfig(**OPT), ts.TrainOptions(q_chunk=8, **kw))


def _init():
    return ts.init_train_state(torch.Generator().manual_seed(5), CFG, CPU)


def _trainer(step_fn, total, ckpt_dir=None, every=3, **kw):
    return Trainer(step_fn, _init, DataConfig(**DATA),
                   TrainerConfig(total_steps=total, checkpoint_every=every,
                                 checkpoint_dir=ckpt_dir, log_every=1, **kw), device=CPU)


def _equal(a, b):
    la, lb = lm.leaves(a), lm.leaves(b)
    assert list(la) == list(lb) or sorted(la) == sorted(lb)
    for k in la:
        assert la[k].dtype == lb[k].dtype and torch.equal(la[k], lb[k]), k


def test_kill_and_resume_is_bitwise(tmp_path):
    want = _trainer(_step(), 6)
    out = want.run()
    assert out["final_step"] == 6

    class Killed(Exception):
        pass

    step, calls = _step(), []

    def dies_at_step_4(state, batch):
        calls.append(int(state["step"]))
        if len(calls) == 4:
            raise Killed
        return step(state, batch)

    with pytest.raises(Killed):
        _trainer(dies_at_step_4, 6, str(tmp_path)).run()
    assert Checkpointer(str(tmp_path)).available_steps() == [3]

    resumed = _trainer(step, 6, str(tmp_path))
    assert resumed.start_step == 3 and int(resumed.state["step"]) == 3
    assert resumed.state["params"]["embed"].device == CPU
    out2 = resumed.run()
    assert out2["final_step"] == 6
    _equal(resumed.state, want.state)
    assert [m["loss"] for m in out2["metrics"]] == [m["loss"] for m in out["metrics"][3:]]


@pytest.mark.parametrize("at", [2, 3], ids=["between_snapshots", "at_a_snapshot"])
def test_sigterm_leaves_a_committed_blocking_checkpoint(tmp_path, at):
    step = _step()

    def preempted(state, batch):
        if int(state["step"]) == at - 1:
            os.kill(os.getpid(), signal.SIGTERM)
        return step(state, batch)

    before = signal.getsignal(signal.SIGTERM)
    try:
        tr = _trainer(preempted, 6, str(tmp_path))
        tr.install_signal_handler()
        out = tr.run()
    finally:
        signal.signal(signal.SIGTERM, before)
    assert out["final_step"] == at
    ck = Checkpointer(str(tmp_path))
    assert ck.available_steps() == [at]
    assert os.path.exists(os.path.join(str(tmp_path), f"step_{at:08d}", "COMMITTED"))
    assert tr.ckpt.stats.saves == 1  # at a snapshot step that snapshot is the last one
    resumed = _trainer(step, 6, str(tmp_path))
    assert resumed.start_step == at
    _equal(resumed.state, tr.state)


def test_a_dropped_trainer_is_not_kept_alive_by_its_signal_handler():
    import gc
    import weakref

    before = signal.getsignal(signal.SIGTERM)
    try:
        tr = _trainer(_step(), 1)
        tr.install_signal_handler()
        gone = weakref.ref(tr)
        del tr
        gc.collect()
        assert gone() is None
        os.kill(os.getpid(), signal.SIGTERM)  # the handler outlives it harmlessly
    finally:
        signal.signal(signal.SIGTERM, before)


def test_nan_guard_keeps_the_state_and_aborts():
    """A non-finite third step is dropped: the fourth call gets the state
    from before it, bit for bit, and the run goes on from there."""
    step, kept = _step(), []

    def third_is_nan(state, batch):
        kept.append(lm.tree_map(torch.clone, state))
        new, metrics = step(state, batch)
        if len(kept) == 3:
            metrics = dict(metrics, loss=metrics["loss"] * float("nan"))
        return new, metrics

    tr = _trainer(third_is_nan, 4)
    out = tr.run()
    assert out["final_step"] == 4
    _equal(kept[3], kept[2])
    assert int(tr.state["step"]) == 3  # four calls, three updates
    losses = [m["loss"] for m in out["metrics"]]
    assert np.isnan(losses[2]) and np.isfinite(losses[:2] + losses[3:]).all()

    def always_nan(state, batch):
        new, metrics = step(state, batch)
        return new, dict(metrics, loss=metrics["loss"] * float("nan"))

    tr = _trainer(always_nan, 10, max_nan_steps=2)
    first = lm.tree_map(torch.clone, tr.state)
    with pytest.raises(FloatingPointError, match="3 non-finite steps"):
        tr.run()
    _equal(tr.state, first)


def test_straggler_is_flagged():
    def fake(state, batch):
        time.sleep(0.2 if int(state["step"]) == 10 else 0.005)
        return dict(state, step=state["step"] + 1), {"loss": torch.zeros(())}

    tr = Trainer(fake, lambda: {"step": torch.zeros((), dtype=torch.int32)},
                 DataConfig(**DATA), TrainerConfig(total_steps=12, log_every=100), device=CPU)
    out = tr.run()
    flagged = [m for m in out["metrics"] if "straggler_s" in m]
    assert [m["step"] for m in flagged] == [10]
    assert flagged[0]["straggler_s"] > 3 * flagged[0]["median_s"]


def test_reference_checkpoint_resumes_in_the_port(tmp_path):
    """The reference's Trainer runs 3 steps and checkpoints; the port's
    resumes from that checkpoint and its next two losses are the
    reference's uninterrupted run's within 1e-4."""
    ocfg = ropt.OptimizerConfig(**OPT)
    rstep = jax.jit(rts.make_train_step(RCFG, ocfg, rts.TrainOptions(q_chunk=8)))

    def rinit():
        return rts.init_train_state(jax.random.PRNGKey(5), RCFG)

    def rtrainer(total, ckpt_dir=None):
        return RTrainer(rstep, rinit, RDataConfig(**DATA),
                        RTrainerConfig(total_steps=total, checkpoint_every=3,
                                       checkpoint_dir=ckpt_dir, log_every=1))

    rtrainer(3, str(tmp_path)).run()
    want = [m["loss"] for m in rtrainer(5).run()["metrics"]]

    def no_init():
        raise AssertionError("a resuming trainer builds no state")

    port = Trainer(_step(), no_init, DataConfig(**DATA),
                   TrainerConfig(total_steps=5, checkpoint_every=3, checkpoint_dir=str(tmp_path),
                                 log_every=1), device=CPU)
    assert port.start_step == 3
    assert port.state["opt_state"]["count"].dtype == torch.int32
    got = [m["loss"] for m in port.run()["metrics"]]
    np.testing.assert_allclose(got, want[3:], rtol=1e-4, atol=1e-4)


def test_trainer_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(_step(), _init, DataConfig(**DATA), TrainerConfig())


def test_chip_smoke_phase_15_on_the_cpu(capsys):
    """``chip_smoke.train_phase`` with granite-moe at its reduced size and
    short sequences, on the CPU: every check passes (the resume bitwise)
    and its lines are logged."""
    import sys
    from pathlib import Path

    from repro_torch.configs.base import reduced_config

    root = str(Path(__file__).resolve().parents[1])
    sys.path.insert(0, root)
    try:
        import chip_smoke
    finally:
        sys.path.remove(root)
    before = signal.getsignal(signal.SIGTERM)
    chip_smoke.train_phase(CPU, card="the CPU", cut=reduced_config, seq_len=16, global_batch=4,
                           q_chunk=8)
    assert signal.getsignal(signal.SIGTERM) == before
    out = capsys.readouterr().out
    assert "phase 15:" in out and "tokens/s" in out
    assert out.count("    uninterrupted, step ") == 6
    assert out.count("    preempted, step ") == 3 and out.count("    resumed, step ") == 3
    assert "bitwise the uninterrupted run's" in out
    assert out.count("case 2, ") == 10
