"""Resumable, fault-tolerant driver around compiled stencils (port of
``repro.resilience.driver``).

``CompiledStencil.time_loop`` runs to its end: any interruption loses
the run, and a restart cannot change the mesh factorization.
``ResilientLoop`` drives the same arithmetic (``CompiledStencil.epochs``
/ ``advance`` — one rotation rule shared with ``time_loop``) as an
epoch-granular driver that

- snapshots the **global** state through ``repro_torch.checkpoint`` every
  ``checkpoint_every`` epochs.  Snapshots are *epoch-aligned*: they only
  happen at ``step % exchange_every == 0``, which is the invariant that
  keeps deep-halo temporal tiling consistent — mid-epoch there is no
  globally-meaningful state to save (redundant boundary compute is in
  flight);
- records ``(program fingerprint, step, time-buffer rotation phase,
  ret_indices)`` in the checkpoint manifest, so a resumer can verify it
  is continuing the *same* simulation with the *same* rotation
  arithmetic;
- on ``resume(program, dir, new_target)`` re-compiles for a **different**
  mesh factorization / rank count and reshards the restored host arrays
  through ``CompiledStencil.shard_state`` — the distribution layer is
  bitwise (``tests/test_torch_dist.py``), so a killed-and-resumed run
  across a mesh change ends bitwise-identical to the uninterrupted run.

Each epoch is one ``CompiledStencil.advance``: the state stays sharded
between epochs and, under ``Target(jit=True)`` on the card, is one CUDA
graph replay in the compiled step's ring of buffers (in place with
``donate=True``).  A snapshot copies the state to the host before the
next epoch runs and keeps no reference to the ring, so checkpoints
re-capture no graph.  With tracing on, each epoch is an ``epoch`` span
closed once the card has finished it (the epoch runs op by op then).

Fault injection (``faults.FaultPlan``) hooks the epoch boundary and the
post-checkpoint moment, so kill / straggle / torn-write scenarios are
deterministic and testable.
"""
from __future__ import annotations

import time
from typing import Any, Optional, Sequence

import numpy as np

from repro_torch import api
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.obs import trace as _obs
from repro_torch.resilience.faults import FaultPlan, SimulatedFault


class ResumeError(ValueError):
    """A checkpoint directory that cannot continue this run: wrong
    program, epoch-misaligned step for the new target, or a manifest
    without resilience metadata."""


class ResilientLoop:
    """An epoch-granular, checkpointing time loop over one compiled
    stencil.

    ``state`` is the input buffers oldest → newest (exactly what
    ``CompiledStencil.time_loop`` takes: tensors, float32 numpy arrays or
    sharded tensors); ``n_steps`` counts single time steps and must be a
    whole number of the target's epochs.  ``checkpoint_every`` counts
    *epochs* between snapshots (0 — or no ``directory`` — disables
    checkpointing).  ``run()`` drives the loop to ``n_steps`` and returns
    the final state (as ``advance`` keeps it: sharded over a mesh); an
    injected or real fault leaves the last committed snapshot on disk for
    ``resume``.  ``timings`` holds the seconds of the set-up a recovery
    pays: ``compile_s``, ``place_s`` and, after ``resume``, ``restore_s``.
    """

    def __init__(
        self,
        program,
        target=None,
        state: Sequence[Any] = (),
        n_steps: int = 0,
        *,
        directory: Optional[str] = None,
        checkpoint_every: int = 1,
        keep_last: int = 3,
        fault_plan: Optional[FaultPlan] = None,
        async_saves: bool = False,
        start_step: int = 0,
        _rotation_phase: int = 0,
        _resumed_from: Optional[int] = None,
    ) -> None:
        self.program = program
        self.target = target if target is not None else api.Target()
        t0 = time.perf_counter()
        self.compiled = api.compile(program, self.target)
        self.timings = {"compile_s": time.perf_counter() - t0}
        self.n_steps = int(n_steps)
        self.k = self.compiled.target.exchange_every
        self.total_epochs = self.compiled.epochs(self.n_steps)
        if start_step % self.k != 0:
            raise ResumeError(
                f"start_step={start_step} is not an epoch boundary of "
                f"Target(exchange_every={self.k}); checkpoints are "
                "epoch-aligned, so a resumable step must be a multiple of k"
            )
        if not 0 <= start_step <= self.n_steps:
            raise ValueError(
                f"start_step={start_step} outside [0, n_steps={self.n_steps}]"
            )
        inputs = self.compiled.input_indices
        state = tuple(state)
        if len(state) != len(inputs):
            raise ValueError(
                f"program {program.name!r} takes {len(inputs)} input "
                f"buffer(s) (oldest → newest), got {len(state)}"
            )
        for arr, idx in zip(state, inputs):
            want = tuple(program.field_args[idx].type.bounds.shape)
            if tuple(arr.shape) != want:
                raise ValueError(
                    f"input buffer for field {program.field_names[idx]!r} "
                    f"has shape {tuple(arr.shape)}, expected {want}"
                )
        t0 = time.perf_counter()
        self.state = self.compiled.shard_state(state)
        self.compiled.sync()
        self.timings["place_s"] = time.perf_counter() - t0
        self.step_count = int(start_step)
        self.checkpoint_every = int(checkpoint_every)
        self.fault_plan = fault_plan
        self.async_saves = bool(async_saves)
        self.resumed_from = _resumed_from
        self._phase = int(_rotation_phase) % max(1, len(state))
        self.events: list = []
        self.checkpointer = (
            Checkpointer(directory, keep_last=keep_last)
            if directory and self.checkpoint_every > 0
            else None
        )

    # -- driving ---------------------------------------------------------
    @property
    def epoch(self) -> int:
        """The absolute epoch index the loop will advance next."""
        return self.step_count // self.k

    @property
    def done(self) -> bool:
        return self.step_count >= self.n_steps

    def advance_epoch(self) -> None:
        """One epoch: fault hooks, compiled advance + rotation, and the
        epoch-aligned checkpoint when the cadence lands."""
        e, step = self.epoch, self.step_count
        if self.fault_plan is not None:
            try:
                self.fault_plan.before_epoch(e, step)
            except SimulatedFault:
                # "the node died": whatever save was in flight either
                # committed or is a torn partial — settle it so the test
                # harness sees a deterministic directory, then propagate
                if self.checkpointer is not None:
                    self.checkpointer.wait()
                self.events.append(("fault", e, step))
                raise
        self.state = self.compiled.advance(self.state, epoch=e, step_begin=step)
        n_ret = len(self.compiled.ret_indices)
        self._phase = (self._phase + n_ret) % max(1, len(self.state))
        self.step_count += self.k
        self.events.append(("epoch", e, self.step_count))
        if self._checkpoint_due():
            self.save_checkpoint()

    def _checkpoint_due(self) -> bool:
        if self.checkpointer is None:
            return False
        return (self.step_count // self.k) % self.checkpoint_every == 0

    def save_checkpoint(self) -> None:
        """Snapshot the global state at the current (epoch-aligned) step.
        The manifest carries everything a resumer verifies: program
        fingerprint, step, rotation phase and ret_indices."""
        assert self.step_count % self.k == 0, "checkpoints are epoch-aligned"
        tree = {"state": {f"b{i}": a for i, a in enumerate(self.state)}}
        extra = {
            "program_fingerprint": self.program.fingerprint,
            "program_name": self.program.name,
            "step": self.step_count,
            "n_steps": self.n_steps,
            "exchange_every": self.k,
            "rotation_phase": self._phase,
            "ret_indices": list(self.compiled.ret_indices),
            "input_indices": list(self.compiled.input_indices),
            "target_fingerprint": self.compiled.target.fingerprint,
        }
        t0 = time.perf_counter()
        with _obs.span("checkpoint.save", cat="checkpoint",
                       step=self.step_count, blocking=not self.async_saves):
            self.checkpointer.save(
                self.step_count, tree, blocking=not self.async_saves,
                extra=extra,
            )
        del tree  # host copies only: nothing here may keep the ring alive
        self.events.append(
            ("checkpoint", self.step_count, time.perf_counter() - t0)
        )
        if self.fault_plan is not None:
            self.fault_plan.after_checkpoint(self.checkpointer, self.step_count)

    def run(self, max_epochs: Optional[int] = None) -> tuple:
        """Drive to ``n_steps`` (or ``max_epochs`` more epochs) and
        return the final state tuple.  Joins any pending async save
        before returning, so a completed ``run`` never leaves a torn
        write behind."""
        budget = max_epochs if max_epochs is not None else self.total_epochs
        advanced = 0
        while not self.done and advanced < budget:
            self.advance_epoch()
            advanced += 1
        if self.checkpointer is not None:
            self.checkpointer.wait()
        return self.state


def resume(
    program,
    directory: str,
    target=None,
    *,
    step: Optional[int] = None,
    n_steps: Optional[int] = None,
    checkpoint_every: int = 1,
    keep_last: int = 3,
    fault_plan: Optional[FaultPlan] = None,
    async_saves: bool = False,
) -> ResilientLoop:
    """Resume a checkpointed run from ``directory`` onto ``target``
    (default ``Target()``, on the card).

    ``target`` may describe a **different** mesh factorization / rank
    count than the killed run: the snapshot holds *global* host arrays,
    which are resharded for the new decomposition — and the distribution
    layer is bitwise, so the resumed run's final state equals the
    uninterrupted run's.  A snapshot written by ``repro.resilience``
    resumes here too: the program fingerprints of the two packages agree.

    The manifest is verified before anything compiles: the checkpoint
    must carry resilience metadata, belong to the same program
    (fingerprint), and sit on an epoch boundary of the *new* target's
    ``exchange_every``.
    """
    ckpt = Checkpointer(directory, keep_last=keep_last)  # startup GC runs
    manifest = ckpt.manifest(step)
    meta = manifest.get("extra")
    if not meta or "program_fingerprint" not in meta:
        raise ResumeError(
            f"checkpoint at step {manifest.get('step')} in {directory} "
            "carries no resilience metadata (not written by ResilientLoop)"
        )
    if meta["program_fingerprint"] != program.fingerprint:
        raise ResumeError(
            f"checkpoint belongs to program {meta.get('program_name')!r} "
            f"(fingerprint {meta['program_fingerprint']}), not "
            f"{program.name!r} ({program.fingerprint}); resuming a "
            "different simulation would be silent corruption"
        )
    saved_step = int(meta["step"])
    total = int(n_steps if n_steps is not None else meta["n_steps"])
    target = target if target is not None else api.Target()
    k = target.exchange_every
    if saved_step % k != 0 or (total - saved_step) % k != 0:
        raise ResumeError(
            f"checkpointed step {saved_step} of {total} cannot resume onto "
            f"Target(exchange_every={k}): both the resume point and the "
            f"remaining {total - saved_step} steps must be whole epochs "
            f"(the killed run used exchange_every="
            f"{meta.get('exchange_every')})"
        )
    # restore host arrays in the saved buffer order
    leaves = manifest["leaves"]
    n_bufs = len(leaves)
    want_inputs = meta.get("input_indices")
    tree_like = {
        "state": {f"b{i}": np.zeros(()) for i in range(n_bufs)}
    }
    t0 = time.perf_counter()
    with _obs.span("checkpoint.restore", cat="checkpoint", step=saved_step,
                   program=program.name):
        restored = ckpt.restore(tree_like, step=saved_step)
    restore_s = time.perf_counter() - t0
    state = tuple(restored["state"][f"b{i}"] for i in range(n_bufs))
    loop = ResilientLoop(
        program,
        target,
        state,
        total,
        directory=directory,
        checkpoint_every=checkpoint_every,
        keep_last=keep_last,
        fault_plan=fault_plan,
        async_saves=async_saves,
        start_step=saved_step,
        _rotation_phase=int(meta.get("rotation_phase", 0)),
        _resumed_from=saved_step,
    )
    loop.timings["restore_s"] = restore_s
    if want_inputs is not None and list(loop.compiled.input_indices) != list(
        want_inputs
    ):
        raise ResumeError(
            f"input buffer layout changed: checkpoint holds fields "
            f"{want_inputs}, the new target consumes "
            f"{list(loop.compiled.input_indices)}"
        )
    return loop
