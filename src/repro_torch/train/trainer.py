"""Fault-tolerant training loop (port of ``repro.train.trainer``).

Production behaviors implemented (and exercised by tests):
- **checkpoint/restart**: periodic async checkpoints; on start, resume
  from the latest COMMITTED step; the data pipeline is keyed by step so
  the token stream resumes exactly;
- **preemption handling**: SIGTERM triggers a final blocking checkpoint
  before exit (where the step just saved is that checkpoint, the trainer
  waits for it to commit instead of writing it twice);
- **NaN guard**: non-finite loss skips the update (the train step is
  functional, so the old state is still whole) and counts toward an
  abort threshold;
- **straggler/step-time watchdog**: a rolling step-time median flags
  outlier steps (logged);
- **restart on another device**: the port's ``Checkpointer`` restores
  host arrays, which the trainer places on its own device; the restore
  template comes from the checkpoint's manifest, so resuming builds no
  state of its own (a checkpoint the reference's trainer wrote resumes
  here too);
- **sharded state** (``state_shardings``, the reference's argument: a tree
  of ``NamedSharding`` s, e.g. ``shardings_of(step.state_specs, mesh)``):
  ``init_state()`` returns the state placed by them
  (``train_step.init_placed_train_state``), a restore places every leaf's
  blocks as it reads them, a save gathers the blocks to one writer in the
  reference's format, and each batch is placed by ``put_batch`` (a
  ``ShardedTrainStep``'s ``place_batch`` by default): a snapshot written
  on one layout resumes on another, or on one device.
"""
from __future__ import annotations

import dataclasses
import signal
import time
import weakref
from collections import deque
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.data.pipeline import DataConfig, PrefetchLoader, make_source
from repro_torch.models.lm import default_device


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    checkpoint_every: int = 50
    checkpoint_dir: Optional[str] = None
    log_every: int = 10
    max_nan_steps: int = 5
    straggler_factor: float = 3.0


def put_batch_on(device) -> Callable[[dict], dict]:
    """The default ``put_batch``: a host batch's numpy arrays as tensors on
    ``device`` (token ids as int64, the index type)."""

    def put(batch: dict) -> dict:
        return {
            k: torch.from_numpy(np.ascontiguousarray(v)).to(
                device, dtype=torch.int64 if k == "tokens" else None)
            for k, v in batch.items()
        }

    return put


def _template(manifest: dict) -> dict:
    """The nested-dict structure of a saved state, from its manifest's
    leaf keys (``params/cells/slot0/attn/wq``); each leaf its key."""
    tree: dict = {}
    for key in manifest["leaves"]:
        *parents, name = key.split("/")
        node = tree
        for k in parents:
            node = node.setdefault(k, {})
        node[name] = key
    return tree


def _first_leaf(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


def shardings_of(specs, mesh) -> dict:
    """A spec tree (``state_pspecs``) as the tree of ``NamedSharding`` s that
    ``Trainer(state_shardings=...)`` and ``Checkpointer.restore`` take."""
    from repro_torch.dist.sharding import NamedSharding

    if isinstance(specs, dict):
        return {k: shardings_of(v, mesh) for k, v in specs.items()}
    return NamedSharding(mesh, specs)


def _place(tree, device):
    if isinstance(tree, dict):
        return {k: _place(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.asarray(tree)).to(device)


class Trainer:
    def __init__(
        self,
        train_step: Callable,
        init_state: Callable[[], Any],
        data_cfg: DataConfig,
        cfg: TrainerConfig,
        put_batch: Optional[Callable] = None,
        device=None,
        state_shardings=None,
    ):
        self.train_step = train_step
        self.cfg = cfg
        self.data_cfg = data_cfg
        self.state_shardings = state_shardings
        if state_shardings is not None:
            if device is not None:
                raise ValueError(
                    "Trainer takes a device or state_shardings, not both: the state's mesh "
                    "names the devices"
                )
            mesh = _first_leaf(state_shardings).mesh
            self.device = mesh.device(mesh.process_rank if mesh.processes else 0)
            put_batch = put_batch or getattr(train_step, "place_batch", None)
            if put_batch is None:
                raise ValueError(
                    "Trainer(state_shardings=...) needs a put_batch that places a batch's "
                    "rows (a ShardedTrainStep's place_batch is the default)"
                )
        else:
            self.device = default_device(device)
        self.put_batch = put_batch or put_batch_on(self.device)
        self.ckpt = (
            Checkpointer(cfg.checkpoint_dir) if cfg.checkpoint_dir else None
        )
        self._preempted = False
        self._nan_steps = 0
        self._step_times: deque = deque(maxlen=32)
        self.metrics_log: list = []

        # resume or init
        start = self.ckpt.latest_step() if self.ckpt else None
        if start is not None:
            template = _template(self.ckpt.manifest(start))
            if state_shardings is not None:
                self.state = self.ckpt.restore(template, step=start, shardings=state_shardings)
            else:
                self.state = _place(self.ckpt.restore(template, step=start), self.device)
            self.start_step = start
        else:
            self.state = init_state()
            self.start_step = 0

    # -- preemption --------------------------------------------------------
    def install_signal_handler(self) -> None:
        # the handler holds the trainer weakly: the process's signal table
        # must not keep a finished trainer's state alive
        me = weakref.ref(self)

        def handler(signum, frame):
            trainer = me()
            if trainer is not None:
                trainer._preempted = True

        signal.signal(signal.SIGTERM, handler)

    # -- main loop ----------------------------------------------------------
    def run(self) -> dict:
        source = make_source(self.data_cfg)
        loader = PrefetchLoader(source, start_step=self.start_step)
        it = iter(loader)
        step = self.start_step
        try:
            while step < self.cfg.total_steps:
                data_step, batch = next(it)
                assert data_step == step, (data_step, step)
                t0 = time.perf_counter()
                new_state, metrics = self.train_step(
                    self.state, self.put_batch(batch)
                )
                loss = float(metrics["loss"])  # waits for the device
                dt = time.perf_counter() - t0

                if not np.isfinite(loss):
                    # NaN guard: drop the update, keep the old state
                    self._nan_steps += 1
                    if self._nan_steps > self.cfg.max_nan_steps:
                        raise FloatingPointError(
                            f"{self._nan_steps} non-finite steps — aborting; "
                            f"restart will resume from the last checkpoint"
                        )
                else:
                    self.state = new_state
                    self._nan_steps = 0
                del new_state

                self._watch_stragglers(step, dt)
                step += 1
                if step % self.cfg.log_every == 0 or step == self.cfg.total_steps:
                    self.metrics_log.append(
                        {"step": step, "loss": loss, "time_s": dt}
                    )
                saved = False
                if self.ckpt and step % self.cfg.checkpoint_every == 0:
                    self.ckpt.save(step, self._saveable())
                    saved = True
                if self._preempted:
                    if self.ckpt:
                        if saved:
                            self.ckpt.wait()  # this step's snapshot: commit it
                        else:
                            self.ckpt.save(step, self._saveable(), blocking=True)
                    break
        finally:
            loader.stop()
            if self.ckpt:
                self.ckpt.wait()
        return {"final_step": step, "metrics": self.metrics_log}

    def _saveable(self):
        """The state as the ``Checkpointer`` saves it: placed blocks as
        sharded tensors (views), which it gathers to the one writer."""
        if self.state_shardings is None:
            return self.state
        from repro_torch.dist.sharding import as_sharded

        def one(x, s):
            if isinstance(x, dict):
                return {k: one(v, s[k]) for k, v in x.items()}
            return as_sharded(x, s.mesh, s.spec)

        return one(self.state, self.state_shardings)

    def _watch_stragglers(self, step: int, dt: float) -> None:
        if len(self._step_times) >= 8:
            med = float(np.median(self._step_times))
            if dt > self.cfg.straggler_factor * med:
                self.metrics_log.append(
                    {
                        "step": step,
                        "straggler_s": dt,
                        "median_s": med,
                        "action": "flagged (a cluster would drain and replace the host)",
                    }
                )
        self._step_times.append(dt)
