# Copied from src/repro/resilience/faults.py with repro. renamed to repro_torch. and its comments naming ResilientLoop; keep its logic in step with that file.
"""Deterministic fault injection for the resilient time-loop driver.

Production long runs die in three characteristic ways; a ``FaultPlan``
reproduces each one *deterministically* so tests and the soak benchmark
(``benchmarks/resilience_soak.py``) can assert recovery instead of
hoping for it:

- **kill-at-epoch** — the process is preempted at an epoch boundary:
  ``before_epoch`` raises ``SimulatedFault`` right before epoch
  ``kill_at_epoch`` would advance (absolute epoch index — a resumed run
  that passes the same plan will NOT re-raise for epochs it already
  completed, because ResilientLoop resumes past them);
- **slow rank** — a straggler: ``delay_s`` seconds of sleep before every
  ``delay_every``-th epoch, for measuring how checkpoint cadence and
  stragglers compose;
- **checkpoint-write truncation** — a torn write: after the snapshot at
  ``truncate_step`` commits, its COMMITTED marker is removed and one
  leaf file is cut in half.  Restore must fall back to the previous
  committed snapshot, and ``Checkpointer`` startup GC must reclaim the
  wreck.

The plan is pure configuration (frozen dataclass); ResilientLoop calls
the hooks.  Nothing here is random — a FaultPlan replayed over the same run
produces the same fault at the same point.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional


class SimulatedFault(RuntimeError):
    """A deterministic injected failure (stands in for preemption /
    node loss); carries the epoch it struck at."""

    def __init__(self, epoch: int, step: int) -> None:
        super().__init__(
            f"simulated fault: killed before epoch {epoch} (step {step})"
        )
        self.epoch = epoch
        self.step = step


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Deterministic fault schedule for one driver run."""

    #: raise SimulatedFault before advancing this absolute epoch index
    kill_at_epoch: Optional[int] = None
    #: straggler delay injected before epochs (0.0 = none)
    delay_s: float = 0.0
    #: apply the delay before every Nth epoch (1 = every epoch)
    delay_every: int = 1
    #: corrupt the committed snapshot written at this *step* count
    truncate_step: Optional[int] = None

    def __post_init__(self) -> None:
        if self.delay_every < 1:
            raise ValueError(
                f"delay_every must be >= 1, got {self.delay_every}"
            )
        if self.delay_s < 0.0:
            raise ValueError(f"delay_s must be >= 0, got {self.delay_s}")

    # -- driver hooks ----------------------------------------------------
    def before_epoch(self, epoch: int, step: int) -> None:
        """Called by ResilientLoop before advancing absolute epoch
        ``epoch`` (the run is at ``step`` completed time steps)."""
        if self.delay_s > 0.0 and epoch % self.delay_every == 0:
            time.sleep(self.delay_s)
        if self.kill_at_epoch is not None and epoch == self.kill_at_epoch:
            raise SimulatedFault(epoch, step)

    def after_checkpoint(self, checkpointer, step: int) -> bool:
        """Called after the snapshot at ``step`` committed; returns True
        when this plan truncated it."""
        if self.truncate_step is None or step != self.truncate_step:
            return False
        checkpointer.wait()  # the async writer must finish before we maim it
        truncate_snapshot(checkpointer.dir, step)
        return True


def truncate_snapshot(directory: str, step: int) -> None:
    """Simulate a torn checkpoint write: drop the COMMITTED marker and
    halve the first leaf file of the ``step`` snapshot.  Restore-side
    code must treat the result exactly like a writer preempted mid-save."""
    path = os.path.join(directory, f"step_{step:08d}")
    marker = os.path.join(path, "COMMITTED")
    if os.path.exists(marker):
        os.unlink(marker)
    for name in sorted(os.listdir(path)):
        if name.endswith(".npy"):
            leaf = os.path.join(path, name)
            size = os.path.getsize(leaf)
            with open(leaf, "r+b") as f:
                f.truncate(size // 2)
            break
