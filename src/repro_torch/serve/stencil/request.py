"""Requests, frames and handles for the stencil-serving engine (port of
``repro.serve.stencil.request``).

A *request* is one tenant's simulation job: ``(Program, initial state,
n_steps, Target)``.  The engine advances it inside a fingerprint-batched
slot pool (``scheduler.py``); the tenant watches progress through a
``RequestHandle`` — intermediate *frames* stream back at a configurable
``frame_every`` cadence (per-request callback and/or a pull iterator),
and ``result()`` is the final state, bitwise-equal to a solo
``compile(program, target).time_loop(state, n_steps)`` run.

A frame holds host copies (numpy arrays): the pool rows it is taken from
live on the card and are overwritten by the next dispatch.  ``result()``
is a tuple of tensors that the engine copied out of the pool, so later
dispatches leave it as it is.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable, Iterator, Optional

import numpy as np
import torch

# request lifecycle: queued → running → done, with an exit ramp:
# a request drained to a checkpoint by StencilEngine.evacuate (it no
# longer occupies this engine; a second engine admits it mid-run)
QUEUED = "queued"
RUNNING = "running"
DONE = "done"
EVACUATED = "evacuated"


@dataclasses.dataclass(frozen=True)
class Frame:
    """One streamed snapshot of a request's state.

    ``step`` is the number of *time steps* completed when the frame was
    taken (always an epoch boundary of the request's target, so with
    ``Target(exchange_every=k)`` frames land on multiples of k);
    ``arrays`` is the full state tuple, oldest → newest, as host (numpy)
    arrays.
    """

    rid: int
    step: int
    arrays: tuple


@dataclasses.dataclass
class StencilRequest:
    """One admitted simulation job plus its runtime bookkeeping."""

    rid: int
    program: Any               # repro_torch.api.Program
    target: Any                # repro_torch.api.Target
    state: tuple               # input arrays, oldest → newest
    n_steps: int
    frame_every: int = 0       # 0 = no intermediate frames
    on_frame: Optional[Callable[[Frame], None]] = None
    tenant: Optional[str] = None

    # runtime state (owned by the scheduler/engine)
    steps_done: int = 0
    slot: int = -1
    status: str = QUEUED
    result: Optional[tuple] = None
    submitted_at: float = 0.0
    started_at: float = 0.0
    finished_at: float = 0.0
    next_frame_at: int = 0
    frames_emitted: int = 0
    _frames: deque = dataclasses.field(default_factory=deque)

    @property
    def done(self) -> bool:
        return self.status == DONE

    @property
    def latency_s(self) -> float:
        """Submit-to-finish wall-clock seconds (0.0 until done)."""
        if not self.done:
            return 0.0
        return self.finished_at - self.submitted_at

    def emit_frame(self, arrays: tuple) -> None:
        frame = Frame(
            rid=self.rid,
            step=self.steps_done,
            arrays=tuple(_host(a) for a in arrays),
        )
        self.frames_emitted += 1
        if self.on_frame is not None:
            self.on_frame(frame)
        else:
            # buffered for the pull iterator only when nobody consumes
            # frames eagerly — an unread callback stream must not grow
            self._frames.append(frame)


def _host(a) -> np.ndarray:
    """A host copy of one state array (a tensor on any device, or numpy)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.array(a, copy=True)


class RequestHandle:
    """The tenant's view of a submitted request."""

    def __init__(self, request: StencilRequest) -> None:
        self._req = request

    @property
    def rid(self) -> int:
        return self._req.rid

    @property
    def status(self) -> str:
        return self._req.status

    @property
    def done(self) -> bool:
        return self._req.done

    @property
    def steps_done(self) -> int:
        return self._req.steps_done

    @property
    def latency_s(self) -> float:
        return self._req.latency_s

    def frames(self) -> Iterator[Frame]:
        """Drain buffered frames (frames delivered to an ``on_frame``
        callback are not re-buffered here)."""
        while self._req._frames:
            yield self._req._frames.popleft()

    def result(self) -> tuple:
        """Final state (oldest → newest) after ``n_steps``; raises if the
        request has not finished — drive the engine (``step()``/``run()``)
        first."""
        if not self._req.done:
            raise RuntimeError(
                f"request {self.rid} is {self._req.status} "
                f"({self._req.steps_done}/{self._req.n_steps} steps); "
                "run the engine to completion before reading the result"
            )
        return self._req.result

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"RequestHandle(rid={self.rid}, status={self.status!r}, "
            f"steps={self._req.steps_done}/{self._req.n_steps})"
        )


def now() -> float:
    return time.perf_counter()
