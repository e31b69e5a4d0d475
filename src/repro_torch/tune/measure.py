"""Measurement harness for candidate ``Target``s (port of
``repro.tune.measure``).

Protocol (DESIGN.md §8): run the candidate's ``time_loop`` over a
fixed-seed random state, ``warmup`` untimed runs first (on the card they
build and load the kernels and capture the compiled step's graphs), then
``trials`` timed runs, and report the *median* per-step seconds.  The
step count is rounded up to a multiple of the candidate's
``exchange_every`` (a partial epoch has no compiled form), and the
per-step normalization uses the rounded count, so depth-k candidates are
compared per step, not per call.  On one card a run is timed by CUDA
events after ``torch.cuda.synchronize()``; over several cards by
``time.perf_counter`` between synchronizations of every card; on the CPU
by ``time.perf_counter``.

Distributed-awareness: under an initialized ``torch.distributed`` with
more than one process the clocks of different processes disagree, so
``agree_on_times`` broadcasts process 0's timing vector to every
process before the argmin — all ranks then select the identical winner.
In a single process (one controller over every rank, the test harness)
the vector is already shared.
"""
from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np
import torch


def measurement_state(compiled, dtype=torch.float32, seed: int = 0) -> tuple:
    """Fixed-seed random *input* state for ``compiled.time_loop`` on the
    target's device (output buffers are allocated by the step itself)."""
    rng = np.random.default_rng(seed)
    outs = set(
        compiled.program.field_args.index(f)
        for f in compiled.program.output_fields
    )
    state = []
    for i, f in enumerate(compiled.program.field_args):
        if i in outs:
            continue
        shape = f.type.bounds.shape
        state.append(
            torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(
                device=compiled.target.device, dtype=dtype
            )
        )
    return tuple(state)


def measure_compiled(
    compiled,
    steps: int = 8,
    trials: int = 3,
    warmup: int = 1,
    dtype=torch.float32,
    seed: int = 0,
    state: Optional[Sequence[torch.Tensor]] = None,
) -> float:
    """Median seconds *per time step* of ``compiled.time_loop`` over
    ``steps`` steps (rounded up to a whole number of epochs), from
    ``state`` (default: ``measurement_state(compiled, dtype, seed)``)."""
    k = compiled.target.exchange_every
    steps = max(int(steps), k)
    steps = ((steps + k - 1) // k) * k
    if state is None:
        state = measurement_state(compiled, dtype=dtype, seed=seed)
    cards = _cards(compiled.target)

    def sync() -> None:
        for c in cards:
            torch.cuda.synchronize(c)

    for _ in range(max(int(warmup), 1)):
        compiled.time_loop(state, steps)
    times = []
    for _ in range(max(int(trials), 1)):
        if len(cards) == 1:
            with torch.cuda.device(cards[0]):
                sync()
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                compiled.time_loop(state, steps)
                b.record()
                b.synchronize()
            times.append(a.elapsed_time(b) / 1e3)
        else:  # the CPU, or several cards: no one stream sees every rank
            sync()
            t0 = time.perf_counter()
            compiled.time_loop(state, steps)
            sync()
            times.append(time.perf_counter() - t0)
    return float(np.median(times)) / steps


def _cards(target) -> list:
    """The distinct CUDA devices the target's ranks run on."""
    devices = target.mesh.devices.flat if target.mesh is not None else [target.device]
    found = dict.fromkeys(str(torch.device(d)) for d in devices)
    return [torch.device(d) for d in found if torch.device(d).type == "cuda"]


def agree_on_times(times: Sequence[Optional[float]]) -> list:
    """One timing vector every process agrees on: process 0's
    measurements, broadcast.  ``None`` slots (unmeasured candidates) are
    carried through.  A single-process run returns the input."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() <= 1:
        return list(times)
    device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    vec = torch.tensor(
        [float("nan") if t is None else float(t) for t in times],
        dtype=torch.float64, device=device,
    )
    dist.broadcast(vec, src=0)
    return [None if np.isnan(t) else float(t) for t in vec.tolist()]
