# Copied from src/repro/serve/stencil/metrics.py with repro. renamed to repro_torch.; keep its logic in step with that file.
"""Utilization and dispatch accounting for the stencil-serving engine.

Per engine step the engine records a ``StepMetrics`` row (live slots over
pool size, batched vs solo dispatch counts, per-fingerprint queue depth);
``EngineMetrics`` aggregates them and folds in the process-wide compile
cache counters (``repro_torch.api.cache_stats``) as deltas since the engine was
constructed, so a serving process can see exactly how many compiles its
traffic caused vs reused.

Dispatch *latency* is tracked per fingerprint bucket too: every timed
dispatch records wall seconds under its "program_fp/target_fp" key (the
same keys ``queue_depth`` uses), and ``step_latency()`` summarizes each
bucket as p50/p99/mean — so a ``fused_epoch=True`` target's one-kernel
epoch is directly comparable against its unfused sibling in the same
``serve_load.json`` snapshot.
"""
from __future__ import annotations

import dataclasses
import weakref
from collections import deque
from typing import Optional

from repro_torch import api

# Live EngineMetrics instances, for the process-wide ``serve.*`` view in
# ``repro_torch.obs.snapshot()``.  A weak set: a retired engine's metrics are
# garbage like the engine itself — aggregation only ever sums the living.
_LIVE: "weakref.WeakSet" = weakref.WeakSet()


def global_counters() -> dict:
    """Summed counters over every live engine in this process — the
    ``serve`` namespace of ``repro_torch.obs.snapshot()``.  Per-instance
    ``EngineMetrics`` objects stay the source of truth; this is a read."""
    fields = (
        "requests_submitted", "requests_completed", "requests_evacuated",
        "requests_resumed", "frames_emitted", "steps_advanced",
        "batched_dispatches", "solo_dispatches", "kernel_dispatches",
        "buckets_retired", "pool_grows", "pool_shrinks",
    )
    out = {f: 0 for f in fields}
    engines = 0
    for m in list(_LIVE):
        engines += 1
        for f in fields:
            out[f] += getattr(m, f)
    out["engines"] = engines
    return out


@dataclasses.dataclass(frozen=True)
class StepMetrics:
    """One engine step's snapshot."""

    engine_step: int
    live_slots: int
    pool_slots: int
    queued: int
    batched_dispatches: int   # dispatches batching >= 2 live requests
    solo_dispatches: int      # dispatches advancing exactly 1 request
    steps_advanced: int       # time steps advanced, summed over requests
    queue_depth: dict         # "program_fp/target_fp" -> waiting requests

    @property
    def utilization(self) -> float:
        """Live slots over pool slots for this step (0.0 on an idle
        engine with no groups yet)."""
        return self.live_slots / self.pool_slots if self.pool_slots else 0.0


class EngineMetrics:
    """Aggregated engine counters plus a bounded step history."""

    def __init__(self, history_limit: int = 10_000) -> None:
        self.history: deque = deque(maxlen=int(history_limit))
        self.batched_dispatches = 0
        self.solo_dispatches = 0
        self.requests_submitted = 0
        self.requests_completed = 0
        self.requests_evacuated = 0   # drained to checkpoints (migration out)
        self.requests_resumed = 0     # admitted from checkpoints (migration in)
        self.frames_emitted = 0
        self.steps_advanced = 0
        self.kernel_dispatches = 0    # total timed dispatches (kernel launches)
        self.buckets_retired = 0      # idle buckets whose pools were freed
        self.pool_grows = 0
        self.pool_shrinks = 0
        self.autoscale_events: list = []   # PoolSizer provenance dicts
        # "program_fp/target_fp" -> {"batched": n, "solo": n} — the
        # per-bucket proof that a distributed bucket dispatched pooled
        self.bucket_dispatches: dict = {}
        # "program_fp/target_fp" -> bounded deque of dispatch wall seconds
        self.step_seconds: dict = {}
        self._latency_limit = int(history_limit)
        stats = api.cache_stats()
        self._cache_baseline = stats.as_dict()
        _LIVE.add(self)

    # -- recording (engine-internal) ------------------------------------
    def record_step(self, step: StepMetrics) -> None:
        self.history.append(step)
        self.batched_dispatches += step.batched_dispatches
        self.solo_dispatches += step.solo_dispatches
        self.steps_advanced += step.steps_advanced

    def record_dispatch(self, key: str, seconds: float) -> None:
        """One timed dispatch (batched or solo) for the fingerprint
        bucket ``key`` ("program_fp/target_fp"); the per-bucket window is
        bounded like the step history."""
        times = self.step_seconds.get(key)
        if times is None:
            times = self.step_seconds[key] = deque(maxlen=self._latency_limit)
        times.append(float(seconds))
        self.kernel_dispatches += 1

    def record_bucket_dispatch(self, key: str, batched: bool) -> None:
        """Per-bucket batched/solo tally — a ≥2-live distributed bucket
        on the pooled path must show ``batched > 0, solo == 0``."""
        d = self.bucket_dispatches.setdefault(key, {"batched": 0, "solo": 0})
        d["batched" if batched else "solo"] += 1

    def record_autoscale(self, event: dict) -> None:
        """One PoolSizer resize decision, with its queue/utilization
        provenance (the event dict ``PoolSizer.observe`` returned)."""
        self.autoscale_events.append(dict(event))
        if len(self.autoscale_events) > self._latency_limit:
            del self.autoscale_events[0]
        if event.get("action") == "grow":
            self.pool_grows += 1
        else:
            self.pool_shrinks += 1

    # -- reporting -------------------------------------------------------
    @property
    def engine_steps(self) -> int:
        return len(self.history)

    def mean_utilization(self) -> float:
        """Mean live/pool over the recorded (non-idle-pool) history."""
        rows = [m for m in self.history if m.pool_slots]
        if not rows:
            return 0.0
        return sum(m.utilization for m in rows) / len(rows)

    def step_latency(self) -> dict:
        """Per-fingerprint dispatch latency: key ->
        {"count", "mean_s", "p50_s", "p99_s", "max_s"} over the recorded
        window.  One dispatch advances a whole epoch (``exchange_every``
        time steps) for every live slot in the bucket.  Degenerate
        windows are well-defined: an empty window reports all-zero
        latencies with ``count: 0`` (instead of vanishing from the
        snapshot), and a single sample is its own p50/p99/max."""
        out = {}
        for key, times in self.step_seconds.items():
            ordered = sorted(times)
            if not ordered:
                out[key] = {"count": 0, "mean_s": 0.0, "p50_s": 0.0,
                            "p99_s": 0.0, "max_s": 0.0}
                continue
            out[key] = {
                "count": len(ordered),
                "mean_s": sum(ordered) / len(ordered),
                "p50_s": _quantile(ordered, 0.50),
                "p99_s": _quantile(ordered, 0.99),
                "max_s": ordered[-1],
            }
        return out

    def compile_cache(self) -> dict:
        """Process-wide compile-cache counters as deltas since this
        engine was constructed (hits = artifact/executable reuse across
        this engine's traffic)."""
        stats = api.cache_stats().as_dict()
        return {
            k: stats[k] - self._cache_baseline.get(k, 0) for k in stats
        }

    def snapshot(self, last: Optional[StepMetrics] = None) -> dict:
        last = last or (self.history[-1] if self.history else None)
        return {
            "engine_steps": self.engine_steps,
            "requests_submitted": self.requests_submitted,
            "requests_completed": self.requests_completed,
            "requests_evacuated": self.requests_evacuated,
            "requests_resumed": self.requests_resumed,
            "frames_emitted": self.frames_emitted,
            "steps_advanced": self.steps_advanced,
            "batched_dispatches": self.batched_dispatches,
            "solo_dispatches": self.solo_dispatches,
            "kernel_dispatches": self.kernel_dispatches,
            "buckets_retired": self.buckets_retired,
            "bucket_dispatches": {
                k: dict(v) for k, v in self.bucket_dispatches.items()
            },
            "autoscale": {
                "grows": self.pool_grows,
                "shrinks": self.pool_shrinks,
                "events": [dict(e) for e in self.autoscale_events],
            },
            "mean_utilization": self.mean_utilization(),
            "compile_cache": self.compile_cache(),
            "queue_depth": dict(last.queue_depth) if last else {},
            "step_latency": self.step_latency(),
        }


def _quantile(ordered: list, q: float) -> float:
    """Linear-interpolated quantile of a pre-sorted non-empty list."""
    if len(ordered) == 1:
        return ordered[0]
    pos = q * (len(ordered) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(ordered) - 1)
    frac = pos - lo
    return ordered[lo] * (1.0 - frac) + ordered[hi] * frac
