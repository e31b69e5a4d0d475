# Copied from src/repro/obs/trace.py with repro. renamed to repro_torch.; keep its logic in step with that file.
"""Low-overhead span tracer: the timeline behind ``repro_torch.obs``.

Spans are wall-clock windows — a pass in ``PassManager.run``, one epoch
of a time loop, one exchange_start→wait window, one pooled serve
dispatch — collected in a thread-safe **bounded ring buffer** and tagged
with a rank so multi-process runs merge into one Perfetto timeline
(``repro_torch.obs.export``).

Design constraints (DESIGN.md §12):

* **Off by default, near-zero cost when off.**  ``span()`` returns a
  shared no-op context manager after a single attribute check; no dict
  is built, nothing is allocated, nothing is locked.  Hot paths that
  want to skip even argument construction guard with ``enabled()``.
* **Nestable + thread-safe.**  Depth bookkeeping is thread-local; the
  ring buffer append is guarded by a lock.  ``tid`` is a *lane*, not an
  OS thread: lane 0 carries synchronous execute spans, lane 1 carries
  async comm windows (which overlap lane-0 spans — that overlap IS the
  measurement).
* **Rank/process tagged.**  ``rank=None`` marks an SPMD span: the
  interpreter traces one program for every rank, so the span is true of
  each of them; the exporter replicates it onto every rank's track.

Enable with ``REPRO_TRACE=1`` in the environment or ``obs.enable()`` at
runtime; ``REPRO_TRACE_RANK`` / ``set_rank()`` pins the process rank;
``REPRO_TRACE_CAPACITY`` bounds the ring buffer (default 65536 spans,
oldest dropped first, drops counted truthfully).
"""
from __future__ import annotations

import dataclasses
import functools
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Optional

# lanes: Chrome complete events on one tid must nest properly, but an
# exchange window deliberately OVERLAPS the interior-apply span it hides.
# Putting comm windows on their own lane keeps both visible in Perfetto.
LANE_EXECUTE = 0
LANE_COMM = 1
LANE_NAMES = {LANE_EXECUTE: "execute", LANE_COMM: "comm"}


@dataclasses.dataclass
class Span:
    """One closed interval on the timeline.

    ``ts`` is wall-clock seconds (``time.time`` epoch — comparable across
    processes, which is what lets ``merge_traces`` interleave per-rank
    files); ``dur`` is measured with ``time.perf_counter`` so short spans
    keep full resolution.
    """

    name: str
    cat: str = "misc"
    ts: float = 0.0
    dur: float = 0.0
    rank: Optional[int] = None  # None = SPMD: true of every rank
    tid: int = LANE_EXECUTE
    depth: int = 0
    args: dict = dataclasses.field(default_factory=dict)

    @property
    def end(self) -> float:
        return self.ts + self.dur

    def as_dict(self) -> dict:
        return {
            "name": self.name,
            "cat": self.cat,
            "ts": self.ts,
            "dur": self.dur,
            "rank": self.rank,
            "tid": self.tid,
            "depth": self.depth,
            "args": dict(self.args),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Span":
        return cls(
            name=d["name"],
            cat=d.get("cat", "misc"),
            ts=float(d.get("ts", 0.0)),
            dur=float(d.get("dur", 0.0)),
            rank=d.get("rank"),
            tid=int(d.get("tid", LANE_EXECUTE)),
            depth=int(d.get("depth", 0)),
            args=dict(d.get("args") or {}),
        )


class _NullSpan:
    """Shared do-nothing context manager: the entire cost of a disabled
    ``with obs.span(...):`` is one attribute check and returning this."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    @property
    def args(self) -> dict:  # writes to a disabled span go nowhere
        return {}


_NULL = _NullSpan()


class _SpanHandle:
    """Live span context manager; commits the span on exit."""

    __slots__ = ("_tracer", "_span", "_t0")

    def __init__(self, tracer: "Tracer", span: Span) -> None:
        self._tracer = tracer
        self._span = span
        self._t0 = 0.0

    @property
    def args(self) -> dict:
        return self._span.args

    def __enter__(self) -> "_SpanHandle":
        tls = self._tracer._tls
        self._span.depth = getattr(tls, "depth", 0)
        tls.depth = self._span.depth + 1
        self._span.ts = time.time()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self._span.dur = time.perf_counter() - self._t0
        tls = self._tracer._tls
        tls.depth = max(0, getattr(tls, "depth", 1) - 1)
        self._tracer._commit(self._span)
        return False


class Tracer:
    """Thread-safe bounded span collector (see module docstring)."""

    def __init__(self, capacity: Optional[int] = None) -> None:
        if capacity is None:
            capacity = int(os.environ.get("REPRO_TRACE_CAPACITY", 65536))
        self.capacity = max(1, int(capacity))
        self._buf: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._tls = threading.local()
        self.dropped = 0
        self.enabled = os.environ.get("REPRO_TRACE", "") not in ("", "0")
        rank_env = os.environ.get("REPRO_TRACE_RANK", "")
        self.rank: Optional[int] = int(rank_env) if rank_env else None

    # -- control ---------------------------------------------------------
    def enable(self, capacity: Optional[int] = None) -> None:
        if capacity is not None and int(capacity) != self.capacity:
            with self._lock:
                self.capacity = max(1, int(capacity))
                self._buf = deque(self._buf, maxlen=self.capacity)
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()
            self.dropped = 0

    def set_rank(self, rank: Optional[int]) -> None:
        self.rank = None if rank is None else int(rank)

    # -- recording -------------------------------------------------------
    def span(self, name: str, cat: str = "misc", rank: Any = "inherit",
             tid: int = LANE_EXECUTE, **args):
        """Context manager timing a block.  ``rank=None`` marks the span
        SPMD (replicated to every rank's track on export); the default
        inherits the tracer's process rank."""
        if not self.enabled:
            return _NULL
        r = self.rank if rank == "inherit" else rank
        return _SpanHandle(self, Span(name=name, cat=cat, rank=r, tid=tid,
                                      args=args))

    def instant(self, name: str, cat: str = "misc", rank: Any = "inherit",
                tid: int = LANE_EXECUTE, **args) -> None:
        """A zero-duration event (autoscaler decision, evacuation, ...)."""
        if not self.enabled:
            return
        r = self.rank if rank == "inherit" else rank
        self._commit(Span(name=name, cat=cat, ts=time.time(), dur=0.0,
                          rank=r, tid=tid,
                          depth=getattr(self._tls, "depth", 0), args=args))

    def begin_window(self, name: str, cat: str = "comm", rank: Any = "inherit",
                     tid: int = LANE_COMM, **args) -> Optional[dict]:
        """Open an *async* window (exchange_start → wait spans that cannot
        be expressed as a ``with`` block).  Returns an opaque token to
        pass to ``end_window``; ``None`` when tracing is disabled."""
        if not self.enabled:
            return None
        r = self.rank if rank == "inherit" else rank
        return {
            "span": Span(name=name, cat=cat, ts=time.time(), rank=r, tid=tid,
                         depth=getattr(self._tls, "depth", 0), args=args),
            "t0": time.perf_counter(),
        }

    def end_window(self, token: Optional[dict], **extra_args) -> None:
        if token is None:
            return
        sp: Span = token["span"]
        sp.dur = time.perf_counter() - token["t0"]
        if extra_args:
            sp.args.update(extra_args)
        self._commit(sp)

    def _commit(self, span: Span) -> None:
        with self._lock:
            if len(self._buf) == self._buf.maxlen:
                self.dropped += 1
            self._buf.append(span)

    # -- reading ---------------------------------------------------------
    def spans(self) -> list:
        """Snapshot of the ring buffer, oldest first."""
        with self._lock:
            return list(self._buf)

    def counters(self) -> dict:
        with self._lock:
            n = len(self._buf)
        return {
            "enabled": self.enabled,
            "spans": n,
            "dropped": self.dropped,
            "capacity": self.capacity,
            "rank": self.rank,
        }


# --------------------------------------------------------------------------
# Module-level singleton API (what the instrumented subsystems import)
# --------------------------------------------------------------------------

_TRACER = Tracer()


def tracer() -> Tracer:
    return _TRACER


def enable(capacity: Optional[int] = None) -> None:
    _TRACER.enable(capacity)


def disable() -> None:
    _TRACER.disable()


def enabled() -> bool:
    return _TRACER.enabled


def clear() -> None:
    _TRACER.clear()


def set_rank(rank: Optional[int]) -> None:
    _TRACER.set_rank(rank)


def spans() -> list:
    return _TRACER.spans()


def span(name: str, cat: str = "misc", rank: Any = "inherit",
         tid: int = LANE_EXECUTE, **args):
    if not _TRACER.enabled:  # fast path: no kwargs dict reaches the tracer
        return _NULL
    return _TRACER.span(name, cat=cat, rank=rank, tid=tid, **args)


def instant(name: str, cat: str = "misc", rank: Any = "inherit",
            tid: int = LANE_EXECUTE, **args) -> None:
    _TRACER.instant(name, cat=cat, rank=rank, tid=tid, **args)


def begin_window(name: str, cat: str = "comm", rank: Any = "inherit",
                 tid: int = LANE_COMM, **args) -> Optional[dict]:
    return _TRACER.begin_window(name, cat=cat, rank=rank, tid=tid, **args)


def end_window(token: Optional[dict], **extra_args) -> None:
    _TRACER.end_window(token, **extra_args)


def traced(name_or_fn: Any = None, cat: str = "func") -> Callable:
    """Decorator form: ``@traced`` or ``@traced("custom.name", cat=...)``.
    Adds one boolean check per call when tracing is disabled."""

    def deco(fn: Callable, _name: Optional[str] = None) -> Callable:
        label = _name or getattr(fn, "__qualname__", fn.__name__)

        @functools.wraps(fn)
        def wrapper(*a, **kw):
            if not _TRACER.enabled:
                return fn(*a, **kw)
            with _TRACER.span(label, cat=cat):
                return fn(*a, **kw)

        return wrapper

    if callable(name_or_fn):  # bare @traced
        return deco(name_or_fn)
    return lambda fn: deco(fn, name_or_fn)
