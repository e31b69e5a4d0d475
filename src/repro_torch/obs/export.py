# Copied from src/repro/obs/export.py with repro. renamed to repro_torch. and write_process_trace added; keep its logic in step with that file.
"""Trace export: Chrome trace-event JSON (Perfetto) and structured JSONL.

Chrome format (the ``{"traceEvents": [...]}`` container):

* one **pid per rank** — Perfetto renders each rank as its own process
  track, named via ``process_name`` metadata events;
* two **tids (lanes) per rank** — lane 0 "execute" for synchronous
  spans, lane 1 "comm" for async exchange windows, so an exchange
  window and the interior apply it hides are both visible and their
  overlap can be read off the timeline;
* ``ph: "X"`` complete events with ``ts``/``dur`` in microseconds
  (wall-clock epoch — comparable across processes).

SPMD spans (``rank=None``: the interpreter traces one program for every
rank) are **replicated** onto each rank's track with ``args.spmd: true``
— honest, because every rank executes exactly that program.

``merge_traces`` stitches per-rank trace files (written by separate
processes, e.g. ``tests/dist_worker.py`` subprocess ranks or a future
MPI backend where each host traces locally) into one timeline: wall
clocks are shared, so events interleave without offset surgery.
"""
from __future__ import annotations

import glob
import json
import os
from typing import Iterable, Optional, Sequence, Union

from repro_torch.obs.trace import LANE_NAMES, Span, tracer


def _span_ranks(spans: Sequence[Span], default_ranks: Optional[int]) -> int:
    """How many rank tracks the trace spans: the largest explicit rank
    tag, or the largest ``ranks`` arg an SPMD span carries."""
    n = int(default_ranks or 1)
    for s in spans:
        if s.rank is not None:
            n = max(n, int(s.rank) + 1)
        else:
            n = max(n, int(s.args.get("ranks", 1)))
    return n


def _event(s: Span, pid: int, spmd: bool) -> dict:
    args = dict(s.args)
    if spmd:
        args["spmd"] = True
    return {
        "name": s.name,
        "cat": s.cat,
        "ph": "X",
        "ts": s.ts * 1e6,
        "dur": s.dur * 1e6,
        "pid": pid,
        "tid": s.tid,
        "args": args,
    }


def _metadata(pids: Iterable[int]) -> list:
    out = []
    for pid in sorted(set(pids)):
        out.append({"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                    "args": {"name": f"rank {pid}"}})
        for tid, lane in LANE_NAMES.items():
            out.append({"name": "thread_name", "ph": "M", "pid": pid,
                        "tid": tid, "args": {"name": lane}})
    return out


def to_chrome(spans: Optional[Sequence[Span]] = None,
              ranks: Optional[int] = None) -> dict:
    """Spans (default: the live tracer's buffer) → Chrome trace dict."""
    spans = list(tracer().spans() if spans is None else spans)
    n = _span_ranks(spans, ranks)
    events = _metadata(range(n))
    for s in spans:
        if s.rank is not None:
            events.append(_event(s, int(s.rank), spmd=False))
        else:
            targets = range(int(s.args.get("ranks", n)))
            for r in targets:
                events.append(_event(s, r, spmd=n > 1))
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome(path: str, spans: Optional[Sequence[Span]] = None,
                 ranks: Optional[int] = None) -> str:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(to_chrome(spans, ranks=ranks), f)
    return path


def write_jsonl(path: str, spans: Optional[Sequence[Span]] = None) -> str:
    """Structured export: one span dict per line (``ts``/``dur`` in
    seconds, ``rank`` possibly null) — the machine-readable sibling."""
    spans = list(tracer().spans() if spans is None else spans)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        for s in spans:
            f.write(json.dumps(s.as_dict()) + "\n")
    return path


def write_rank_traces(directory: str,
                      spans: Optional[Sequence[Span]] = None,
                      ranks: Optional[int] = None,
                      prefix: str = "trace_rank") -> list:
    """One Chrome trace file per rank track (``<prefix><r>.json``) — the
    per-process shape a multi-host run produces natively, reassembled by
    ``merge_traces``.  SPMD spans land in every rank's file."""
    spans = list(tracer().spans() if spans is None else spans)
    n = _span_ranks(spans, ranks)
    os.makedirs(directory, exist_ok=True)
    paths = []
    for r in range(n):
        mine = []
        for s in spans:
            if s.rank is None:
                if r < int(s.args.get("ranks", n)):
                    mine.append(_event(s, r, spmd=n > 1))
            elif int(s.rank) == r:
                mine.append(_event(s, r, spmd=False))
        path = os.path.join(directory, f"{prefix}{r}.json")
        with open(path, "w") as f:
            json.dump({"traceEvents": _metadata([r]) + mine,
                       "displayTimeUnit": "ms"}, f)
        paths.append(path)
    return paths


def write_process_trace(directory: str) -> str:
    """This process's trace file, ``trace_rank<rank>.json``, in a run of one
    process a rank (``repro_torch.dist.processes``, which pins the
    tracer's rank): every span lands on this process's rank track, an
    SPMD span too (it ran here for this rank alone).  Each process writes
    its own; ``merge_traces`` puts them on one timeline, one lane set per
    process.  Nothing is collected across processes at run time."""
    r = tracer().rank
    if r is None:
        raise ValueError("write_process_trace: no process rank (repro_torch.dist.processes.init "
                         "or obs.set_rank pins it)")
    spans = list(tracer().spans())
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"trace_rank{r}.json")
    with open(path, "w") as f:
        json.dump({"traceEvents": _metadata([r]) + [_event(s, r, spmd=False) for s in spans],
                   "displayTimeUnit": "ms"}, f)
    return path


def merge_traces(source: Union[str, Sequence[str]],
                 out: Optional[str] = None) -> dict:
    """Merge per-rank Chrome trace files into one timeline.

    ``source`` is a directory (every ``*.json`` inside) or an explicit
    list of paths.  Ranks keep their pids; metadata events are deduped.
    Wall clocks are shared across local processes, so no time alignment
    is needed.  Writes the merged trace to ``out`` when given.
    """
    if isinstance(source, str):
        paths = sorted(glob.glob(os.path.join(source, "*.json")))
    else:
        paths = list(source)
    if not paths:
        raise ValueError(f"merge_traces: no trace files in {source!r}")
    events: list = []
    seen_meta = set()
    for path in paths:
        with open(path) as f:
            data = json.load(f)
        for ev in data.get("traceEvents", []):
            if ev.get("ph") == "M":
                key = (ev.get("name"), ev.get("pid"), ev.get("tid"))
                if key in seen_meta:
                    continue
                seen_meta.add(key)
            events.append(ev)
    merged = {"traceEvents": events, "displayTimeUnit": "ms"}
    if out is not None:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            json.dump(merged, f)
    return merged


def load_spans(path: str) -> list:
    """Read spans back from a trace file (Chrome ``.json`` or ``.jsonl``)
    for offline analysis (``python -m repro_torch.obs``, ``drift_report``)."""
    spans = []
    if path.endswith(".jsonl"):
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    spans.append(Span.from_dict(json.loads(line)))
        return spans
    with open(path) as f:
        data = json.load(f)
    events = data.get("traceEvents", data) if isinstance(data, dict) else data
    for ev in events:
        if ev.get("ph") != "X":
            continue
        spans.append(Span(
            name=ev.get("name", "?"),
            cat=ev.get("cat", "misc"),
            ts=float(ev.get("ts", 0.0)) / 1e6,
            dur=float(ev.get("dur", 0.0)) / 1e6,
            rank=ev.get("pid"),
            tid=int(ev.get("tid", 0)),
            args=dict(ev.get("args") or {}),
        ))
    return spans
