"""``repro_torch.obs`` — span tracing, the unified counter registry, trace
export and roofline-drift detection (port of ``repro.obs``, DESIGN.md §12).

Quickstart::

    from repro_torch import api, obs

    obs.enable()                       # or REPRO_TRACE=1 in the env
    step = api.compile(prog, api.Target(backend="cuda", exchange_every=4))
    out = step.time_loop((u0,), 32)    # traced: one span per epoch,
                                       # exchange windows on the comm lane
    obs.write_chrome("trace.json")     # open in https://ui.perfetto.dev
    print(obs.drift_report(terms=step.cost()))   # model vs measured
    print(obs.snapshot())              # every subsystem's counters

Tracing is off by default and the disabled path costs one attribute
check per instrumented site — see ``repro_torch.obs.trace``.  With
tracing on, the compiled step runs op by op (no CUDA graph replay) and
each epoch span closes after the card has finished the epoch.
Summarize a saved trace offline with ``python -m repro_torch.obs
trace.json`` (``--snapshot``: the live process's counters).

``trace``, ``export``, ``drift``, ``registry`` and ``__main__`` are copies
of the reference's modules; the registry reads this package's counters
(``kernel``: K1 and K2 calls and launches).
"""
from repro_torch.obs.drift import DriftReport, drift_report
from repro_torch.obs.export import (
    load_spans,
    merge_traces,
    to_chrome,
    write_chrome,
    write_jsonl,
    write_process_trace,
    write_rank_traces,
)
from repro_torch.obs.registry import NAMESPACES, snapshot
from repro_torch.obs.trace import (
    LANE_COMM,
    LANE_EXECUTE,
    Span,
    Tracer,
    begin_window,
    clear,
    disable,
    enable,
    enabled,
    end_window,
    instant,
    set_rank,
    span,
    spans,
    traced,
    tracer,
)

__all__ = [
    "DriftReport",
    "drift_report",
    "load_spans",
    "merge_traces",
    "to_chrome",
    "write_chrome",
    "write_jsonl",
    "write_process_trace",
    "write_rank_traces",
    "NAMESPACES",
    "snapshot",
    "LANE_COMM",
    "LANE_EXECUTE",
    "Span",
    "Tracer",
    "begin_window",
    "clear",
    "disable",
    "enable",
    "enabled",
    "end_window",
    "instant",
    "set_rank",
    "span",
    "spans",
    "traced",
    "tracer",
]
