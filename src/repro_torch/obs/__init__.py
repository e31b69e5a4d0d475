"""``repro_torch.obs`` — span tracing, trace export and roofline-drift
detection (port of ``repro.obs``, DESIGN.md §12).

Quickstart::

    from repro_torch import api, obs

    obs.enable()                       # or REPRO_TRACE=1 in the env
    step = api.compile(prog, api.Target(backend="cuda", exchange_every=4))
    out = step.time_loop((u0,), 32)    # traced: one span per epoch,
                                       # exchange windows on the comm lane
    obs.write_chrome("trace.json")     # open in https://ui.perfetto.dev
    print(obs.drift_report(terms=step.cost()))   # model vs measured

Tracing is off by default and the disabled path costs one attribute
check per instrumented site — see ``repro_torch.obs.trace``.  With
tracing on, the compiled step runs op by op (no CUDA graph replay) and
each epoch span closes after the card has finished the epoch.

``trace``, ``export`` and ``drift`` are copies of the reference's
modules.  Not ported yet: the unified registry (``snapshot``,
``NAMESPACES``) and the ``python -m`` summary, which read the serving
engine's counters (ROADMAP Queue 1 item 6).
"""
from repro_torch.obs.drift import DriftReport, drift_report
from repro_torch.obs.export import (
    load_spans,
    merge_traces,
    to_chrome,
    write_chrome,
    write_jsonl,
    write_rank_traces,
)
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
    "write_rank_traces",
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
