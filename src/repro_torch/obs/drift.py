# Copied from src/repro/obs/drift.py with repro. renamed to repro_torch.; keep its logic in step with that file.
"""Roofline-drift detection: measured epochs vs the performance model.

The stack *models* throughput (``launch/roofline.RooflineTerms.step_time``)
and *restructures* IR for comm/compute overlap
(``core/passes/overlap.split_overlapped_applies``) — this module closes
the loop by comparing what the tracer measured against both:

* **step-time drift** — the median traced ``epoch`` span, divided by the
  epoch depth ``k``, against ``terms.step_time(k)``.  ``drift_ratio``
  above 1 means the machine is slower than the model (untracked
  overheads, interpreter dispatch, cache misses); persistent drift on
  one phase is the signal the model's constants need re-measuring
  (ROADMAP: measured ``t_latency`` per interconnect).
* **achieved overlap** — the fraction of exchange-window time
  (``cat="comm"`` spans, exchange_start→wait) covered by interior-apply
  spans (``name="apply:interior"``).  The overlap pass promises the
  interior compute hides the exchange; this measures whether it did.

``drift_report()`` reads the live tracer by default; pass
``spans=load_spans(path)`` to analyze a saved trace offline.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence


def _median(xs: Sequence[float]) -> float:
    xs = sorted(xs)
    n = len(xs)
    mid = n // 2
    return xs[mid] if n % 2 else 0.5 * (xs[mid - 1] + xs[mid])


def _covered(window, intervals) -> float:
    """Length of ``window`` covered by the union of ``intervals``."""
    lo, hi = window
    clipped = sorted(
        (max(lo, a), min(hi, b)) for a, b in intervals if b > lo and a < hi
    )
    total, cursor = 0.0, lo
    for a, b in clipped:
        a = max(a, cursor)
        if b > a:
            total += b - a
            cursor = b
    return total


@dataclasses.dataclass
class DriftReport:
    """Model-vs-measured summary of one traced run."""

    epochs: int                      # traced epoch spans found
    exchange_every: int              # epoch depth k the measurement ran at
    measured_step_s: Optional[float]   # median epoch wall time / k
    modeled_step_s: Optional[float]    # RooflineTerms.step_time(k)
    drift_ratio: Optional[float]       # measured / modeled (>1: slower)
    error_pct: Optional[float]         # |measured-modeled| / modeled * 100
    overlap_windows: int               # exchange windows considered
    achieved_overlap: Optional[float]  # covered fraction of exchange time
    per_phase_s: dict                  # span category -> total seconds

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    def __str__(self) -> str:
        def fmt(v, unit=""):
            return "-" if v is None else f"{v:.3g}{unit}"

        rows = [
            ("epochs traced", str(self.epochs)),
            ("exchange_every", str(self.exchange_every)),
            ("measured step", fmt(self.measured_step_s, " s")),
            ("modeled step", fmt(self.modeled_step_s, " s")),
            ("drift ratio", fmt(self.drift_ratio, "x")),
            ("model error", fmt(self.error_pct, " %")),
            ("exchange windows", str(self.overlap_windows)),
            ("achieved overlap", fmt(
                None if self.achieved_overlap is None
                else self.achieved_overlap * 100, " %")),
        ]
        width = max(len(k) for k, _ in rows)
        lines = ["roofline drift", "-" * 14]
        lines += [f"{k:<{width}}  {v}" for k, v in rows]
        if self.per_phase_s:
            lines.append("per-phase totals:")
            for cat, sec in sorted(self.per_phase_s.items(),
                                   key=lambda kv: -kv[1]):
                lines.append(f"  {cat:<12} {sec * 1e3:10.3f} ms")
        return "\n".join(lines)


def drift_report(spans=None, terms=None,
                 exchange_every: Optional[int] = None) -> DriftReport:
    """Build a :class:`DriftReport` from traced spans.

    ``terms`` is a ``repro_torch.launch.roofline.RooflineTerms`` (e.g. from
    ``CompiledStencil.cost()``); without it the report carries measured
    numbers only (``modeled_step_s``/``drift_ratio`` are ``None``).
    ``exchange_every`` defaults to the ``k`` tag on the epoch spans.
    """
    if spans is None:
        from repro_torch.obs.trace import tracer

        spans = tracer().spans()
    spans = list(spans)

    epoch_spans = [s for s in spans if s.name == "epoch"]
    k = int(exchange_every or next(
        (int(s.args["k"]) for s in epoch_spans if "k" in s.args), 1
    ))
    measured = None
    if epoch_spans:
        measured = _median([s.dur for s in epoch_spans]) / max(1, k)

    modeled = drift = err = None
    if terms is not None:
        modeled = float(terms.step_time(k))
        if measured is not None and modeled > 0:
            drift = measured / modeled
            err = abs(measured - modeled) / modeled * 100.0

    comm = [s for s in spans if s.cat == "comm" and s.dur > 0]
    interior = [(s.ts, s.end) for s in spans if s.name == "apply:interior"]
    achieved = None
    if comm:
        total = sum(s.dur for s in comm)
        covered = sum(_covered((s.ts, s.end), interior) for s in comm)
        achieved = covered / total if total > 0 else None

    per_phase: dict = {}
    for s in spans:
        per_phase[s.cat] = per_phase.get(s.cat, 0.0) + s.dur

    return DriftReport(
        epochs=len(epoch_spans),
        exchange_every=k,
        measured_step_s=measured,
        modeled_step_s=modeled,
        drift_ratio=drift,
        error_pct=err,
        overlap_windows=len(comm),
        achieved_overlap=achieved,
        per_phase_s=per_phase,
    )
