# Copied from src/repro/obs/__main__.py with repro. renamed to repro_torch.; keep its logic in step with that file.
"""Trace summarizer: ``python -m repro_torch.obs <trace.json|trace.jsonl>``.

Prints the top spans by total time, per-phase (category) totals, and
the roofline-drift table the trace supports (measured-only offline —
pass the modeled step time with ``--modeled-step`` to get drift ratios
against a run's ``CompiledStencil.cost().step_time(k)``).

``python -m repro_torch.obs --snapshot`` prints the live process's unified
counter registry instead (mostly useful under a REPL/driver that has
already exercised the stack).
"""
from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict

from repro_torch.obs.drift import drift_report
from repro_torch.obs.export import load_spans
from repro_torch.obs.registry import snapshot


def _table(title: str, rows: list, headers: list) -> str:
    widths = [
        max(len(str(h)), max((len(str(r[i])) for r in rows), default=0))
        for i, h in enumerate(headers)
    ]
    out = [title, "-" * len(title),
           "  ".join(str(h).ljust(w) for h, w in zip(headers, widths))]
    for r in rows:
        out.append("  ".join(str(c).ljust(w) for c, w in zip(r, widths)))
    return "\n".join(out)


def summarize(path: str, top: int = 15,
              modeled_step: float = 0.0) -> str:
    spans = load_spans(path)
    if not spans:
        return f"{path}: no spans"
    lines = [f"{path}: {len(spans)} spans"]

    by_name: dict = defaultdict(lambda: [0, 0.0])
    by_cat: dict = defaultdict(float)
    for s in spans:
        row = by_name[s.name]
        row[0] += 1
        row[1] += s.dur
        by_cat[s.cat] += s.dur

    rows = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    lines.append(_table(
        f"top spans (by total time, showing {len(rows)})",
        [(name, n, f"{tot * 1e3:.3f}", f"{tot / n * 1e3:.3f}")
         for name, (n, tot) in rows],
        ["span", "count", "total ms", "mean ms"],
    ))
    lines.append(_table(
        "per-phase totals",
        [(cat, f"{tot * 1e3:.3f}")
         for cat, tot in sorted(by_cat.items(), key=lambda kv: -kv[1])],
        ["phase", "total ms"],
    ))

    class _FixedTerms:  # offline stand-in for RooflineTerms
        def step_time(self, k):
            return modeled_step

    report = drift_report(
        spans, terms=_FixedTerms() if modeled_step > 0 else None
    )
    lines.append(str(report))
    return "\n\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("trace", nargs="?", help="Chrome .json or .jsonl trace")
    ap.add_argument("--top", type=int, default=15,
                    help="how many span names to list (default 15)")
    ap.add_argument("--modeled-step", type=float, default=0.0,
                    help="modeled seconds/step for drift ratios")
    ap.add_argument("--snapshot", action="store_true",
                    help="print the live unified counter registry")
    args = ap.parse_args(argv)

    if args.snapshot:
        print(json.dumps(snapshot(), indent=1, default=str))
        return 0
    if not args.trace:
        ap.error("give a trace file or --snapshot")
    print(summarize(args.trace, top=args.top,
                    modeled_step=args.modeled_step))
    return 0


if __name__ == "__main__":
    sys.exit(main())
