# Copied from src/repro/obs/registry.py with repro. renamed to repro_torch.; keep its logic in step with that file.
"""One snapshot over the stack's counter islands.

Before ``repro_torch.obs`` each subsystem kept truthful but *disjoint*
counters: the compile cache (``api.cache_stats``), the pass pipeline
(``PassManager.runs_completed``), kernel dispatch
(``kernels.dispatch_stats``), the serve engine (per-instance
``EngineMetrics``), checkpointing (per-``Checkpointer``
``CheckpointStats``) and the tune cache (``tune.cache.cache_stats``).
``snapshot()`` unifies them behind one namespaced dict —

    {"compile": {...}, "kernel": {...}, "serve": {...},
     "checkpoint": {...}, "tune": {...}, "trace": {...}}

— without changing any per-subsystem API: the islands remain the source
of truth and this module only *reads* them (per-instance islands are
aggregated through lightweight process-wide hooks:
``serve.stencil.metrics.global_counters`` sums over live engines via a
weak set, ``checkpoint.checkpointer.global_stats`` mirrors every
instance bump).  Imports are lazy so ``import repro_torch.obs`` stays cheap
and cycle-free.
"""
from __future__ import annotations

NAMESPACES = ("compile", "kernel", "serve", "checkpoint", "tune")


def snapshot(flat: bool = False) -> dict:
    """All counter islands, namespaced.  ``flat=True`` flattens to
    dotted keys (``{"compile.hits": 3, ...}``) for log lines."""
    from repro_torch import api
    from repro_torch import kernels
    from repro_torch.checkpoint import checkpointer as _ckpt
    from repro_torch.core.passes import PassManager
    from repro_torch.obs import trace as _trace
    from repro_torch.serve.stencil import metrics as _serve_metrics
    from repro_torch.tune import cache as _tune_cache

    out = {
        "compile": {
            **api.cache_stats().as_dict(),
            "cache_capacity": api.cache_capacity(),
            "pipeline_runs": int(PassManager.runs_completed),
        },
        "kernel": kernels.dispatch_stats().as_dict(),
        "serve": _serve_metrics.global_counters(),
        "checkpoint": _ckpt.global_stats().as_dict(),
        "tune": _tune_cache.cache_stats().as_dict(),
        "trace": _trace.tracer().counters(),
    }
    if not flat:
        return out
    return {
        f"{ns}.{key}": val
        for ns, counters in out.items()
        for key, val in counters.items()
    }
