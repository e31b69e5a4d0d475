"""repro_torch.tune — roofline-guided autotuning of ``Target``
configurations (port of ``repro.tune``).

The compile surface exposes a multi-dimensional ``Target`` space: mesh
factorization, comm/compute overlap, temporal-tiling depth
(``exchange_every``), backend (torch, or cuda through kernels K1 and K2),
the fused epoch and K2's tile.  This package searches it:

    from repro_torch.tune import tune
    result = tune(program)                 # enumerate → model → measure
    step = repro_torch.compile(program, result.target)

or through the compile surface itself:

    target = repro_torch.Target.tuned(program)           # same search, cached
    step = repro_torch.api.compile(program, tune=True)   # tune + compile

It runs on the card by default (every candidate timed through K1, K2 and
the compiled step); ``devices=[torch.device("cpu")] * ranks`` runs it on
virtual CPU ranks through the plain versions.  ``tune(measure=False)``
selects on the shared roofline model alone (no timed runs); results
persist on disk (``tune.cache``) keyed by program fingerprint × hardware
signature × rank count.

    python -m repro_torch.tune          # ranked table for the fig7 heat kernel
"""
from repro_torch.tune.cache import (
    cache_dir,
    cache_stats,
    hardware_signature,
    lookup_transfer,
    reset_cache_stats,
    target_from_dict,
    target_to_dict,
)
from repro_torch.tune.measure import agree_on_times, measure_compiled
from repro_torch.tune.search import TuneResult, prune_candidates, score_candidates, tune
from repro_torch.tune.space import Candidate, enumerate_candidates

__all__ = [
    "Candidate",
    "TuneResult",
    "agree_on_times",
    "cache_dir",
    "cache_stats",
    "enumerate_candidates",
    "hardware_signature",
    "lookup_transfer",
    "measure_compiled",
    "prune_candidates",
    "reset_cache_stats",
    "score_candidates",
    "target_from_dict",
    "target_to_dict",
    "tune",
]
