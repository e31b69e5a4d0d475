"""Roofline-guided search over the candidate space (port of
``repro.tune.search``).

Three stages, each feeding the next:

1. **model** — every candidate is scored with the shared roofline model:
   one representative artifact per (decomposition, overlap) group is
   compiled (torch backend, k=1 — the cheapest member) and its
   ``CompiledStencil.cost()`` terms extrapolate the whole group via
   ``RooflineTerms.step_time(k)``.  Backend/tile variants share the
   group's modeled score — the roofline cannot tell them apart; only
   measurement can.
2. **prune** — candidates outside the top ``keep_quantile`` by modeled
   score are dropped from measurement (never the baseline: the default
   configuration is always measured so the win is quantified).
3. **measure** (optional) — ``measure.measure_compiled`` on every
   survivor (on the card through K1, K2 and the compiled step; their
   sources are built together first), timing vector agreed across
   processes, winner = argmin.  Each candidate's graphs and buffers are
   released once it is timed.

With ``measure=False`` the winner is the modeled argmin (ties resolve to
the earliest-enumerated, i.e. least exotic, candidate).  Results persist
through ``tune.cache`` keyed on (program fingerprint, hardware
signature, rank count, options digest).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch

from repro_torch.tune import cache as tune_cache
from repro_torch.tune import measure as tune_measure
from repro_torch.tune.space import Candidate, default_devices, enumerate_candidates


@dataclasses.dataclass
class TuneResult:
    """Outcome of one tuning run: the winner, the full ranked candidate
    list (live searches) or the cached summary (cache hits), and
    provenance."""

    program_fingerprint: str
    winner: Candidate
    candidates: list
    measured: bool
    from_cache: bool
    cache_key: str
    cache_path: Optional[str] = None
    hardware: str = ""
    n_ranks: int = 1

    @property
    def target(self):
        return self.winner.target

    def summary(self) -> list:
        if self.candidates:
            return [c.as_dict() for c in self.candidates]
        return []

    def table(self, top: Optional[int] = None) -> str:
        """The ranked candidate table (best first) as printable text."""
        rows = []
        cands = self.candidates[:top] if top else self.candidates
        for i, c in enumerate(cands):
            rows.append(
                (
                    i,
                    c.describe(),
                    _fmt(c.modeled_s),
                    _fmt(c.measured_s),
                    c.origin + (" PRUNED" if c.pruned else ""),
                )
            )
        headers = ("#", "candidate", "modeled/step", "measured/step", "origin")
        widths = [
            max(len(str(h)), max((len(str(r[i])) for r in rows), default=0))
            for i, h in enumerate(headers)
        ]
        out = ["  ".join(str(h).ljust(w) for h, w in zip(headers, widths))]
        for r in rows:
            out.append("  ".join(str(c).ljust(w) for c, w in zip(r, widths)))
        return "\n".join(out)


def _fmt(t: Optional[float]) -> str:
    if t is None:
        return "-"
    if not math.isfinite(t):
        return "inf"
    if t >= 1.0:
        return f"{t:.2f}s"
    if t >= 1e-3:
        return f"{t * 1e3:.3f}ms"
    return f"{t * 1e6:.3g}µs"


# --------------------------------------------------------------------------


def _group_representative(target):
    """The cheapest member of a candidate's cost group: same
    decomposition and overlap, torch backend, no tile, one exchange per
    step, per-step dispatch — the artifact whose roofline terms
    extrapolate the group (fused_epoch and tile are cuda-only knobs and
    are cleared along with the backend)."""
    return dataclasses.replace(
        target,
        backend="torch",
        tile=None,
        exchange_every=1,
        fused_epoch=False,
    )


def score_candidates(program, candidates: Sequence[Candidate]) -> None:
    """Fill ``modeled_s`` in place via the shared roofline model.  A
    group whose representative fails to compile poisons only that group
    (score = inf, note carries the error)."""
    from repro_torch import api

    terms_of: dict = {}
    for cand in candidates:
        rep = _group_representative(cand.target)
        key = rep.fingerprint
        if key not in terms_of:
            try:
                terms_of[key] = api.compile(program, rep).cost()
            except Exception as e:  # noqa: BLE001 - score, don't crash
                terms_of[key] = e
        terms = terms_of[key]
        if isinstance(terms, Exception):
            cand.modeled_s = float("inf")
            cand.pruned = True
            cand.note = f"model failed: {terms}"
            continue
        if not cand.target.distributed:
            # a single-device artifact's exchange ops are emulated locally
            # — no message exists, so the latency amortization term must
            # not reward deep epochs for a saving the hardware cannot
            # deliver
            terms = dataclasses.replace(terms, messages_per_epoch=0)
        cand.modeled_s = terms.step_time(cand.target.exchange_every)


def prune_candidates(
    candidates: Sequence[Candidate],
    keep_quantile: float = 0.25,
    min_keep: int = 3,
) -> list:
    """Mark everything outside the top modeled quantile ``pruned`` and
    return the survivors.  The baseline always survives."""
    scored = [
        c
        for c in candidates
        if c.modeled_s is not None and math.isfinite(c.modeled_s)
    ]
    n_keep = max(int(min_keep), math.ceil(keep_quantile * len(scored)))
    ranked = sorted(scored, key=lambda c: c.modeled_s)
    keep = set(id(c) for c in ranked[:n_keep])
    survivors = []
    for c in candidates:
        if id(c) in keep or (
            c.origin == "baseline" and c.modeled_s is not None
            and math.isfinite(c.modeled_s)
        ):
            c.pruned = False
            survivors.append(c)
        else:
            c.pruned = True
    return survivors


# --------------------------------------------------------------------------


def tune(
    program,
    ranks: Optional[int] = None,
    devices: Optional[Sequence] = None,
    measure: bool = True,
    cache: bool = True,
    transfer: bool = False,
    keep_quantile: float = 0.25,
    min_keep: int = 3,
    steps: int = 8,
    trials: int = 3,
    warmup: int = 1,
    backends: Sequence[str] = ("torch", "cuda"),
    exchange_every: Sequence[int] = (1, 2, 4, 8),
    overlap: Sequence[bool] = (False, True),
    fused_epoch: Sequence[bool] = (False, True),
    verbose: bool = False,
) -> TuneResult:
    """Search the ``Target`` space for ``program`` on this machine.

    ``devices`` are the ranks' devices (default: every card; they may
    repeat, e.g. ``[torch.device("cuda:0")] * 4`` for four ranks on one
    card, or the CPU for virtual ranks there); ``ranks`` takes the first
    that many.  ``measure=False`` selects on the cost model alone (no
    timed runs — cheap enough for CI); ``measure=True`` times the
    unpruned candidates and picks the measured argmin, identically on
    every process.

    ``transfer=True`` adds a cross-hardware warm start: when the primary
    cache key misses, the newest entry for the same program + options
    under a *different* hardware signature (other machine, or another
    rank count — elastic resume) is adopted if its winner rebuilds and
    validates here.  It counts as a ``transfer_hit`` (never a ``hit``),
    the winner's ``origin`` is ``"transfer"``, and nothing is stored
    under this machine's key — run a measured search to earn that entry.
    """
    devices = [torch.device(d) for d in devices] if devices is not None else default_devices()
    n_ranks = len(devices) if ranks is None else int(ranks)
    hardware = tune_cache.hardware_signature(devices[:n_ranks] or devices)
    digest = tune_cache.options_digest(
        measure=bool(measure),
        backends=sorted(backends),
        exchange_every=sorted(int(k) for k in exchange_every),
        overlap=sorted(bool(o) for o in overlap),
        fused_epoch=sorted(bool(f) for f in fused_epoch),
        keep_quantile=float(keep_quantile),
        min_keep=int(min_keep),
        # measurement protocol changes the winner's fidelity: a
        # high-trial search must not read back a noisy low-trial entry
        steps=int(steps),
        trials=int(trials),
        warmup=int(warmup),
    )
    key = tune_cache.cache_key(
        program.fingerprint, hardware, n_ranks, digest
    )

    if cache:
        cached = _load_cached(program, key, devices[:n_ranks])
        if cached is not None:
            cached.hardware = hardware
            cached.n_ranks = n_ranks
            return cached
        if transfer:
            moved = _load_transfer(program, key, n_ranks, digest, devices)
            if moved is not None:
                moved.hardware = hardware
                moved.n_ranks = n_ranks
                return moved

    candidates = enumerate_candidates(
        program,
        devices=devices,
        ranks=n_ranks,
        backends=backends,
        exchange_every=exchange_every,
        overlap=overlap,
        fused_epoch=fused_epoch,
    )
    score_candidates(program, candidates)
    survivors = prune_candidates(
        candidates, keep_quantile=keep_quantile, min_keep=min_keep
    )
    if not survivors:
        notes = "; ".join(sorted({c.note for c in candidates if c.note}))
        raise RuntimeError(
            f"tune: no candidate for program {program.fingerprint} could "
            "be modeled" + (f" ({notes})" if notes else "")
        )

    if measure:
        _measure_survivors(
            program, survivors, steps=steps, trials=trials, warmup=warmup,
            verbose=verbose,
        )
        measured = [c for c in survivors if c.measured_s is not None]
        pool = measured or survivors
        winner = min(
            pool,
            key=lambda c: (
                c.measured_s if c.measured_s is not None else c.modeled_s
            ),
        )
    else:
        winner = min(survivors, key=lambda c: c.modeled_s)

    candidates.sort(key=_rank_key)
    result = TuneResult(
        program_fingerprint=program.fingerprint,
        winner=winner,
        candidates=candidates,
        measured=bool(measure),
        from_cache=False,
        cache_key=key,
        hardware=hardware,
        n_ranks=n_ranks,
    )
    if cache:
        result.cache_path = tune_cache.store(
            key,
            {
                "program": program.fingerprint,
                "hardware": hardware,
                "n_ranks": n_ranks,
                "options": digest,
                "measured": bool(measure),
                "winner": tune_cache.target_to_dict(winner.target),
                "winner_modeled_s": winner.modeled_s,
                "winner_measured_s": winner.measured_s,
                "ranked": [c.as_dict() for c in candidates],
            },
        )
    return result


def _rank_key(c: Candidate):
    # measured candidates first (by measurement), then unmeasured by
    # modeled score, failures last
    measured = c.measured_s is not None
    score = c.measured_s if measured else c.modeled_s
    if score is None or not math.isfinite(score):
        return (2, float("inf"))
    return (0 if measured else 1, score)


def _build_sources(program, survivors) -> None:
    """Build every K1 and K2 source the survivors on the card launch, one
    ``nvcc`` each, all started together (a candidate's first call would
    otherwise build its sources one candidate after another).  A source
    that does not build raises."""
    from repro_torch import api
    from repro_torch.kernels import stencil_apply

    sources: list = []
    for cand in survivors:
        if _on_card(cand):
            sources += api.compile(program, cand.target).kernel_sources()
    if sources:
        stencil_apply.build(list(dict.fromkeys(sources)))


def _on_card(cand) -> bool:
    return cand.target.backend == "cuda" and torch.device(cand.target.device).type == "cuda"


def _measure_survivors(
    program, survivors, steps: int, trials: int, warmup: int, verbose: bool
) -> None:
    """Time every survivor.  A failure of a ``cuda`` candidate on the card
    (K1 or K2 that does not build or launch) raises: no kernel failure may
    leave a plain-version winner behind.  Any other failure is noted on
    its candidate, which then goes unmeasured."""
    from repro_torch import api

    # what the search compiles, it forgets again; what the caller had
    # compiled only loses its graphs
    ours = {c.fingerprint for c in survivors if not api.is_cached(program, c.target)}
    _build_sources(program, survivors)
    times: list = []
    states: dict = {}  # one fixed-seed state per device, shared by its candidates
    for cand in survivors:
        try:
            compiled = api.compile(program, cand.target)
            try:
                device = cand.target.device
                if device not in states:
                    states[device] = tune_measure.measurement_state(compiled)
                times.append(
                    tune_measure.measure_compiled(
                        compiled, steps=steps, trials=trials, warmup=warmup,
                        state=states[device],
                    )
                )
            finally:
                # a graphed 16384² step holds GiBs: release each candidate
                # once it is timed
                if cand.fingerprint in ours:
                    api.forget(program, cand.target)
                else:
                    compiled.release_graphs()
                del compiled
                if torch.device(cand.target.device).type == "cuda":
                    torch.cuda.empty_cache()
        except Exception as e:  # noqa: BLE001 - rank, don't crash
            if _on_card(cand):
                raise
            cand.note = f"measurement failed: {e}"
            times.append(None)
        if verbose:  # pragma: no cover - CLI chatter
            print(f"  measured {cand.describe()}: {_fmt(times[-1])}/step", flush=True)
    # all processes adopt process 0's clock before the argmin
    for cand, t in zip(survivors, tune_measure.agree_on_times(times)):
        cand.measured_s = t


def _load_transfer(
    program, key: str, n_ranks: int, digest: str, devices
) -> Optional[TuneResult]:
    """Warm-start from another hardware signature's entry (see
    ``cache.lookup_transfer``).  The result keys under THIS search's
    cache key but points its ``cache_path`` at the donor entry."""
    found = tune_cache.lookup_transfer(
        program, n_ranks, digest, devices=devices
    )
    if found is None:
        return None
    entry, target = found
    winner = Candidate(
        target=target,
        origin="transfer",
        modeled_s=entry.get("winner_modeled_s"),
        measured_s=entry.get("winner_measured_s"),
    )
    return TuneResult(
        program_fingerprint=program.fingerprint,
        winner=winner,
        candidates=[],
        measured=bool(entry.get("measured")),
        from_cache=True,
        cache_key=key,
        cache_path=(
            tune_cache.entry_path(entry["key"]) if entry.get("key") else None
        ),
    )


def _load_cached(program, key: str, devices) -> Optional[TuneResult]:
    entry = tune_cache.load(key)
    if entry is None:
        return None
    try:
        target = tune_cache.target_from_dict(entry["winner"], devices=devices)
    except (tune_cache.TuneCacheError, KeyError, ValueError):
        tune_cache.demote_hit_to_miss()
        return None
    # the rebuilt target must be the one that was tuned — device
    # inventory drift shows up as a fingerprint mismatch → miss
    if target.fingerprint != entry["winner"].get("fingerprint"):
        tune_cache.demote_hit_to_miss()
        return None
    from repro_torch import api

    try:
        api._validate_for_program(program, target)
    except api.TargetError:
        tune_cache.demote_hit_to_miss()
        return None
    winner = Candidate(
        target=target,
        origin="cached",
        modeled_s=entry.get("winner_modeled_s"),
        measured_s=entry.get("winner_measured_s"),
    )
    return TuneResult(
        program_fingerprint=program.fingerprint,
        winner=winner,
        candidates=[],
        measured=bool(entry.get("measured")),
        from_cache=True,
        cache_key=key,
        cache_path=tune_cache.entry_path(key),
    )
