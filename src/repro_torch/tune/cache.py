"""Persistent on-disk tuning cache (port of ``repro.tune.cache``).

Tuned configurations outlive the process that searched for them: a JSON
entry per cache key under ``$REPRO_TORCH_TUNE_CACHE`` (or
``~/.cache/repro-torch-tune/``; the reference's directory is another, so
neither package reads the other's entries), keyed by

    sha256(schema | program fingerprint | hardware signature |
           rank count | search-options digest)

so a result is only reused when the program, the hardware it was tuned
on, the rank count *and* the search configuration all match.  Entries
carry a ``schema`` version: bumping ``SCHEMA_VERSION`` invalidates every
old entry (they read as misses, never as wrong answers).

``Target`` serialization lives here too (``target_to_dict`` /
``target_from_dict``): a mesh is stored as (axis names, axis sizes) and
re-materialized from the *current* device inventory at load time; the
stored target fingerprint is re-checked after reconstruction, so an
entry written on different devices misses instead of lying.
``target_from_dict`` also reads a dict the reference's
``target_to_dict`` wrote (backend ``jnp``/``pallas``, ``pallas_tile``).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import tempfile
import time
from typing import Optional, Sequence

import numpy as np
import torch

SCHEMA_VERSION = 1

# the reference's backend names and their counterparts here
_BACKENDS = {"jnp": "torch", "pallas": "cuda", "torch": "torch", "cuda": "cuda"}


class TuneCacheError(ValueError):
    """A cache entry that cannot be rebuilt on this machine (not enough
    devices, unknown fields) — callers treat it as a miss."""


def cache_dir() -> str:
    """``$REPRO_TORCH_TUNE_CACHE`` or ``~/.cache/repro-torch-tune``; not
    created until the first ``store``."""
    env = os.environ.get("REPRO_TORCH_TUNE_CACHE")
    if env:
        return env
    return os.path.join(
        os.environ.get("XDG_CACHE_HOME", os.path.expanduser("~/.cache")),
        "repro-torch-tune",
    )


@dataclasses.dataclass
class TuneCacheStats:
    hits: int = 0
    misses: int = 0
    stores: int = 0
    # cross-hardware warm starts (``lookup_transfer``) — counted apart
    # from ``hits`` because a transferred winner was tuned on DIFFERENT
    # hardware: it is a good starting point, not a verified local fact
    transfer_hits: int = 0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


_STATS = TuneCacheStats()


def cache_stats() -> TuneCacheStats:
    """Process-wide tuning-cache counters (disk hits/misses/stores)."""
    return _STATS


def reset_cache_stats() -> None:
    _STATS.hits = 0
    _STATS.misses = 0
    _STATS.stores = 0
    _STATS.transfer_hits = 0


# --------------------------------------------------------------------------
# keys
# --------------------------------------------------------------------------


def hardware_signature(devices: Optional[Sequence] = None) -> str:
    """Stable description of the device inventory a tuning ran on:
    ``cuda:<card name>:n<ranks>`` or ``cpu:cpu:n<ranks>`` — the quantities
    that change the winner (not device indices)."""
    if devices is None:
        from repro_torch.tune.space import default_devices

        devices = default_devices()
    d = torch.device(devices[0])
    kind = torch.cuda.get_device_name(d) if d.type == "cuda" else d.type
    return f"{d.type}:{kind}:n{len(devices)}"


def options_digest(**options) -> str:
    """Digest of the search options that change the candidate space (and
    therefore the winner's identity): measurement on/off, backends, epoch
    depths, pruning knobs."""
    text = json.dumps(options, sort_keys=True, default=str)
    return hashlib.sha256(text.encode()).hexdigest()[:12]


def cache_key(
    program_fingerprint: str,
    hardware: str,
    n_ranks: int,
    options: str,
) -> str:
    text = "\n".join(
        [
            f"schema={SCHEMA_VERSION}",
            f"program={program_fingerprint}",
            f"hardware={hardware}",
            f"ranks={int(n_ranks)}",
            f"options={options}",
        ]
    )
    return hashlib.sha256(text.encode()).hexdigest()[:24]


def entry_path(key: str) -> str:
    return os.path.join(cache_dir(), f"{key}.json")


# --------------------------------------------------------------------------
# Target <-> dict
# --------------------------------------------------------------------------


def target_to_dict(target) -> dict:
    """JSON-able description of a ``repro_torch.api.Target`` (devices
    elided — the mesh is stored as axis names + sizes, the device type as
    ``device``)."""
    d = {
        "backend": target.backend,
        "pipeline": target.pipeline,
        "fuse": target.fuse,
        "cse": target.cse,
        "overlap": target.overlap,
        "diagonal": target.diagonal,
        "exchange_every": target.exchange_every,
        "slot_axis": target.slot_axis,
        "fused_epoch": target.fused_epoch,
        "tile": list(target.tile) if target.tile else None,
        "device": target.device,
        "donate": target.donate,
        "jit": target.jit,
        "mesh": None,
        "strategy": None,
        "fingerprint": target.fingerprint,
    }
    if target.mesh is not None:
        d["mesh"] = {
            "axes": list(target.mesh.axis_names),
            "shape": [int(target.mesh.shape[a]) for a in target.mesh.axis_names],
        }
    if target.strategy is not None:
        s = target.strategy
        d["strategy"] = {
            "grid": list(s.grid_shape),
            "axes": list(s.axis_names),
            "dims": list(s.dims),
        }
    return d


def target_from_dict(d: dict, devices: Optional[Sequence] = None):
    """Rebuild a ``Target`` from ``target_to_dict`` output (this package's
    or the reference's) against ``devices`` (default: the CPU repeated
    for a ``cpu`` entry, else every card).  A reference dict maps
    ``jnp``→``torch``, ``pallas``→``cuda`` and ``pallas_tile``→``tile``;
    its ``pallas_interpret`` is ignored, and it has no ``device``, so the
    devices decide.  Raises ``TuneCacheError`` when the entry needs more
    devices than exist or does not make a valid target here."""
    from repro_torch.api import Target, TargetError
    from repro_torch.core.passes.decompose import SlicingStrategy
    from repro_torch.dist import Mesh

    backend = _BACKENDS.get(d["backend"])
    if backend is None:
        raise TuneCacheError(f"unknown backend {d['backend']!r}")
    device = d.get("device")
    if devices is not None:
        devs = [torch.device(x) for x in devices]
    elif device is not None and torch.device(device).type == "cpu":
        devs = None  # as many CPU ranks as the mesh has
    else:
        from repro_torch.tune.space import default_devices

        try:
            devs = default_devices()
        except TargetError as e:
            raise TuneCacheError(str(e)) from e
    where: dict = {}
    if d.get("mesh"):
        shape = tuple(int(x) for x in d["mesh"]["shape"])
        n = int(np.prod(shape))
        devs = devs if devs is not None else [torch.device("cpu")] * n
        if n > len(devs):
            raise TuneCacheError(
                f"cached mesh needs {n} devices, have {len(devs)}"
            )
        where["mesh"] = Mesh(
            np.array(devs[:n], dtype=object).reshape(shape), tuple(d["mesh"]["axes"])
        )
        if device is not None:
            where["device"] = device
    else:
        where["device"] = device if device is not None else str(devs[0])
    if d.get("strategy"):
        s = d["strategy"]
        where["strategy"] = SlicingStrategy(
            tuple(int(g) for g in s["grid"]),
            tuple(s["axes"]),
            tuple(int(x) for x in s["dims"]),
        )
    tile = d.get("tile", d.get("pallas_tile"))
    try:
        return Target(
            backend=backend,
            pipeline=d.get("pipeline"),
            fuse=bool(d.get("fuse", True)),
            cse=bool(d.get("cse", True)),
            overlap=bool(d.get("overlap", False)),
            diagonal=bool(d.get("diagonal", False)),
            exchange_every=int(d.get("exchange_every", 1)),
            slot_axis=d.get("slot_axis"),
            fused_epoch=bool(d.get("fused_epoch", False)),
            tile=tuple(tile) if tile else None,
            donate=bool(d.get("donate", False)),
            jit=bool(d.get("jit", True)),
            **where,
        )
    except TargetError as e:
        raise TuneCacheError(f"the entry makes no valid target here: {e}") from e


# --------------------------------------------------------------------------
# load / store
# --------------------------------------------------------------------------


def load(key: str) -> Optional[dict]:
    """The entry for ``key``, or ``None`` (counted as a miss).  Corrupt
    files and schema mismatches are misses, never errors."""
    path = entry_path(key)
    try:
        with open(path) as f:
            entry = json.load(f)
    except (OSError, ValueError):
        _STATS.misses += 1
        return None
    if not isinstance(entry, dict) or entry.get("schema") != SCHEMA_VERSION:
        _STATS.misses += 1
        return None
    _STATS.hits += 1
    return entry


def demote_hit_to_miss() -> None:
    """An entry that *loaded* but failed semantic validation (device
    inventory drift, stale strategy, program mismatch) is a miss, not a
    hit — callers that reject a loaded entry call this so the counters
    report what actually happened: the search ran."""
    _STATS.hits -= 1
    _STATS.misses += 1


def lookup_transfer(
    program,
    n_ranks: int,
    options: str,
    devices: Optional[Sequence] = None,
) -> Optional[tuple]:
    """Cross-hardware warm start: the newest entry tuned for the SAME
    program and search options under a DIFFERENT hardware signature,
    whose winner still rebuilds and validates here.

    Returns ``(entry, target)`` or ``None``.  A success counts as a
    ``transfer_hit`` — never a ``hit`` — because the winner was ranked
    on other hardware: it is a plausible starting configuration, not a
    verified local fact, and nothing is re-stored under this machine's
    key (a later measured search writes that entry honestly).  The same
    safety gates as a primary hit apply: the winner's Target must
    rebuild against this inventory's first ``n_ranks`` devices with a
    matching stored fingerprint and pass program validation — entries
    that cannot (e.g. a mesh needing more ranks than the new job has)
    are skipped, not errors.
    """
    if devices is None:
        from repro_torch.tune.space import default_devices

        devices = default_devices()
    devices = list(devices)
    local = devices[: int(n_ranks)] or devices
    here = hardware_signature(local)
    d = cache_dir()
    try:
        names = [n for n in os.listdir(d) if n.endswith(".json")]
    except OSError:
        return None
    entries = []
    for name in names:
        try:
            with open(os.path.join(d, name)) as f:
                entry = json.load(f)
        except (OSError, ValueError):
            continue
        if not isinstance(entry, dict) or entry.get("schema") != SCHEMA_VERSION:
            continue
        if entry.get("program") != program.fingerprint:
            continue
        if entry.get("options") != options:
            continue
        if entry.get("hardware") == here:
            # same signature is the primary cache key's territory — a
            # transfer is by definition a signature change (the rank
            # count is part of the signature, so an elastic 2 -> 4 rank
            # move on one machine IS a transfer)
            continue
        entries.append(entry)
    entries.sort(key=lambda e: e.get("created", ""), reverse=True)
    for entry in entries:
        try:
            target = target_from_dict(entry["winner"], devices=local)
        except (TuneCacheError, KeyError, ValueError):
            continue
        if target.fingerprint != entry["winner"].get("fingerprint"):
            continue
        from repro_torch import api

        try:
            api._validate_for_program(program, target)
        except api.TargetError:
            continue
        _STATS.transfer_hits += 1
        return entry, target
    return None


def store(key: str, entry: dict) -> str:
    """Atomically write ``entry`` (tmp file + rename) and return its
    path.  The schema version and key are stamped in."""
    entry = dict(entry)
    entry["schema"] = SCHEMA_VERSION
    entry["key"] = key
    entry.setdefault("created", time.strftime("%Y-%m-%dT%H:%M:%S"))
    d = cache_dir()
    os.makedirs(d, exist_ok=True)
    path = entry_path(key)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(entry, f, indent=1)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):  # pragma: no cover - rename failed
            os.unlink(tmp)
    _STATS.stores += 1
    return path
