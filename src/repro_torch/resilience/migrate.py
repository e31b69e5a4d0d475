# Copied from src/repro/resilience/migrate.py with repro. renamed to repro_torch. (one comment reworded); keep its logic in step with that file.
"""Request migration for the stencil-serving engine.

The serve layer's first evacuation primitive: a ``StencilEngine`` under
drain (autoscaling down, host preemption notice, rebalancing) writes
every live request of a fingerprint bucket to epoch-aligned checkpoints
(``evacuate``), and a *second* engine — possibly in another process, on
different hardware — admits them mid-run (``admit``): the restored state
is resubmitted with ``start_step`` at the evacuated step count, so each
request finishes with a final state bitwise-equal to an unmigrated run.

Layout: one checkpoint directory per request under the evacuation root,

    <root>/req_<rid>/step_<steps_done>/...

with the manifest's ``extra`` carrying the request's identity (program
fingerprint, serialized Target via ``tune.cache.target_to_dict``,
n_steps, steps_done, frame cadence, tenant).  ``admit`` rebuilds the
Target against the *receiving* engine's device inventory
(``target_from_dict``) unless the caller overrides it — migration across
a mesh change composes with the resilience driver's resharding story.

Frame callbacks (``on_frame``) are process-local closures and do not
migrate; an evacuated request resumes with buffered (pull-iterator)
frames only.
"""
from __future__ import annotations

import os
import re
from typing import Optional

import numpy as np

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.resilience.driver import ResumeError


def evacuate(engine, program_fingerprint: str, directory: str) -> list:
    """Drain every bucket of ``program_fingerprint`` in ``engine`` to
    checkpoints under ``directory``; returns the evacuated requests.

    Running requests are snapshotted at their current (epoch-aligned)
    ``steps_done`` and their slots reclaimed; queued requests are
    evacuated at step 0.  Each request's status becomes ``"evacuated"``
    and it no longer occupies the engine.
    """
    from repro_torch.serve.stencil.request import EVACUATED
    from repro_torch.tune.cache import target_to_dict

    evacuated = []
    for key, group in list(engine.scheduler.groups.items()):
        if key[0] != program_fingerprint:
            continue
        # running slots first (epoch-aligned state lives in the pool)
        for slot, req in sorted(group.active.items()):
            _save_request(
                directory, req, group.read_slot(slot), target_to_dict
            )
            engine.scheduler.reclaim(group, slot)
            req.status = EVACUATED
            req.slot = -1
            evacuated.append(req)
        # queued requests still hold their submitted state
        while group.queue:
            req = group.queue.popleft()
            _save_request(directory, req, req.state, target_to_dict)
            req.status = EVACUATED
            evacuated.append(req)
    engine.metrics.requests_evacuated += len(evacuated)
    return evacuated


def _save_request(directory: str, req, state, target_to_dict) -> None:
    ckpt = Checkpointer(
        os.path.join(directory, f"req_{req.rid}"), keep_last=1
    )
    tree = {"state": {f"b{i}": a for i, a in enumerate(state)}}
    ckpt.save(
        req.steps_done,
        tree,
        blocking=True,
        extra={
            "program_fingerprint": req.program.fingerprint,
            "program_name": req.program.name,
            "target": target_to_dict(req.target),
            "n_steps": req.n_steps,
            "steps_done": req.steps_done,
            "frame_every": req.frame_every,
            "tenant": req.tenant,
            "rid": req.rid,
        },
    )


def admit(engine, directory: str, programs, target=None) -> list:
    """Admit every evacuated request under ``directory`` into ``engine``.

    ``programs`` resolves checkpoint fingerprints back to ``Program``
    objects (a single Program, an iterable, or a {fingerprint: Program}
    dict — IR is code, not data, so the admitting process must hold it).
    ``target`` overrides the serialized Target for every admitted
    request (e.g. migrating onto a different mesh); by default the saved
    Target is rebuilt against this process's device inventory.  Returns
    the new ``RequestHandle``s, in rid order of the evacuated originals.
    """
    from repro_torch.tune.cache import target_from_dict

    by_fp = _program_index(programs)
    handles = []
    try:
        listing = os.listdir(directory)
    except OSError:
        listing = []
    names = sorted(
        (n for n in listing if re.fullmatch(r"req_\d+", n)),
        key=lambda n: int(n.split("_")[1]),
    )
    if not names:
        raise ResumeError(f"no evacuated requests under {directory}")
    for name in names:
        ckpt = Checkpointer(os.path.join(directory, name))
        manifest = ckpt.manifest()
        meta = manifest.get("extra") or {}
        fp = meta.get("program_fingerprint")
        program = by_fp.get(fp)
        if program is None:
            raise ResumeError(
                f"evacuated request {name} is program "
                f"{meta.get('program_name')!r} ({fp}); no matching Program "
                f"was provided (have {sorted(by_fp)})"
            )
        req_target = (
            target if target is not None else target_from_dict(meta["target"])
        )
        n_bufs = len(manifest["leaves"])
        tree_like = {"state": {f"b{i}": np.zeros(()) for i in range(n_bufs)}}
        restored = ckpt.restore(tree_like)
        state = tuple(restored["state"][f"b{i}"] for i in range(n_bufs))
        handles.append(
            engine.submit(
                program,
                state,
                int(meta["n_steps"]),
                target=req_target,
                frame_every=int(meta.get("frame_every", 0)),
                tenant=meta.get("tenant"),
                start_step=int(meta["steps_done"]),
            )
        )
        engine.metrics.requests_resumed += 1
    return handles


# --------------------------------------------------------------------------
# in-process drain/readmit — the slot-pool *resize* path
# --------------------------------------------------------------------------


def drain_group(engine, group, directory: str) -> list:
    """Checkpoint every active request of ``group`` at its epoch-aligned
    ``steps_done`` and release its slot, keeping the request objects —
    unlike ``evacuate``, handles, ``on_frame`` callbacks and buffered
    frames all stay valid, because the same objects readmit into the
    rebuilt pool (``readmit_group``).  This is the engine's pool-resize
    primitive: the checkpoint roundtrip is exactly the migration
    contract, so results after a resize stay bitwise-equal."""
    from repro_torch.tune.cache import target_to_dict

    drained = []
    for slot, req in sorted(group.active.items()):
        _save_request(directory, req, group.read_slot(slot), target_to_dict)
        engine.scheduler.reclaim(group, slot)
        req.slot = -1
        drained.append(req)
    engine.metrics.requests_evacuated += len(drained)
    return drained


def readmit_group(engine, group, directory: str, requests) -> list:
    """Restore each drained request's checkpointed state and requeue the
    SAME object at the front of ``group``'s queue (rid order), ahead of
    requests that arrived during the resize — a resize must never reorder
    a running request behind the backlog that triggered it.  Admission
    recomputes the frame cadence from the preserved ``steps_done``, so
    streamed frame ``step`` values stay strictly increasing across the
    hop.  Returns the readmitted requests."""
    from repro_torch.serve.stencil.request import QUEUED

    restored = []
    for req in sorted(requests, key=lambda r: r.rid):
        ckpt = Checkpointer(os.path.join(directory, f"req_{req.rid}"))
        manifest = ckpt.manifest()
        n_bufs = len(manifest["leaves"])
        tree_like = {"state": {f"b{i}": np.zeros(()) for i in range(n_bufs)}}
        tree = ckpt.restore(tree_like)
        req.state = tuple(tree["state"][f"b{i}"] for i in range(n_bufs))
        req.status = QUEUED
        restored.append(req)
    group.queue.extendleft(reversed(restored))
    engine.metrics.requests_resumed += len(restored)
    return restored


def _program_index(programs) -> dict:
    if hasattr(programs, "fingerprint"):  # a single Program
        return {programs.fingerprint: programs}
    if isinstance(programs, dict):
        return dict(programs)
    return {p.fingerprint: p for p in programs}
