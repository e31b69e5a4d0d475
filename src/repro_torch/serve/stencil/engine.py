"""Multi-tenant stencil-simulation serving engine (port of
``repro.serve.stencil.engine``).

The ROADMAP's "millions of users" direction: many tenants submit
``(Program, initial state, n_steps, Target)`` jobs against ONE running
service, and throughput under concurrent mixed traffic — not single-run
latency — is the figure of merit.  The design generalizes the vLLM-style
slot pool of the reference's ``serve/engine.py`` onto the compile surface:

- **fingerprint batching** — live requests are grouped by
  ``(program.fingerprint, target.fingerprint)``; each group's engine step
  is ONE pooled ``CompiledStencil`` call over a fixed slot pool of
  ``[capacity, *shape]`` tensors (K1 and K2 take the slot count as a
  launch argument: one launch per apply or epoch advances every slot), so
  the executable is shape-stable per bucket and built once per pool width
  (the bucket memoizes it; nothing is lowered again); under ``jit`` on
  the card the pool lives in the executable's ring, and a dispatch is one
  CUDA graph replay that advances it in place;
- **continuous admission** — requests finish at different ``n_steps``;
  a finished slot is reclaimed and refilled from the bucket's FIFO queue
  within the same engine step, so short jobs never wait on long ones;
- **epoch-aligned stepping** — a ``Target(exchange_every=k)`` bucket
  advances every live slot by one *epoch* (k time steps) per dispatch;
  ``n_steps`` must be a multiple of k (validated at submit), so deep-halo
  temporal tiling stays bitwise-correct inside the batch;
- **streaming frames** — each request can stream intermediate state back
  at a ``frame_every`` cadence via callback or pull iterator
  (``request.py``), snapshots taken at epoch boundaries;
- **metrics** — per-step utilization (live/pool), batched-vs-solo
  dispatch counts, compile-cache hit deltas, per-fingerprint queue
  depth, and per-fingerprint dispatch latency (p50/p99 wall time per
  epoch dispatch, the card synchronized before the clock stops —
  ``metrics.py``).

Distributed targets (``target.distributed``) batch too: the engine
derives the bucket target's *slot-axis sibling* (``api.pooled_target`` —
a second mesh axis factored out of the device inventory, widest feasible
per ``tune.space.slot_width_candidates`` over every card, or a CPU
mesh's own devices) and dispatches the whole pool as ONE call over
``(slot, *spatial)`` ranks per engine step.  Exchanges bind the spatial
axis names and carry every slot of a rank, so the pooled dispatch stays
bitwise-equal to per-slot solo dispatches.  When the sibling cannot be
built (an inventory that cannot hold it: ``TargetError``) the bucket
falls back to the solo loop, with a single batched row-commit per step.
Nothing else falls back: a K1 or K2 build or launch error of a pooled
dispatch propagates out of ``step()``.

Buckets are *elastic*: an optional ``PoolSizer`` (``config.autoscale``)
resizes capacities between steps from queue-depth/utilization EWMAs —
the resize drains the bucket to epoch-aligned checkpoints and readmits
through ``repro_torch.resilience.migrate``, so it is bitwise-invisible to
tenants — and buckets idle past ``config.bucket_idle_steps`` retire,
freeing their pooled device tensors and their executables' graphs and
rings (``metrics.buckets_retired``).

Every request's final state is **bitwise-equal** to a solo
``compile(program, target).time_loop(state, n_steps)`` run — the pooled
dispatch runs the very same lowered program with a leading slot dim,
and stencil arithmetic is slot-local, so every slot goes through the
per-point operations of a solo run.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional, Sequence

from repro_torch import api
from repro_torch.obs import trace as _obs
from repro_torch.serve.stencil.metrics import EngineMetrics, StepMetrics
from repro_torch.serve.stencil.request import (
    DONE,
    Frame,  # noqa: F401  (re-export for tenants)
    RequestHandle,
    StencilRequest,
    now,
)
from repro_torch.serve.stencil.scheduler import (
    PoolSizer,
    PoolSizerConfig,
    Scheduler,
    SlotPool,
)


@dataclasses.dataclass(frozen=True)
class StencilEngineConfig:
    """Engine knobs.

    ``slots_per_group`` is the *initial* pool size per fingerprint
    bucket — the batch width of the pooled dispatch.  ``history_limit``
    bounds the retained per-step metrics rows.  ``pooled_distributed``
    dispatches distributed buckets as one slot-axis call (the solo
    per-slot loop survives as fallback).  ``autoscale`` turns on the
    queue-depth ``PoolSizer`` with the given policy.
    ``bucket_idle_steps`` retires a bucket after that many consecutive
    workless engine steps, freeing its pooled tensors (0 = never).
    """

    slots_per_group: int = 4
    history_limit: int = 10_000
    pooled_distributed: bool = True
    autoscale: Optional[PoolSizerConfig] = None
    bucket_idle_steps: int = 50

    def __post_init__(self) -> None:
        if self.slots_per_group < 1:
            raise ValueError(
                f"slots_per_group must be >= 1, got {self.slots_per_group}"
            )
        if self.bucket_idle_steps < 0:
            raise ValueError(
                f"bucket_idle_steps must be >= 0, got "
                f"{self.bucket_idle_steps}"
            )


class StencilEngine:
    """Admit stencil jobs from many tenants; advance them in
    fingerprint-batched, epoch-aligned engine steps."""

    def __init__(self, config: Optional[StencilEngineConfig] = None) -> None:
        self.config = config or StencilEngineConfig()
        self.scheduler = Scheduler(self.config.slots_per_group)
        self.metrics = EngineMetrics(self.config.history_limit)
        self.sizer = (
            PoolSizer(self.config.autoscale)
            if self.config.autoscale is not None
            else None
        )
        self.finished: list[StencilRequest] = []
        self.engine_step_count = 0
        self._next_rid = 0

    # -- public API ------------------------------------------------------
    def submit(
        self,
        program,
        state: Sequence[Any],
        n_steps: int,
        target=None,
        *,
        frame_every: int = 0,
        on_frame: Optional[Callable] = None,
        tenant: Optional[str] = None,
        start_step: int = 0,
    ) -> RequestHandle:
        """Enqueue one simulation job; returns a handle immediately.

        ``state`` is the input buffers oldest → newest (exactly what
        ``CompiledStencil.time_loop`` takes).  ``n_steps`` counts single
        time steps and must be a positive multiple of the target's
        ``exchange_every`` (one engine dispatch advances a whole epoch).
        ``frame_every`` > 0 streams a state snapshot at each epoch
        boundary crossing a multiple of that cadence.  ``start_step`` > 0
        admits a *mid-run* request (the migration path: ``state`` is the
        checkpointed state at that epoch-aligned step, and the engine
        advances only the remaining ``n_steps - start_step`` steps).
        """
        target = target if target is not None else api.Target()
        compiled = api.compile(program, target)  # cache-keyed by fingerprints
        k = target.exchange_every
        if n_steps < 1:
            raise ValueError(f"n_steps must be >= 1, got {n_steps}")
        if n_steps % k != 0:
            raise ValueError(
                f"n_steps={n_steps} is not a multiple of the target's "
                f"exchange_every={k}; the engine advances whole epochs, so "
                "round the request up or pick a dividing epoch depth"
            )
        if not 0 <= start_step < n_steps or start_step % k != 0:
            raise ValueError(
                f"start_step={start_step} must be an epoch-aligned step "
                f"(multiple of {k}) strictly below n_steps={n_steps}; a "
                "migrated request resumes at the checkpointed step count"
            )
        if frame_every < 0:
            raise ValueError(f"frame_every must be >= 0, got {frame_every}")
        inputs = compiled.input_indices
        if len(state) != len(inputs):
            raise ValueError(
                f"program {program.name!r} takes {len(inputs)} input "
                f"buffer(s) (oldest → newest), got {len(state)}"
            )
        for arr, idx in zip(state, inputs):
            want = tuple(program.field_args[idx].type.bounds.shape)
            if tuple(arr.shape) != want:
                raise ValueError(
                    f"input buffer for field "
                    f"{program.field_names[idx]!r} has shape "
                    f"{tuple(arr.shape)}, expected {want}"
                )
        req = StencilRequest(
            rid=self._next_rid,
            program=program,
            target=target,
            state=tuple(state),
            n_steps=int(n_steps),
            frame_every=int(frame_every),
            on_frame=on_frame,
            tenant=tenant,
            submitted_at=now(),
            steps_done=int(start_step),
        )
        self._next_rid += 1
        group = self.scheduler.group_for(compiled)
        self.scheduler.enqueue(group, req)
        self.metrics.requests_submitted += 1
        return RequestHandle(req)

    def step(self) -> StepMetrics:
        """One engine step: autoscale, admit, dispatch every non-empty
        bucket once (pooled — over the slot dim, or a slot-axis target's
        ranks — with a solo fallback for a distributed bucket whose
        inventory cannot hold a slot axis), stream frames, reclaim + refill
        finished slots, retire idle buckets."""
        self.engine_step_count += 1
        with _obs.span("engine.step", cat="serve",
                       step=self.engine_step_count):
            return self._step_inner()

    def _step_inner(self) -> StepMetrics:
        if self.sizer is not None:
            self._autoscale()
        batched = solo = steps_advanced = 0
        live_at_dispatch = 0
        busy = set()
        for group in list(self.scheduler.groups.values()):
            self.scheduler.admit(group)
            live = sorted(group.active.items())
            live_at_dispatch += len(live)
            if not live:
                continue
            busy.add(group.key)
            bucket = f"{group.key[0]}/{group.key[1]}"
            pooled_fn = None
            if group.compiled.target.distributed:
                if self.config.pooled_distributed:
                    pooled_fn = self._pooled_fn(group)
            else:
                pooled_fn = self._pool_fn(group)
            if pooled_fn is not None:
                # no fallback here: a K1/K2 build or launch error propagates
                with _obs.span("dispatch:pooled", cat="serve",
                               bucket=bucket, live=len(live)):
                    t0 = time.perf_counter()
                    # one epoch of the whole pool, rotated, in place in the
                    # executable's ring under jit on the card
                    group.state = tuple(pooled_fn.advance(group.state))
                    pooled_fn.sync()  # the clock times the card's work
                self.metrics.record_dispatch(
                    bucket, time.perf_counter() - t0
                )
                if len(live) >= 2:
                    batched += 1
                    self.metrics.record_bucket_dispatch(bucket, True)
                else:
                    solo += 1
                    self.metrics.record_bucket_dispatch(bucket, False)
            else:
                # solo fallback: one call per live slot, rows buffered and
                # committed in ONE batched write per buffer
                rows = {}
                for slot, _ in live:
                    with _obs.span("dispatch:solo", cat="serve",
                                   bucket=bucket, slot=slot):
                        t0 = time.perf_counter()
                        outs = group.compiled.step()(*group.read_slot(slot))
                        outs = outs if isinstance(outs, tuple) else (outs,)
                        group.compiled.sync()
                    self.metrics.record_dispatch(
                        bucket, time.perf_counter() - t0
                    )
                    row = group.read_slot(slot)
                    rows[slot] = tuple(row[len(outs):]) + tuple(outs)
                    solo += 1
                    self.metrics.record_bucket_dispatch(bucket, False)
                group.commit_rows(rows)
            k = group.exchange_every
            for slot, req in live:
                req.steps_done += k
                steps_advanced += k
                self._stream_frames(group, req)
                if req.steps_done >= req.n_steps:
                    self._finish(group, req)
            # continuous admission: refill slots freed this very step so
            # the next dispatch runs at full width
            self.scheduler.admit(group)
        if self.config.bucket_idle_steps:
            retired = self.scheduler.retire_idle(
                self.config.bucket_idle_steps, busy
            )
            self.metrics.buckets_retired += len(retired)
        metrics = StepMetrics(
            engine_step=self.engine_step_count,
            live_slots=live_at_dispatch,
            pool_slots=self.scheduler.total_slots,
            queued=self.scheduler.total_queued,
            batched_dispatches=batched,
            solo_dispatches=solo,
            steps_advanced=steps_advanced,
            queue_depth=self.scheduler.queue_depths(),
        )
        self.metrics.record_step(metrics)
        return metrics

    def run(self, max_engine_steps: int = 100_000) -> list:
        """Drive the engine until every submitted request finished (or the
        step budget runs out); returns the requests that finished during
        THIS call — ``self.finished`` keeps the engine-lifetime history,
        but a second ``run()`` must not re-report the first one's work."""
        first = len(self.finished)
        for _ in range(max_engine_steps):
            if not self.pending:
                break
            self.step()
        return self.finished[first:]

    @property
    def pending(self) -> int:
        """Requests admitted or queued but not yet finished."""
        return self.scheduler.total_live + self.scheduler.total_queued

    # -- migration (repro_torch.resilience.migrate) ----------------------
    def evacuate(self, program_fingerprint: str, directory: str) -> list:
        """Drain every request of ``program_fingerprint`` to epoch-aligned
        checkpoints under ``directory`` and release their slots — the
        serve layer's request-migration primitive: a second engine picks
        them up mid-run with ``admit_evacuated``, and each request's
        final state stays bitwise-equal to an unmigrated run."""
        from repro_torch.resilience.migrate import evacuate as _evacuate

        with _obs.span("engine.evacuate", cat="serve",
                       program=program_fingerprint):
            evacuated = _evacuate(self, program_fingerprint, directory)
        if evacuated:
            _obs.instant("evacuated", cat="serve", count=len(evacuated))
        return evacuated

    def admit_evacuated(self, directory: str, programs, target=None) -> list:
        """Admit the requests another engine evacuated into ``directory``;
        ``programs`` maps checkpoint fingerprints back to live ``Program``
        objects, and ``target`` optionally re-targets every admitted
        request (e.g. onto this engine's mesh).  Returns new handles."""
        from repro_torch.resilience.migrate import admit as _admit

        with _obs.span("engine.admit_evacuated", cat="serve"):
            admitted = _admit(self, directory, programs, target=target)
        if admitted:
            _obs.instant("admitted", cat="serve", count=len(admitted))
        return admitted

    @property
    def utilization(self) -> float:
        return self.scheduler.total_live / max(1, self.scheduler.total_slots)

    # -- elasticity ------------------------------------------------------
    def resize_bucket(
        self, group: SlotPool, new_capacity: int,
        directory: Optional[str] = None,
    ) -> None:
        """Rebuild ``group``'s pool at ``new_capacity`` through the
        migration path: drain every active request to an epoch-aligned
        checkpoint, release the old width's executable (graphs, ring),
        reallocate the pool tensors at the new width, readmit the same
        request objects at the queue front.  Bitwise-invisible to tenants
        by the migration contract — the checkpointed state is exact,
        admission rewrites it into a (new) slot, and frame cadence
        continues from the preserved ``steps_done``."""
        import shutil
        import tempfile

        from repro_torch.resilience.migrate import drain_group, readmit_group

        tmp = directory or tempfile.mkdtemp(prefix="repro-pool-resize-")
        try:
            drained = drain_group(self, group, tmp)
            group.rebuild(int(new_capacity))
            readmit_group(self, group, tmp, drained)
        finally:
            if directory is None:
                shutil.rmtree(tmp, ignore_errors=True)

    def _autoscale(self) -> None:
        for group in list(self.scheduler.groups.values()):
            decision = self.sizer.observe(group)
            if decision is None:
                continue
            new_capacity, provenance = decision
            bucket = f"{group.key[0]}/{group.key[1]}"
            with _obs.span("pool.resize", cat="serve", bucket=bucket,
                           action=provenance.get("action"),
                           to_capacity=int(new_capacity)):
                self.resize_bucket(group, new_capacity)
            provenance["engine_step"] = self.engine_step_count
            self.metrics.record_autoscale(provenance)

    # -- internals -------------------------------------------------------
    def _pool_fn(self, group: SlotPool) -> api.CompiledStencil:
        """The bucket's shape-stable pool executable: the compiled step
        over ``[capacity, *shape]`` tensors (``CompiledStencil.for_pool``
        of the bucket's artifact, so nothing is lowered again; under
        ``jit`` the pool lives in its ring and a dispatch advances it in
        place).  Memoized on the group per pool width and never shared:
        its ring is the pool's state.  Retiring or resizing the bucket
        releases it (``SlotPool.release_executables``)."""
        if group.executable is None:
            group.pooled = (group.capacity, group.compiled.for_pool())
        return group.executable

    def _pooled_fn(self, group: SlotPool) -> Optional[api.CompiledStencil]:
        """The distributed bucket's ONE-dispatch executable: the compiled
        step of the target's slot-axis sibling (``api.pooled_target``),
        taking the whole ``[capacity, *shape]`` pool per buffer.  The
        slot width is the widest feasible for the inventory
        (``tune.space.slot_width_candidates``; width 1 still pools — each
        spatial rank carries every slot in its leading dim).  Memoized on
        the group per pool width; ``None`` when the inventory cannot hold
        the slot axis (``TargetError``), which routes the bucket to the
        solo fallback loop."""
        if group.pooled is not None and group.pooled[0] == group.capacity:
            return group.executable
        from repro_torch.tune.space import slot_width_candidates

        target = group.compiled.target
        compiled = None
        try:
            devices = self._inventory(target)
            width = slot_width_candidates(
                len(devices), target.spatial_ranks, group.capacity
            )[0]
            pooled = api.pooled_target(target, slots=width, devices=devices)
            compiled = api.compile(group.compiled.program, pooled).for_pool()
        except api.TargetError:
            compiled = None
        group.pooled = (group.capacity, compiled)
        return compiled

    def _inventory(self, target) -> list:
        """The devices a slot axis is factored out of: every card
        (``tune.space.default_devices``) for a target on the card, else the
        CPU target mesh's own devices."""
        if target.mesh.device_type == "cuda":
            from repro_torch.tune.space import default_devices

            return default_devices()
        return list(target.mesh.devices.flat)

    def _stream_frames(self, group: SlotPool, req: StencilRequest) -> None:
        if req.frame_every <= 0:
            return
        emitted = False
        while req.next_frame_at and req.steps_done >= req.next_frame_at:
            req.next_frame_at += req.frame_every
            emitted = True
        if emitted and req.steps_done < req.n_steps:
            # one snapshot per engine step at most — the state only
            # changes at epoch boundaries, so coalescing crossed marks
            # into the boundary snapshot is the honest cadence
            req.emit_frame(group.read_slot(req.slot))
            self.metrics.frames_emitted += 1

    def _finish(self, group: SlotPool, req: StencilRequest) -> None:
        req.result = group.read_slot(req.slot)
        req.status = DONE
        req.finished_at = now()
        if req.frame_every and req.n_steps % req.frame_every == 0:
            # final-state frame when the cadence lands exactly on n_steps
            req.emit_frame(req.result)
            self.metrics.frames_emitted += 1
        self.finished.append(req)
        self.metrics.requests_completed += 1
        self.scheduler.reclaim(group, req.slot)
