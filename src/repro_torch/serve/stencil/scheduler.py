"""Fingerprint-bucketed slot pools and admission for the stencil engine
(port of ``repro.serve.stencil.scheduler``).

The vLLM-style slot-pool ideas (fixed pool, shape-stable executables,
continuous admission) applied to stencil jobs:

- live requests are grouped by **compile fingerprint**
  ``(program.fingerprint, target.fingerprint)`` — the same key the
  process-wide ``repro_torch.api`` compile cache uses, so every member of
  a group shares one ``CompiledStencil`` and its pool's executable (one
  per bucket and pool width: under ``jit`` on the card it holds the
  pool's ring, so no two buckets share one);
- each group owns a fixed pool of ``capacity`` slots; the pooled state is
  one tensor of shape ``[capacity, *field_shape]`` per input buffer, so
  the batched dispatch is shape-stable regardless of how many slots are
  live (dead slots compute garbage that is never read);
- admission writes a request's initial state into its slot's rows;
  reclaim frees the slot the moment the request's ``n_steps`` are done,
  so a long request never stalls the short ones behind it;
- buckets are *elastic*: a ``PoolSizer`` policy resizes ``capacity``
  between engine steps from queue-depth / utilization EWMAs (the engine
  drains + readmits through the migration checkpointing path, so resizes
  stay bitwise-invisible), and a bucket that stays idle past a threshold
  is retired — its pooled ``[capacity, *shape]`` tensors freed, and its
  pool executable's CUDA graphs and ring released — so a serving
  process's memory tracks its *live* traffic, not every fingerprint it
  has ever seen.

Pool state on the card.  A pool tensor is not a value, as a JAX array
is: after the first dispatch it is the pool executable's own ring buffer
(``Target(jit=True)`` on the card), which the next dispatch advances in
place.  So ``read_slot`` returns copies that share nothing with the pool
(a view would change under the tenant's feet, and would keep the ring
looking held, so the next dispatch would build a new ring and capture
every graph anew), and ``write_slot``/``commit_rows`` write rows in place,
so the pool keeps its ring phase.  Over a mesh the pool may be sharded
(:class:`~repro_torch.dist.ShardedTensor`); the row helpers of
``dist.sharding`` read and write one slot's row across its ranks.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Optional

import torch

from repro_torch import api
from repro_torch.dist.sharding import read_row, write_row
from repro_torch.serve.stencil.request import QUEUED, RUNNING, StencilRequest, now


@dataclasses.dataclass
class SlotPool:
    """One fingerprint bucket: compiled artifact + fixed slot pool."""

    key: tuple                  # (program fp, target fp)
    compiled: Any               # repro_torch.api.CompiledStencil
    capacity: int
    state: tuple = ()           # per input buffer: [capacity, *shape]
    free: list = dataclasses.field(default_factory=list)
    active: dict = dataclasses.field(default_factory=dict)  # slot -> request
    queue: deque = dataclasses.field(default_factory=deque)
    idle_steps: int = 0         # consecutive engine steps with no work
    # (capacity, CompiledStencil|None): the pool's executable, memoized per
    # pool width — the compiled step over [capacity, *shape] tensors, or a
    # distributed target's slot-axis sibling (None = not factorable)
    pooled: Optional[tuple] = None

    def __post_init__(self) -> None:
        self.free = list(range(self.capacity))
        if not self.state:
            prog = self.compiled.program
            target = self.compiled.target
            device = target.mesh.device(0) if target.mesh is not None else target.device
            self.state = tuple(
                torch.zeros(
                    (self.capacity,) + tuple(prog.field_args[i].type.bounds.shape),
                    dtype=torch.float32,
                    device=device,
                )
                for i in self.compiled.input_indices
            )

    @property
    def live(self) -> int:
        return len(self.active)

    @property
    def exchange_every(self) -> int:
        return self.compiled.target.exchange_every

    @property
    def executable(self) -> Optional[Any]:
        """This pool width's executable once the engine has built it (see
        ``pooled``), else ``None``."""
        if self.pooled is None or self.pooled[0] != self.capacity:
            return None
        return self.pooled[1]

    # -- slot state ------------------------------------------------------
    def write_slot(self, slot: int, arrays) -> None:
        """Write one slot's rows in place (tensors on any device, or
        float32 numpy arrays)."""
        for ps, a in zip(self.state, arrays):
            write_row(ps, slot, a)

    def read_slot(self, slot: int) -> tuple:
        """One slot's rows as new tensors that share nothing with the pool."""
        return tuple(read_row(ps, slot) for ps in self.state)

    def commit_rows(self, rows: dict) -> None:
        """Batched commit of per-slot rows: one ``index_copy_`` per input
        buffer instead of a write per slot — the solo dispatch loop
        buffers each slot's rotated row here and commits once."""
        if not rows:
            return
        slots = sorted(rows)
        for b, ps in enumerate(self.state):
            if isinstance(ps, torch.Tensor):
                idx = torch.tensor(slots, device=ps.device)
                ps.index_copy_(0, idx, torch.stack([rows[s][b].to(ps.device) for s in slots]))
            else:
                for s in slots:
                    write_row(ps, s, rows[s][b])

    # -- elasticity ------------------------------------------------------
    def rebuild(self, new_capacity: int) -> None:
        """Reallocate the pool at ``new_capacity`` (resize path).  Only
        legal on a drained pool — the engine checkpoints every active
        request out first, rebuilds, then readmits through the queue.  The
        old width's executable (graphs, ring) is released."""
        if self.active:
            raise RuntimeError(
                f"rebuild of bucket {self.key[0][:12]}… with "
                f"{len(self.active)} active slots; drain it first"
            )
        self.release_executables()
        self.capacity = int(new_capacity)
        self.state = ()
        self.__post_init__()

    def release_executables(self) -> None:
        """Drop this pool width's executable with its graphs and ring; a
        distributed bucket's slot-axis sibling also leaves the compile
        cache."""
        exe = None if self.pooled is None else self.pooled[1]
        if exe is not None:
            exe.release_graphs()
            if exe.target.slot_axis is not None:
                # the cached sibling is the one without the pool's donation
                api.forget(exe.program, dataclasses.replace(
                    exe.target, donate=self.compiled.target.donate))
        self.pooled = None  # pool width changed or gone; re-factor the slot axis

    def release(self) -> None:
        """Drop the pooled device tensors and executables (retirement)."""
        self.release_executables()
        self.state = ()
        self.free = []


class Scheduler:
    """Admission + reclaim over all fingerprint buckets (FIFO per bucket)."""

    def __init__(self, slots_per_group: int) -> None:
        self.slots_per_group = int(slots_per_group)
        self.groups: dict[tuple, SlotPool] = {}

    def group_for(self, compiled, capacity: Optional[int] = None) -> SlotPool:
        key = (compiled.program.fingerprint, compiled.target.fingerprint)
        group = self.groups.get(key)
        if group is None:
            group = SlotPool(
                key=key,
                compiled=compiled,
                capacity=int(capacity or self.slots_per_group),
            )
            self.groups[key] = group
        return group

    def enqueue(self, group: SlotPool, request: StencilRequest) -> None:
        request.status = QUEUED
        group.queue.append(request)

    def admit(self, group: SlotPool) -> list:
        """Move queued requests into free slots (FIFO); returns the newly
        admitted requests.  Called at the top of every engine step and
        again right after reclaim, so a freed slot is refilled within the
        same engine step — continuous admission."""
        admitted = []
        while group.queue and group.free:
            req = group.queue.popleft()
            slot = group.free.pop(0)
            req.slot = slot
            req.status = RUNNING
            req.started_at = now()
            # next cadence mark strictly after the steps already done —
            # a migrated request (steps_done > 0 at admission) continues
            # its frame schedule instead of restarting it
            req.next_frame_at = (
                req.frame_every * (req.steps_done // req.frame_every + 1)
                if req.frame_every
                else 0
            )
            group.write_slot(slot, req.state)
            # the pool holds the state now: the submitted tensors would be
            # a second copy of every running request on the card
            req.state = ()
            group.active[slot] = req
            admitted.append(req)
        return admitted

    def reclaim(self, group: SlotPool, slot: int) -> None:
        """Free a finished request's slot for immediate reuse."""
        del group.active[slot]
        group.free.append(slot)

    def retire_idle(self, idle_limit: int, busy=()) -> list:
        """Retire buckets idle (no active slots, empty queue, and not in
        ``busy`` — keys that dispatched this very step) for
        ``idle_limit`` consecutive engine steps: release their pooled
        device tensors and executables and drop them from ``groups``, so
        ``total_slots`` and ``utilization`` reflect only live traffic.
        Returns the retired bucket keys.  A retired fingerprint that
        returns later simply gets a fresh bucket from ``group_for``."""
        retired = []
        for key, group in list(self.groups.items()):
            if group.active or group.queue or key in busy:
                group.idle_steps = 0
                continue
            group.idle_steps += 1
            if group.idle_steps >= idle_limit:
                group.release()
                del self.groups[key]
                retired.append(key)
        return retired

    # -- introspection ---------------------------------------------------
    def queue_depths(self) -> dict:
        return {
            f"{k[0]}/{k[1]}": len(g.queue) for k, g in self.groups.items()
        }

    @property
    def total_live(self) -> int:
        return sum(g.live for g in self.groups.values())

    @property
    def total_slots(self) -> int:
        return sum(g.capacity for g in self.groups.values())

    @property
    def total_queued(self) -> int:
        return sum(len(g.queue) for g in self.groups.values())


# --------------------------------------------------------------------------
# queue-depth autoscaling policy
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PoolSizerConfig:
    """Knobs for the queue-depth autoscaler.

    Grow when the *queued-per-slot* EWMA exceeds ``grow_queue_per_slot``
    (demand outruns the pool); shrink when the utilization EWMA falls
    below ``shrink_utilization`` with an empty queue (pool outruns
    demand).  ``cooldown_steps`` of hysteresis follow every resize —
    each resize re-specializes the bucket's pooled executable (the
    compile cache keys on pool width), so back-to-back flapping would
    thrash the cache for no throughput win.
    """

    min_capacity: int = 1
    max_capacity: int = 64
    grow_queue_per_slot: float = 0.5
    shrink_utilization: float = 0.25
    grow_factor: float = 2.0
    shrink_factor: float = 0.5
    ewma_alpha: float = 0.5
    cooldown_steps: int = 3

    def __post_init__(self) -> None:
        if not 1 <= self.min_capacity <= self.max_capacity:
            raise ValueError(
                f"need 1 <= min_capacity <= max_capacity, got "
                f"[{self.min_capacity}, {self.max_capacity}]"
            )
        if not 0.0 < self.ewma_alpha <= 1.0:
            raise ValueError(f"ewma_alpha in (0, 1], got {self.ewma_alpha}")
        if self.grow_factor <= 1.0 or not 0.0 < self.shrink_factor < 1.0:
            raise ValueError(
                f"need grow_factor > 1 and 0 < shrink_factor < 1, got "
                f"{self.grow_factor}/{self.shrink_factor}"
            )


class PoolSizer:
    """Per-bucket capacity policy driven by queue-depth and utilization
    EWMAs.  ``observe(group)`` is called once per engine step per bucket;
    it returns ``(new_capacity, provenance)`` when the bucket should
    resize (the engine then drains → rebuilds → readmits) or ``None`` to
    hold.  Provenance carries the EWMAs and raw signals that justified
    the decision — the serve_load benchmark records it verbatim."""

    def __init__(self, config: Optional[PoolSizerConfig] = None) -> None:
        self.config = config or PoolSizerConfig()
        self._queue_ewma: dict = {}
        self._util_ewma: dict = {}
        self._cooldown: dict = {}

    def observe(self, group: SlotPool) -> Optional[tuple]:
        cfg = self.config
        key = group.key
        a = cfg.ewma_alpha
        queued_per_slot = len(group.queue) / max(1, group.capacity)
        util = group.live / max(1, group.capacity)
        qe = self._queue_ewma[key] = a * queued_per_slot + (1.0 - a) * (
            self._queue_ewma.get(key, queued_per_slot)
        )
        ue = self._util_ewma[key] = a * util + (1.0 - a) * (
            self._util_ewma.get(key, util)
        )
        cooling = self._cooldown.get(key, 0)
        if cooling > 0:
            self._cooldown[key] = cooling - 1
            return None
        cap = group.capacity
        new = action = None
        if qe > cfg.grow_queue_per_slot and cap < cfg.max_capacity:
            new = min(
                cfg.max_capacity,
                max(cap + 1, int(round(cap * cfg.grow_factor))),
            )
            action = "grow"
        elif (
            ue < cfg.shrink_utilization
            and not group.queue
            and (group.live or group.active)  # idle buckets retire instead
            and cap > max(cfg.min_capacity, group.live)
        ):
            new = max(
                cfg.min_capacity,
                group.live,
                int(round(cap * cfg.shrink_factor)),
            )
            action = "shrink"
        if new is None or new == cap:
            return None
        self._cooldown[key] = cfg.cooldown_steps
        return new, {
            "action": action,
            "bucket": f"{key[0]}/{key[1]}",
            "from_capacity": cap,
            "to_capacity": new,
            "queue_depth": len(group.queue),
            "live": group.live,
            "queue_ewma": qe,
            "utilization_ewma": ue,
        }
