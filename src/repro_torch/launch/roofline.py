"""Three-term roofline analysis with an H100's terms (port of
``repro.launch.roofline``): the stencil half (one compiled stencil step)
and the language-model half (the dry run's cells).

    PYTHONPATH=src python -m repro_torch.launch.roofline [--outdir build/dryrun] [--markdown]

    compute    = flops per rank            / PEAK_FLOPS
    memory     = bytes per rank            / HBM_BW
    collective = collective bytes per rank / LINK_BW

The modeled time is ``max(terms)`` with perfect overlap and ``sum(terms)``
without; the dominant term is the bottleneck.  :class:`RooflineTerms` is
the reference's, logic unchanged (``CompiledStencil.cost()`` returns one).

The port has no XLA ``cost_analysis`` and no HLO, so the counts come from
the IR itself (:func:`count_ir`): each term is the *least* that the ops
of one call must do on one rank (each operand window read once, each
result written once, each send rectangle that reaches another rank sent
once), so the modeled time is a bound the card cannot beat.

The language-model half reads the dry run's records
(``repro_torch.launch.dryrun``): :class:`Cell`, :func:`load_cells`,
:func:`report`.  Its terms are per rank of the reference's production
mesh, with the H100's data-sheet bf16 dense tensor-core peak and NVLink
bandwidth (``LM_PEAK_FLOPS``, ``NVLINK_BW``): what the cell would take
per rank on H100s, not a measurement.

The constants are an NVIDIA H100 80GB HBM3 (SXM) at its 700 W power
limit, as ``nvidia-smi --query-gpu=name,power.limit`` names it.
"""
from __future__ import annotations

import argparse
import glob
import itertools
import json
import math
import os
from dataclasses import dataclass, field
from typing import Mapping, Optional

from repro_torch.core import ir
from repro_torch.core.dialects import comm, stencil

# NVIDIA H100 80GB HBM3 (SXM), 700.00 W power limit.
PEAK_FLOPS = 67e12   # float32 outside the tensor cores (data sheet): the stencils are float32
HBM_BW = 3.35e12     # bytes/s of HBM (data sheet)
# The compiled step (Target(jit=True)) runs every rank of a mesh on one card
# (jit over several CUDA devices raises), so an exchange is a copy within
# HBM: each byte read once and written once.  The NVLink term comes with
# more than one card (ROADMAP Queue 1 item 2, the multi-process transport).
LINK_BW = HBM_BW / 2
# Per message: one exchange patch copy (a 2-row strip of 8192 float32
# columns) as a node of a captured CUDA graph, the time per node over 256
# nodes, as chip_smoke.py phase 11 measures and logs it on that card.
LINK_LATENCY = 1.6462e-6

# The language-model half (dry-run cells), data-sheet constants of the same card:
LM_PEAK_FLOPS = 989e12  # bf16 dense on the tensor cores (data sheet)
NVLINK_BW = 450e9       # bytes/s per direction of NVLink 4 (data sheet: 900 GB/s both ways)

# point-function ops that count as one float32 operation each
ARITH_OPS = (
    ir.AddOp, ir.SubOp, ir.MulOp, ir.DivOp, ir.NegOp, ir.AbsOp, ir.SqrtOp,
    ir.ExpOp, ir.SelectGeZeroOp, stencil.IndexOp,
)


@dataclass
class RooflineTerms:
    """Generic three-term roofline of one compiled executable — the
    ``CompiledStencil.cost()`` payload (per-device quantities in, per-chip
    seconds out).

    The optional temporal-tiling terms describe the message-count vs
    redundant-compute tradeoff of deep-halo epochs
    (``Target(exchange_every=k)``): ``messages_per_epoch`` exchanges fire
    *once* per epoch regardless of depth (their per-message launch latency
    amortizes as 1/k), while every non-final step of the epoch computes a
    shrinking frame of redundant boundary points
    (``redundant_compute_factor``).  ``recommend_exchange_every`` picks
    the k that minimizes the modeled per-step time, subject to the deep
    halo fitting the shard."""

    flops: float
    bytes_accessed: float
    collectives: dict = field(default_factory=dict)
    exchange_every: int = 1
    messages_per_epoch: int = 0
    step_halo: tuple = ()     # per-dim per-step halo width (max of lo/hi)
    local_shape: tuple = ()   # local shard core extents

    def __post_init__(self) -> None:
        self.flops = float(self.flops)
        self.bytes_accessed = float(self.bytes_accessed)
        self.collectives = dict(self.collectives)
        self.exchange_every = int(self.exchange_every)
        self.messages_per_epoch = int(self.messages_per_epoch)
        self.step_halo = tuple(self.step_halo)
        self.local_shape = tuple(self.local_shape)

    @property
    def collective_bytes(self) -> float:
        return float(sum(self.collectives.values()))

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes_accessed / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.collective_bytes / LINK_BW

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def t_overlapped(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def t_serial(self) -> float:
        return self.t_compute + self.t_memory + self.t_collective

    # -- temporal-tiling tradeoff (message latency vs redundant compute) --
    @property
    def t_latency(self) -> float:
        """Per-step exchange launch latency: one message volley per epoch,
        amortized over the epoch's steps."""
        return (
            self.messages_per_epoch * LINK_LATENCY
            / max(self.exchange_every, 1)
        )

    def redundant_compute_factor(self, k: Optional[int] = None) -> float:
        """Mean compute volume of an epoch's steps relative to the core:
        step j of k computes ``prod(n_d + 2·(k-j)·w_d)`` points, so the
        factor is 1.0 at k=1 and grows with depth (surface/volume)."""
        k = self.exchange_every if k is None else int(k)
        if k <= 1 or not self.step_halo or not self.local_shape:
            return 1.0
        core = 1.0
        for n in self.local_shape:
            core *= n
        if core == 0:
            return 1.0
        total = 0.0
        for j in range(k):  # j = remaining growth steps (k-1 … 0)
            vol = 1.0
            for n, w in zip(self.local_shape, self.step_halo):
                vol *= n + 2.0 * j * w
            total += vol
        return total / (k * core)

    def feasible_exchange_every(self, k: int) -> bool:
        """Deep halo of depth k must come out of the neighbour's core."""
        if not self.step_halo or not self.local_shape:
            return k == 1
        return all(
            w * k <= n for w, n in zip(self.step_halo, self.local_shape) if w
        )

    def step_time(self, k: int) -> float:
        """Modeled per-step seconds at epoch depth ``k``, extrapolated from
        this artifact's terms: work scales by the redundant-compute factor,
        exchange *bytes* per step stay ~constant (k× deeper, 1/k as often),
        exchange *latency* amortizes as 1/k.

        The measured terms describe one *call* — a whole epoch of
        ``self.exchange_every`` steps (its flops carry that depth's
        redundancy, its collective bytes the depth-K halo) — so they are
        normalized back to one clean step before extrapolating to k."""
        depth = max(self.exchange_every, 1)
        per_step_work = max(self.t_compute, self.t_memory) / (
            depth * max(self.redundant_compute_factor(depth), 1.0)
        )
        t_lat = self.messages_per_epoch * LINK_LATENCY / max(k, 1)
        return (
            per_step_work * self.redundant_compute_factor(k)
            + t_lat
            + self.t_collective / depth
        )

    def ranked_exchange_every(self, max_k: int = 8) -> list:
        """Every feasible epoch depth with its modeled per-step seconds,
        best first (ties resolve to the shallower epoch).  ``[(1,
        step_time(1))]`` when the tiling terms are unavailable — the
        ranking the autotuner (``repro_torch.tune``) prints."""
        if not self.step_halo or not self.local_shape or not any(self.step_halo):
            return [(1, self.step_time(1))]
        pairs = [(1, self.step_time(1))] + [
            (k, self.step_time(k))
            for k in range(2, max(int(max_k), 1) + 1)
            if self.feasible_exchange_every(k)
        ]
        return sorted(pairs, key=lambda kt: (kt[1], kt[0]))

    def recommend_exchange_every(self, max_k: int = 8) -> int:
        """The epoch depth minimizing the modeled per-step time; 1 when
        tiling cannot win (or the terms are not available)."""
        return self.ranked_exchange_every(max_k)[0][0]

    def as_dict(self) -> dict:
        return {
            "flops": self.flops,
            "bytes_accessed": self.bytes_accessed,
            "collective_bytes": self.collective_bytes,
            "t_compute": self.t_compute,
            "t_memory": self.t_memory,
            "t_collective": self.t_collective,
            "t_latency": self.t_latency,
            "t_overlapped": self.t_overlapped,
            "t_serial": self.t_serial,
            "dominant": self.dominant,
            "exchange_every": self.exchange_every,
            "messages_per_epoch": self.messages_per_epoch,
            "redundant_compute_factor": self.redundant_compute_factor(),
            "recommended_exchange_every": self.recommend_exchange_every(),
        }


# --------------------------------------------------------------------------
# Counts from the IR (the port's counterpart of XLA's cost analysis)
# --------------------------------------------------------------------------


@dataclass
class IRCounts:
    """The least work of one call on one rank: float32 operations, bytes
    of device memory moved, and bytes sent to other ranks by collective
    kind (``"collective-permute"`` for exchanges, ``"all-reduce"``), as
    the reference's ``collective_bytes_from_hlo`` names them."""

    flops: float = 0.0
    bytes_accessed: float = 0.0
    collectives: dict = field(default_factory=dict)


def _numel(shape) -> int:
    return math.prod(shape)


def apply_counts(apply_op: stencil.ApplyOp, itemsize: int = 4) -> tuple:
    """``(operations, bytes)`` of one ``stencil.apply``: its point function's
    operations at every point of its result bounds; the window of each
    operand it reads (the result grown by that operand's access extent)
    read once, and each result written once."""
    rb = apply_op.result_bounds
    points = _numel(rb.shape)
    windows = sum(
        _numel([n + h - l for n, l, h in zip(rb.shape, lo, hi)])
        for lo, hi in apply_op.access_extents().values()
    )
    n_ops = points * sum(isinstance(op, ARITH_OPS) for op in apply_op.body.ops)
    return n_ops, itemsize * (windows + points * len(apply_op.results))


def epoch_counts(fused_op: stencil.FusedEpochOp, itemsize: int = 4) -> tuple:
    """``(operations, bytes)`` of one ``stencil.fused_epoch``: every
    operation of every sub-step's frame; each operand read once and each
    escape written once (the intermediates never leave the chip)."""
    n_bytes = itemsize * (
        sum(_numel(a.type.bounds.shape) for a in fused_op.body.args)
        + sum(_numel(r.type.bounds.shape) for r in fused_op.results)
    )
    n_ops = sum(
        apply_counts(op, itemsize)[0]
        for op in fused_op.body.ops if isinstance(op, stencil.ApplyOp)
    )
    return n_ops, n_bytes


def _masks_a_point(op: comm.BoundaryMaskOp, coords: Mapping[str, int]) -> bool:
    """Whether the mask zeroes any point of its value on this rank."""
    from repro_torch.core.lowering import keep_box

    vb = op.temp.type.bounds
    return any(vb.lb[d] < lo or vb.ub[d] > hi for d, (lo, hi) in keep_box(op, coords).items())


def _sends_to_another_rank(op: comm.ExchangeStartOp, sizes: Mapping[str, int],
                           coords: Mapping[str, int]) -> bool:
    """Whether this rank's send rectangle of ``op`` goes to another rank
    (``comm.permute_pairs``; a size-1 axis emulates its exchange locally)."""
    names = [a for a, _ in op.axis_shifts]
    axis_sizes = {a: sizes.get(a, 1) for a in names}
    periodic = bool(op.attributes.get("periodic", ir.IntAttr(0)).value)
    _, pairs = comm.permute_pairs(op.axis_shifts, axis_sizes, periodic)
    lin = 0
    for a in names:
        lin = lin * axis_sizes[a] + (coords.get(a, 0) if axis_sizes[a] > 1 else 0)
    return any(src == lin and dst != src for src, dst in pairs)


def _rank_counts(func: ir.FuncOp, sizes: Mapping[str, int], coords: Mapping[str, int],
                 itemsize: int) -> IRCounts:
    from repro_torch.core.lowering import in_place_combines

    in_place = in_place_combines(func)[1]
    out = IRCounts()
    for op in func.body.ops:
        n_ops = n_bytes = 0
        if isinstance(op, stencil.ApplyOp):
            n_ops, n_bytes = apply_counts(op, itemsize)
        elif isinstance(op, stencil.FusedEpochOp):
            n_ops, n_bytes = epoch_counts(op, itemsize)
        elif isinstance(op, comm.HaloPadOp):
            core, padded = op.temp.type.bounds, op.results[0].type.bounds
            if padded != core:
                n_bytes = itemsize * (_numel(core.shape) + _numel(padded.shape))
        elif isinstance(op, comm.BoundaryMaskOp):
            if _masks_a_point(op, coords):
                n_bytes = 2 * itemsize * _numel(op.temp.type.bounds.shape)
        elif isinstance(op, stencil.CombineOp) and op not in in_place:
            n_bytes = 2 * itemsize * sum(_numel(v.type.bounds.shape) for v in op.operands)
        elif isinstance(op, comm.ExchangeStartOp):
            if _sends_to_another_rank(op, sizes, coords):
                kind = "collective-permute"
                out.collectives[kind] = out.collectives.get(kind, 0.0) + itemsize * _numel(op.size)
        elif isinstance(op, comm.AllReduceOp):
            if math.prod(sizes.get(a, 1) for a in op.axes) > 1:
                kind = "all-reduce"
                bounds = getattr(op.operands[0].type, "bounds", None)  # none: a scalar
                n = itemsize * (_numel(bounds.shape) if bounds is not None else 1)
                out.collectives[kind] = out.collectives.get(kind, 0.0) + n
        out.flops += n_ops
        out.bytes_accessed += n_bytes
    return out


def count_ir(func: ir.FuncOp, axis_sizes: Optional[Mapping[str, int]] = None,
             itemsize: int = 4) -> IRCounts:
    """The least work of one call of ``func`` (a rank-local, comm-lowered
    function) on its busiest rank, each term by itself.

    - operations: each ``stencil.apply``'s point function at every point
      of its result bounds; for a ``stencil.fused_epoch``, the same over
      its sub-steps (:func:`apply_counts`, :func:`epoch_counts`);
    - bytes: each apply's operand windows read and results written once;
      a fused epoch's operands read and escapes written once; a
      ``comm.halo_pad``'s core read and padded buffer written once; a
      ``comm.boundary_mask`` that zeroes a point on the rank, its value
      read and written; a ``stencil.combine`` that is not assembled in
      place, its parts read and written;
    - collective bytes: each ``comm.exchange_start`` send rectangle that
      reaches another rank, and each ``comm.allreduce`` operand over more
      than one rank.

    ``axis_sizes`` maps each mesh axis to its size (none: one device,
    where every exchange is emulated locally).  Every rank of the mesh is
    counted, and each term is the largest over ranks."""
    sizes = dict(axis_sizes or {})
    names = list(sizes)
    per_rank = [
        _rank_counts(func, sizes, dict(zip(names, c)), itemsize)
        for c in itertools.product(*(range(sizes[n]) for n in names))
    ]
    kinds = sorted({k for c in per_rank for k in c.collectives})
    return IRCounts(
        flops=max(c.flops for c in per_rank),
        bytes_accessed=max(c.bytes_accessed for c in per_rank),
        collectives={k: max(c.collectives.get(k, 0.0) for c in per_rank) for k in kinds},
    )


# --------------------------------------------------------------------------
# the language-model half: dry-run cells
# --------------------------------------------------------------------------

SHAPE_TOKENS = {
    "train_4k": 4_096 * 256,
    "prefill_32k": 32_768 * 32,
    "decode_32k": 128,          # one token per sequence
    "long_500k": 1,
}
TRAIN_MULT = {"train_4k": 3.0}  # fwd+bwd ≈ 3× forward FLOPs

_DIMS_CACHE: dict = {}


def _arch_dims(arch: str) -> tuple:
    if arch not in _DIMS_CACHE:
        try:
            from repro_torch.configs import get_config

            cfg = get_config(arch)
            _DIMS_CACHE[arch] = (cfg.d_model, cfg.n_layers)
        except KeyError:
            _DIMS_CACHE[arch] = (4096, 32)
    return _DIMS_CACHE[arch]


@dataclass
class Cell:
    """One dry-run record's terms, per rank.  ``bytes_accessed`` is
    ``None`` in the port's records (no HLO): the memory term is then the
    analytic one."""

    arch: str
    shape: str
    mesh: str
    n_devices: int
    flops: float
    bytes_accessed: Optional[float]
    collective_bytes: float
    collectives: dict
    params: int
    active_params: int
    arg_bytes: float = 0.0  # per-rank resident args (params + caches)

    @property
    def t_compute(self) -> float:
        return self.flops / LM_PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        """Recorded bytes over HBM, else :attr:`t_memory_analytic`."""
        if self.bytes_accessed is None:
            return self.t_memory_analytic
        return self.bytes_accessed / HBM_BW

    @property
    def t_memory_analytic(self) -> float:
        """Algorithmic minimum HBM traffic per rank.

        train:   3 passes over the params at 4 B (fwd read, bwd read,
                 update r/w of param+m+v ≈ 12 B) + layer activation
                 checkpoints (2 B, written fwd + read bwd) + logits.
        prefill: params once (2 B) + activations once + KV cache write.
        decode:  resident state once (params + caches ≈ arg_bytes)."""
        d_model, n_layers = _arch_dims(self.arch)
        toks = SHAPE_TOKENS.get(self.shape, 0) / self.n_devices
        if self.shape.startswith("train"):
            param_traffic = self.active_params * 24.0 / self.n_devices
            act_traffic = 4.0 * toks * 2.0 * d_model * n_layers
            return (param_traffic + act_traffic) / HBM_BW
        if self.shape.startswith("prefill"):
            p_dev = 2.0 * self.active_params / 16  # bf16, TP-sharded; DP replicates
            act_traffic = 4.0 * toks * 2.0 * d_model * n_layers
            return (p_dev + act_traffic) / HBM_BW
        return max(self.arg_bytes, 1.0) / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.collective_bytes / NVLINK_BW

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory_analytic,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def t_overlapped(self) -> float:
        return max(self.t_compute, self.t_memory_analytic, self.t_collective)

    @property
    def t_serial(self) -> float:
        return self.t_compute + self.t_memory_analytic + self.t_collective

    @property
    def model_flops(self) -> float:
        tokens = SHAPE_TOKENS.get(self.shape, 0)
        mult = TRAIN_MULT.get(self.shape, 1.0)
        return 2.0 * self.active_params * tokens * mult  # 2ND/token fwd

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS / (counted FLOPs × ranks)."""
        total = self.flops * self.n_devices
        return self.model_flops / total if total else 0.0

    @property
    def is_decode(self) -> bool:
        return self.shape.startswith(("decode", "long"))

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the modeled (overlapped) step time that is
        irreducible: useful model FLOPs at peak (train/prefill), one read
        of the resident state at full HBM bandwidth (decode/long)."""
        if self.t_overlapped == 0:
            return 0.0
        if self.is_decode:
            if not self.arg_bytes:
                return 0.0
            t_ideal = self.arg_bytes / HBM_BW
            t_model = max(self.t_compute, self.t_memory, self.t_collective)
        else:
            t_ideal = self.model_flops / self.n_devices / LM_PEAK_FLOPS
            t_model = self.t_overlapped
        return min(1.0, t_ideal / t_model)


def advice(c: Cell) -> str:
    if c.dominant == "collective":
        kinds = sorted(c.collectives, key=c.collectives.get, reverse=True)
        top = kinds[0] if kinds else "?"
        return f"cut {top} volume (resharding/fusion of collectives, overlap with compute)"
    if c.dominant == "memory":
        if c.shape.startswith("decode") or c.shape.startswith("long"):
            return "KV/state residency: smaller cache dtype, fused decode reads"
        return "remat policy / fusion to cut HBM round-trips"
    return "tensor-core utilization: larger per-rank matmul tiles, less padding"


def load_cells(outdir: str) -> list:
    """The dry run's records in ``outdir`` (``ok`` ones), as cells."""
    cells = []
    for path in sorted(glob.glob(os.path.join(outdir, "*.json"))):
        with open(path) as f:
            d = json.load(f)
        if not d.get("ok"):
            continue
        coll = d.get("collective_bytes", {})
        mem = d.get("memory") or {}
        cells.append(
            Cell(
                arch=d["arch"],
                shape=d["shape"],
                mesh=d["mesh"],
                n_devices=d["n_devices"],
                flops=d["cost"]["flops"] or 0.0,
                bytes_accessed=d["cost"].get("bytes_accessed"),
                collective_bytes=sum(coll.values()),
                collectives=coll,
                params=d.get("params", 0),
                active_params=d.get("active_params", 0) or d.get("params", 0),
                arg_bytes=mem.get("argument_bytes") or 0.0,
            )
        )
    return cells


def fmt_s(t: float) -> str:
    if t >= 1.0:
        return f"{t:.2f}s"
    if t >= 1e-3:
        return f"{t*1e3:.1f}ms"
    return f"{t*1e6:.0f}µs"


def report(cells: list, markdown: bool = False, mesh: str = "16x16") -> str:
    rows = []
    for c in cells:
        if c.mesh != mesh:
            continue
        rows.append(
            (
                c.arch, c.shape,
                fmt_s(c.t_compute), fmt_s(c.t_memory_analytic),
                "-" if c.bytes_accessed is None else fmt_s(c.t_memory),
                fmt_s(c.t_collective),
                c.dominant,
                f"{c.useful_ratio:.2f}",
                f"{c.roofline_fraction*100:.0f}%",
                advice(c),
            )
        )
    headers = ["arch", "shape", "t_comp", "t_mem", "t_mem(hlo)", "t_coll",
               "dominant", "useful", "roofline", "to improve"]
    if markdown:
        out = ["| " + " | ".join(headers) + " |",
               "|" + "|".join("---" for _ in headers) + "|"]
        out += ["| " + " | ".join(str(x) for x in r) + " |" for r in rows]
        return "\n".join(out)
    widths = [max(len(str(h)), max((len(str(r[i])) for r in rows), default=0))
              for i, h in enumerate(headers)]
    out = ["  ".join(h.ljust(w) for h, w in zip(headers, widths))]
    out += ["  ".join(str(c).ljust(w) for c, w in zip(r, widths)) for r in rows]
    return "\n".join(out)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--outdir", default="build/dryrun")
    ap.add_argument("--markdown", action="store_true")
    ap.add_argument("--mesh", default="16x16")
    args = ap.parse_args()
    cells = load_cells(args.outdir)
    print(report(cells, markdown=args.markdown, mesh=args.mesh))
    sp = [c for c in cells if c.mesh == args.mesh]
    if sp:
        worst = min(sp, key=lambda c: c.roofline_fraction)
        coll = max(sp, key=lambda c: c.t_collective / max(c.t_overlapped, 1e-12))
        print(f"\nworst roofline fraction : {worst.arch} × {worst.shape} "
              f"({worst.roofline_fraction*100:.0f}%)")
        print(f"most collective-bound   : {coll.arch} × {coll.shape} "
              f"(t_coll {fmt_s(coll.t_collective)})")


if __name__ == "__main__":
    main()
