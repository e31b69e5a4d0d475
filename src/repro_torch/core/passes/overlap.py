# Copied from src/repro/core/passes/overlap.py with repro. renamed to repro_torch.; keep its logic in step with that file.
"""Communication/computation overlap — **beyond-paper** (sec. 8 lists it as
future work: "Further work includes ... DMP/MPI optimizations, such as
diagonal communications ... and communication/computation overlap").

Two cooperating passes make overlap an *IR-level* transformation:

- ``enable_comm_compute_overlap`` tags eligible ``dmp.swap`` ops
  (``overlap = true``): swaps with exchanges whose result feeds exactly
  one ``stencil.apply`` with a non-empty interior.

- ``split_overlapped_applies`` consumes every tagged swap, rewriting
  ``swap + apply`` into the canonical comm-level sequence

      comm.halo_pad → comm.exchange_start* → stencil.apply (interior)
          → comm.wait → stencil.apply (boundary frames)* → stencil.combine

  The *interior* apply (the consumer's domain shrunk by its access
  extents) reads the padded-but-unexchanged value — every access stays
  inside the core, which the exchange never touches — so it carries no
  data dependence on the waits.  XLA's latency-hiding scheduler then
  rides the ppermute(s) under the interior compute: the dataflow
  analogue of MPI_Isend/Irecv + interior kernel + MPI_Waitall + boundary
  kernel, visible and verifiable in the lowered IR.

Untagged swaps are lowered by the ordinary ``lower_dmp_to_comm`` pass, so
after ``overlap → lower-comm`` there is exactly one exchange execution
path (comm ops) regardless of overlap.
"""
from __future__ import annotations

from repro_torch.core import ir
from repro_torch.core.ir import IntAttr, StringAttr
from repro_torch.core.dialects import comm, dmp, stencil
from repro_torch.core.passes.lower_comm import emit_exchange_rounds, exchange_start_for


def enable_comm_compute_overlap(func: ir.FuncOp) -> int:
    """Tag eligible swaps; returns how many were tagged."""
    n = 0
    for op in func.body.ops:
        if not isinstance(op, dmp.SwapOp):
            continue
        if not op.exchanges:
            continue
        if _split_plan(op) is not None:
            op.attributes["overlap"] = IntAttr(1)
            n += 1
    return n


def overlap_enabled(swap: dmp.SwapOp) -> bool:
    a = swap.attributes.get("overlap")
    return a is not None and a.value == 1  # type: ignore[union-attr]


# --------------------------------------------------------------------------
# The split rewrite
# --------------------------------------------------------------------------


def _bounds_or_none(lb: tuple, ub: tuple):
    """Bounds(lb, ub), or None when empty in any dim (Bounds itself
    asserts non-degeneracy)."""
    if any(u - l <= 0 for l, u in zip(lb, ub)):
        return None
    return stencil.Bounds(tuple(lb), tuple(ub))


def _intersect(a: stencil.Bounds, b: stencil.Bounds):
    """Intersection of two bounds, or None when empty in any dim."""
    return _bounds_or_none(
        tuple(max(x, y) for x, y in zip(a.lb, b.lb)),
        tuple(min(x, y) for x, y in zip(a.ub, b.ub)),
    )


def _split_plan(swap: dmp.SwapOp):
    """The (consumer apply, interior bounds) this swap's split would use,
    or None when ineligible (shared result, non-apply consumer, or empty
    interior).

    The interior is the part of the consumer's domain whose reads stay
    inside the swap's *pre-exchange core* — the exchange only writes
    outside it — intersected with the result bounds.  For the standard
    pipeline the two coincide (result bounds == core); a deep-halo
    temporally-tiled apply computes *beyond* the core, so shrinking only
    the result bounds would race the interior against the in-flight
    exchange."""
    consumers = {u.operation for u in swap.results[0].uses}
    if len(consumers) != 1:
        return None
    apply = next(iter(consumers))
    if not isinstance(apply, stencil.ApplyOp):
        return None
    lo_w, hi_w = _apply_halo_widths(apply)
    rb = apply.result_bounds
    core: stencil.Bounds = swap.temp.type.bounds
    safe = _bounds_or_none(
        tuple(b + w for b, w in zip(core.lb, lo_w)),
        tuple(b - w for b, w in zip(core.ub, hi_w)),
    )
    interior = _intersect(rb, safe) if safe is not None else None
    if interior is None:
        return None
    return apply, interior


def _apply_halo_widths(apply: stencil.ApplyOp) -> tuple:
    """Union access extents of ALL operands → frame widths per dim."""
    rank = apply.result_bounds.rank
    lo = [0] * rank
    hi = [0] * rank
    for _, (l, h) in apply.access_extents().items():
        lo = [min(a, b) for a, b in zip(lo, l)]
        hi = [max(a, b) for a, b in zip(hi, h)]
    return [-l for l in lo], list(hi)


def split_overlapped_applies(func: ir.FuncOp) -> ir.FuncOp:
    """Rewrite every tagged ``swap + apply`` pair into the explicit
    overlapped comm sequence (module docstring); preserves ``sym_name``."""
    plans: dict = {}  # tagged swap -> (apply, interior)
    by_apply: dict = {}  # consumer apply -> [tagged swaps feeding it]
    declined: list = []  # tagged but ineligible: untag, lower-comm handles
    for op in func.body.ops:
        if isinstance(op, dmp.SwapOp) and overlap_enabled(op):
            plan = _split_plan(op)
            if plan is None:
                declined.append(op)
                continue
            plans[op] = plan
            by_apply.setdefault(plan[0], []).append(op)
    # several tagged swaps feeding one apply: the interior safe from ALL
    # in-flight exchanges is the intersection of the per-swap interiors
    interiors: dict = {}
    for apply, swaps in list(by_apply.items()):
        interior = plans[swaps[0]][1]
        for s in swaps[1:]:
            interior = (
                _intersect(interior, plans[s][1])
                if interior is not None
                else None
            )
        if interior is None:
            declined.extend(swaps)
            for s in swaps:
                del plans[s]
            del by_apply[apply]
        else:
            interiors[apply] = interior
    # clearing declined tags keeps the invariant that a tag reaching
    # lower_dmp_to_comm means the split pass never ran (it warns there)
    for op in declined:
        del op.attributes["overlap"]
    if not plans:
        return func

    new_func = ir.FuncOp(func.sym_name, [a.type for a in func.body.args])
    block = new_func.body
    vmap: dict[ir.SSAValue, ir.SSAValue] = {}
    for oa, na in zip(func.body.args, new_func.body.args):
        vmap[oa] = na
    # in-flight state per tagged swap: padded value + round-1 patches
    pending: dict[dmp.SwapOp, dict] = {}

    for op in func.body.ops:
        if op in plans:
            pad = comm.HaloPadOp(
                vmap[op.temp], op.result_bounds, op.boundary, op.grid
            )
            block.add_op(pad)
            rounds = op.rounds()
            starts = [
                block.add_op(exchange_start_for(e, op, pad.results[0]))
                for e in rounds[0]
            ]
            pending[op] = {
                "padded": pad.results[0],
                "patches": [s.results[0] for s in starts],
                "later_rounds": rounds[1:],
            }
            continue
        if isinstance(op, stencil.ApplyOp) and op in by_apply:
            _emit_split_apply(
                block, op, by_apply[op], interiors[op], pending, vmap
            )
            continue
        block.add_op(op.clone_into(vmap))
    return new_func


def _emit_split_apply(block, apply, swaps, interior, pending, vmap) -> None:
    rb = apply.result_bounds
    padded_of = {s.results[0]: pending[s]["padded"] for s in swaps}

    # interior: padded-but-unexchanged operands — no dependence on waits
    pre_operands = [
        padded_of[o] if o in padded_of else vmap.get(o, o)
        for o in apply.operands
    ]
    interior_apply = _clone_apply(apply, pre_operands, interior, "interior")
    block.add_op(interior_apply)

    # waits (and any later sequential rounds), then the exchanged values
    exchanged_of: dict[ir.SSAValue, ir.SSAValue] = {}
    for s in swaps:
        st = pending.pop(s)
        wait = comm.WaitOp(st["padded"], st["patches"])
        block.add_op(wait)
        cur = emit_exchange_rounds(block, s, wait.results[0], st["later_rounds"])
        exchanged_of[s.results[0]] = cur
        vmap[s.results[0]] = cur

    # boundary frames on the fully exchanged operands; the frame widths
    # are whatever rb extends beyond the (possibly core-clipped) interior
    post_operands = [
        exchanged_of[o] if o in exchanged_of else vmap.get(o, o)
        for o in apply.operands
    ]
    eff_lo = [il - rl for il, rl in zip(interior.lb, rb.lb)]
    eff_hi = [ru - iu for ru, iu in zip(rb.ub, interior.ub)]
    frames = []
    for slab in frame_slabs(rb, eff_lo, eff_hi):
        frame = _clone_apply(apply, post_operands, slab, "frame")
        block.add_op(frame)
        frames.append(frame)

    # reassemble: interior + frames tile rb exactly
    for k, res in enumerate(apply.results):
        parts = [interior_apply.results[k]] + [f.results[k] for f in frames]
        combine = stencil.CombineOp(parts, rb, res.type.element_type)
        block.add_op(combine)
        vmap[res] = combine.results[0]


def _clone_apply(apply, operands, bounds, part: str) -> stencil.ApplyOp:
    new = stencil.ApplyOp(
        operands,
        bounds,
        n_results=len(apply.results),
        element_type=apply.results[0].type.element_type,
    )
    new.attributes["part"] = StringAttr(part)
    body_map: dict[ir.SSAValue, ir.SSAValue] = {}
    for oa, na in zip(apply.body.args, new.body.args):
        body_map[oa] = na
    for body_op in apply.body.ops:
        new.body.add_op(body_op.clone_into(body_map))
    return new


def frame_slabs(rb: stencil.Bounds, lo_w, hi_w) -> list:
    """Disjoint onion-peel partition of ``rb`` minus its interior."""
    rank = rb.rank
    slabs = []
    for d in range(rank):
        def bounds_for(d_lo, d_ub):
            lb, ub = [], []
            for k in range(rank):
                if k < d:
                    lb.append(rb.lb[k] + lo_w[k])
                    ub.append(rb.ub[k] - hi_w[k])
                elif k == d:
                    lb.append(d_lo)
                    ub.append(d_ub)
                else:
                    lb.append(rb.lb[k])
                    ub.append(rb.ub[k])
            return stencil.Bounds(tuple(lb), tuple(ub))

        if lo_w[d] > 0:
            slabs.append(bounds_for(rb.lb[d], rb.lb[d] + lo_w[d]))
        if hi_w[d] > 0:
            slabs.append(bounds_for(rb.ub[d] - hi_w[d], rb.ub[d]))
    return [s for s in slabs if all(x > 0 for x in s.shape)]
