# Copied from src/repro/core/passes/fusion.py with repro. renamed to repro_torch.; keep its logic in step with that file.
"""Stencil-apply fusion (paper sec. 6.2).

"for the PW advection benchmark the three stencil computations are fused
into one single stencil region by xDSL, but with tracer advection there
are 18 individual stencil regions due to dependencies."

Two flavours, both operating on the *global* (pre-decomposition) function
so that halo inference afterwards sees the fused access patterns:

- **horizontal** fusion merges independent applies with identical result
  bounds into one multi-result apply (PW advection's 3 → 1);
- **vertical** fusion inlines a producer apply into its sole consumer,
  shifting the producer's accesses by the consumer's access offset
  (classic OEC value-semantics inlining; trades recompute for locality
  and, after decomposition, fewer exchanges with deeper halos).
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core import ir
from repro_torch.core.dialects import stencil


def fuse_applies(
    func: ir.FuncOp,
    horizontal: bool = True,
    vertical: bool = True,
    max_recompute_accesses: int = 64,
) -> None:
    changed = True
    while changed:
        changed = False
        if vertical and _fuse_one_vertical(func, max_recompute_accesses):
            changed = True
        if horizontal and _fuse_one_horizontal(func):
            changed = True
    _dce(func)


# -- helpers ----------------------------------------------------------------


def _applies(func: ir.FuncOp) -> list:
    return [op for op in func.body.ops if isinstance(op, stencil.ApplyOp)]


def _transitively_depends(later: ir.Operation, earlier: ir.Operation, block: ir.Block) -> bool:
    """Does ``later`` (transitively) consume any result of ``earlier``?"""
    earlier_vals = set(earlier.results)
    start = block.ops.index(earlier)
    stop = block.ops.index(later)
    for op in block.ops[start + 1 : stop + 1]:
        if any(o in earlier_vals for o in op.operands):
            if op is later:
                return True
            earlier_vals.update(op.results)
    return False


def _fuse_one_horizontal(func: ir.FuncOp) -> bool:
    applies = _applies(func)
    for i, a in enumerate(applies):
        for b in applies[i + 1 :]:
            if a.result_bounds != b.result_bounds:
                continue
            if a.results[0].type.element_type != b.results[0].type.element_type:
                continue
            if _transitively_depends(b, a, func.body):
                continue
            # dominance: merged apply sits at b's position, so every use of
            # a's results must occur after b
            b_pos = func.body.ops.index(b)
            uses_ok = all(
                func.body.ops.index(u.operation) > b_pos
                for r in a.results
                for u in r.uses
                if u.operation.parent_block is func.body
            )
            if not uses_ok:
                continue
            _merge_applies(func, a, b)
            return True
    return False


def _merge_applies(func: ir.FuncOp, a: stencil.ApplyOp, b: stencil.ApplyOp) -> None:
    operands: list[ir.SSAValue] = []
    for o in (*a.operands, *b.operands):
        if o not in operands:
            operands.append(o)
    merged = stencil.ApplyOp(
        operands,
        a.result_bounds,
        n_results=len(a.results) + len(b.results),
        element_type=a.results[0].type.element_type,
    )
    vmap: dict[ir.SSAValue, ir.SSAValue] = {}
    for src in (a, b):
        for old_barg, operand in zip(src.body.args, src.operands):
            vmap[old_barg] = merged.body.args[operands.index(operand)]
    rets: list[ir.SSAValue] = []
    for src in (a, b):
        for body_op in src.body.ops:
            if isinstance(body_op, stencil.StencilReturnOp):
                rets.extend(vmap.get(v, v) for v in body_op.operands)
            else:
                merged.body.add_op(body_op.clone_into(vmap))
    merged.body.add_op(stencil.StencilReturnOp(rets))
    # insert where b was (both values dominate uses: b is the later one)
    func.body.insert_op_before(merged, b)
    for idx, old_res in enumerate((*a.results, *b.results)):
        old_res.replace_all_uses_with(merged.results[idx])
    a.erase()
    b.erase()


def _sole_consumer_apply(op: stencil.ApplyOp) -> Optional[stencil.ApplyOp]:
    consumer: Optional[stencil.ApplyOp] = None
    for res in op.results:
        for use in res.uses:
            if not isinstance(use.operation, stencil.ApplyOp):
                return None
            if consumer is None:
                consumer = use.operation
            elif consumer is not use.operation:
                return None
    return consumer


def _fuse_one_vertical(func: ir.FuncOp, max_recompute_accesses: int) -> bool:
    for producer in _applies(func):
        consumer = _sole_consumer_apply(producer)
        if consumer is None or consumer is producer:
            continue
        if producer.result_bounds != consumer.result_bounds:
            continue
        n_sites = sum(
            1
            for acc in consumer.accesses()
            if consumer.operands[acc.temp.index] in producer.results
        )
        n_prod_accesses = len(producer.accesses())
        if n_sites * n_prod_accesses > max_recompute_accesses:
            continue
        _inline_producer(func, producer, consumer)
        return True
    return False


def _inline_producer(
    func: ir.FuncOp, producer: stencil.ApplyOp, consumer: stencil.ApplyOp
) -> None:
    prod_ret = producer.body.ops[-1]
    assert isinstance(prod_ret, stencil.StencilReturnOp)

    # new operand list: consumer's (minus producer results) + producer's
    new_operands: list[ir.SSAValue] = []
    for o in consumer.operands:
        if o not in producer.results and o not in new_operands:
            new_operands.append(o)
    for o in producer.operands:
        if o not in new_operands:
            new_operands.append(o)

    fused = stencil.ApplyOp(
        new_operands,
        consumer.result_bounds,
        n_results=len(consumer.results),
        element_type=consumer.results[0].type.element_type,
    )

    def new_arg_for(operand: ir.SSAValue) -> ir.SSAValue:
        return fused.body.args[new_operands.index(operand)]

    vmap: dict[ir.SSAValue, ir.SSAValue] = {}
    for old_barg, operand in zip(consumer.body.args, consumer.operands):
        if operand not in producer.results:
            vmap[old_barg] = new_arg_for(operand)

    def inline_producer_at(offset: tuple, result_idx: int) -> ir.SSAValue:
        """Clone producer body shifted by ``offset``; return its result_idx value."""
        pmap: dict[ir.SSAValue, ir.SSAValue] = {}
        for p_barg, p_operand in zip(producer.body.args, producer.operands):
            pmap[p_barg] = new_arg_for(p_operand)
        out: Optional[ir.SSAValue] = None
        for body_op in producer.body.ops:
            if isinstance(body_op, stencil.StencilReturnOp):
                out = pmap.get(body_op.operands[result_idx], body_op.operands[result_idx])
                break
            if isinstance(body_op, stencil.AccessOp):
                shifted = stencil.AccessOp(
                    pmap[body_op.temp],
                    tuple(o + d for o, d in zip(body_op.offset, offset)),
                )
                fused.body.add_op(shifted)
                pmap[body_op.results[0]] = shifted.results[0]
            else:
                fused.body.add_op(body_op.clone_into(pmap))
        assert out is not None
        return out

    for body_op in consumer.body.ops:
        if isinstance(body_op, stencil.AccessOp):
            operand = consumer.operands[body_op.temp.index]
            if operand in producer.results:
                r_idx = producer.results.index(operand)
                vmap[body_op.results[0]] = inline_producer_at(body_op.offset, r_idx)
                continue
        fused.body.add_op(body_op.clone_into(vmap))

    func.body.insert_op_before(fused, consumer)
    for old_res, new_res in zip(consumer.results, fused.results):
        old_res.replace_all_uses_with(new_res)
    consumer.erase()
    if all(not r.uses for r in producer.results):
        producer.erase()


def _dce(func: ir.FuncOp) -> None:
    from repro_torch.core.passes.swap_elim import _dce_block

    _dce_block(func.body)
