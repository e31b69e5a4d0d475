"""Top-k token-choice MoE with capacity-based scatter dispatch and
expert parallelism (port of ``repro.models.moe``).

Single rank: route each token to its top-k experts, scatter the
assignments into an ``[E, C, D]`` buffer (capacity C per expert; overflow,
in the order of the flattened assignments, drops to the residual), run
every expert's SwiGLU over its buffer, then gather and gate-combine.

Under an active mesh whose ``ep_axis`` has ``n_ep > 1`` ranks and
``E % n_ep == 0``, every rank computes its part through the port's
single-controller ``shard_map`` and collectives (expert weights split over
their expert dim, the router replicated):

- ``ep_block``: each rank of the ``ep_axis`` routes its 1/n_ep slice of
  its data shard's tokens into a buffer of per-shard capacity, two tiled
  ``all_to_all`` s re-bucket it by expert owner and back, and a ``psum``
  reassembles the tokens; the aux losses are ``pmean`` 'd over the axis;
- ``ep_block_small`` (tokens per data shard not divisible by n_ep:
  decode): routing replicated, each rank runs its resident experts and
  the combined outputs are ``psum`` 'd.

The aux losses that come back are data shard 0's (the reference's
``out_specs=P()`` takes the first device's value); their gradient is the
reference's too, each rank's share divided by the number of ranks
(``dist.sharding.unstack``).  The blocks run every rank at once, the
ranks' tensors stacked in front (``shard_map(stacked_ranks=True)``), so the
helpers below take any leading dims; the router, the experts and the
combine (products and float sums) run one rank at a time
(``dist.sharding.per_rank``), so that a rank computes its tokens as a
process that holds only them does, and the router's product runs in
blocks of a fixed number of tokens (:func:`router_logits`), so that a
token is routed alike on one rank and under expert parallelism.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import (
    PartitionSpec as P,
    _valid_spec,
    active_mesh,
    active_rules,
    all_to_all,
    own_chunk,
    per_rank,
    place_chunk,
    pmean,
    psum,
    shard_map,
)
from repro_torch.models.layers import dense_init, einsum32, einsum_lp, normal, operand


def moe_init(gen, device, cfg, lead: tuple = ()) -> dict:
    assert cfg.moe is not None
    E = cfg.moe.num_experts
    d, dff = cfg.d_model, cfg.d_ff
    return {
        "router": dense_init(gen, device, d, E, scale=0.02, lead=lead),
        "wi": normal(gen, device, (*lead, E, d, dff)).div_(d**0.5),
        "wu": normal(gen, device, (*lead, E, d, dff)).div_(d**0.5),
        "wo": normal(gen, device, (*lead, E, dff, d)).div_(dff**0.5),
    }


def top_k(x: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest along the last dim, ties in index
    order (a stable descending sort; ``torch.topk`` promises no order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


#: Tokens per router product (see :func:`router_logits`).
ROUTER_BLOCK = 256


def router_logits(xt, router, dtype):
    """``einsum32("nd,de->ne", xt, router)`` in blocks of ``ROUTER_BLOCK``
    tokens, each one product of one shape (the last block padded with
    zero rows): a token's logits, and so its top-k, do not depend on how
    many tokens share the call.  cuBLAS picks its kernel, and with it the
    order of the sums, by the shape, so one product over all the tokens
    routes a near-tied token otherwise than a product over one rank's
    share of them.  Stacked ranks on meta tensors (the dry run) take one
    product."""
    if xt.is_meta or xt.ndim != 2:
        return einsum32("...nd,...de->...ne", xt, router, dtype=dtype)
    n, d = xt.shape
    x, w = operand(xt, dtype), operand(router, dtype)
    pad = -n % ROUTER_BLOCK
    if pad:
        x = torch.cat([x, x.new_zeros(pad, d)])
    return torch.cat([x[i:i + ROUTER_BLOCK] @ w for i in range(0, n + pad, ROUTER_BLOCK)])[:n]


def _route(p, xt, cfg, dtype):
    """xt: [*lead, n, D] → (gate_vals [*lead,n,K], gate_idx [*lead,n,K],
    aux {name: [*lead]}); ``lead`` is empty on one rank and the stacked
    ranks' dims under expert parallelism (the router then carries them
    too)."""
    mcfg = cfg.moe
    logits = router_logits(xt, p["router"], dtype)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = top_k(probs, mcfg.top_k)
    gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)
    # each expert's count of assignments: the reference's scatter-add of
    # ones, exact in float32 (counts < 2**24), without atomics
    experts = torch.arange(mcfg.num_experts, device=xt.device)[:, None]
    assigned = gate_idx.flatten(-2)
    density = (assigned[..., None, :] == experts).sum(-1).to(torch.float32)
    density = density / assigned.shape[-1]
    lb_loss = mcfg.num_experts * torch.sum(density * probs.mean(-2), dim=-1)
    z_loss = mcfg.router_z_loss * torch.mean(torch.square(torch.logsumexp(logits, dim=-1)), dim=-1)
    return gate_vals, gate_idx, {"moe_lb_loss": lb_loss, "moe_z_loss": z_loss}


def _flat_rows(idx, rows: int):
    """``idx`` [*lead, M] into ``rows`` rows per lead entry, as indices into
    the lead entries' rows stacked one after another."""
    lead = idx.shape[:-1]
    if not lead:
        return idx
    off = torch.arange(math.prod(lead), device=idx.device).reshape(*lead, 1) * rows
    return (idx + off).reshape(-1)


class _RowGather(torch.autograd.Function):
    """``out[r] = src[idx[r]]``, a zero row where ``idx[r]`` is
    ``len(src)``, for an ``idx`` that is one-to-one onto the rows it
    takes, with ``inv`` its inverse (``inv[idx[r]] = r``; ``len(out)``
    for a row no one takes); over leading dims (stacked ranks) each entry
    on its own.  The backward is then the inverse gather,
    ``grad_src[i] = grad_out[inv[i]]``: each row's gradient is one row,
    where autograd's index backward would scatter-add with atomics (or
    sort, under deterministic algorithms)."""

    @staticmethod
    def forward(ctx, src, idx, inv):
        ctx.save_for_backward(inv)
        return _RowGather.take(src, idx)

    @staticmethod
    def backward(ctx, grad):
        (inv,) = ctx.saved_tensors
        return _RowGather.take(grad, inv), None, None

    @staticmethod
    def take(src, idx):
        lead, (n, d) = src.shape[:-2], src.shape[-2:]
        padded = torch.cat([src, src.new_zeros((*lead, 1, d))], dim=-2).reshape(-1, d)
        return padded.index_select(0, _flat_rows(idx, n + 1)).reshape(*idx.shape, d)


def _holder(dest, rows: int):
    """The assignment that fills each of ``rows`` buffer rows, where
    assignment ``i`` fills row ``dest[..., i]`` (the kept ones are
    distinct; ``rows`` is the dropped row): ``dest.shape[-1]`` for a row no
    one fills.  A sort and a search, so no scatter with colliding
    indices."""
    n = dest.shape[-1]
    sorted_dest, order = torch.sort(dest, dim=-1, stable=True)
    r = torch.arange(rows, device=dest.device).expand(*dest.shape[:-1], rows).contiguous()
    at = torch.searchsorted(sorted_dest, r).clamp_(max=n - 1)
    return torch.where(torch.gather(sorted_dest, -1, at) == r, torch.gather(order, -1, at), n)


def _dispatch_scatter(xt, gate_idx, E: int, C: int):
    """Scatter tokens [*lead, n, D] into [*lead, E, C, D]; returns
    (buffer, dest [*lead, n*K], kept)."""
    n, K = gate_idx.shape[-2:]
    flat_e = gate_idx.flatten(-2)                               # [*lead, n*K]
    # rank of each assignment within its expert bucket, in flattened order
    # (a scan along the last dim of the one-hot's transpose: along its first
    # dim the card scans 32 columns, one thread each)
    experts = torch.arange(E, device=xt.device)[:, None]
    onehot_t = (flat_e[..., None, :] == experts).to(torch.int64)
    pos = torch.cumsum(onehot_t, dim=-1) - 1                    # [*lead, E, n*K]
    slot = torch.gather(pos, -2, flat_e[..., None, :])[..., 0, :]
    kept = slot < C
    dest = torch.where(kept, flat_e * C + slot, E * C)          # overflow → dropped row
    D = xt.shape[-1]
    rows = xt[..., :, None, :].expand(*xt.shape[:-1], K, D).reshape(*xt.shape[:-2], n * K, D)
    # + 0: the reference scatter-adds into zeros (0 + -0.0 is +0.0)
    buf = _RowGather.apply(rows * kept[..., None].to(xt.dtype), _holder(dest, E * C), dest) + 0
    return buf.reshape(*xt.shape[:-2], E, C, D), dest, kept


def _expert_ffn(p, h_in, dtype):
    """h_in: [*lead, E, T, D] → [*lead, E, T, D] through each expert's
    SwiGLU (the weights carry ``lead`` too)."""
    g = einsum32("...etd,...edf->...etf", h_in, p["wi"], dtype=dtype)
    u = einsum32("...etd,...edf->...etf", h_in, p["wu"], dtype=dtype)
    h = (F.silu(g) * u).to(dtype)
    return einsum_lp("...etf,...efd->...etd", h, p["wo"], dtype)


def _combine(buf_out, dest, kept, gate_vals, n: int, K: int, D: int, dtype):
    lead = buf_out.shape[:-3]
    flat = buf_out.reshape(*lead, -1, D)
    per_assignment = _RowGather.apply(flat, dest, _holder(dest, flat.shape[-2]))  # [*lead, n*K, D]
    w = (gate_vals.flatten(-2) * kept).to(dtype)
    return (per_assignment * w[..., None]).reshape(*lead, n, K, D).sum(dim=-2)


def ep_blocks(cfg, dtype, mesh, ep_axis: str) -> tuple:
    """``(ep_block, ep_block_small)``: the expert-parallel bodies over
    ``ep_axis`` of ``mesh`` on stacked ranks (see the module's docstring),
    each ``(router, wi, wu, wo, x) → (y, lb, z)``, the experts' weights the
    ranks' resident ones and ``x`` ``[*mesh dims, b, s, D]``."""
    E, K = cfg.moe.num_experts, cfg.moe.top_k
    cf = cfg.moe.capacity_factor
    n_ep = mesh.shape[ep_axis]
    L = len(mesh.axis_names)

    # one rank at a time (per_rank): the products and float sums
    def route(xt, router):
        return _route({"router": router}, xt, cfg, dtype)

    def ffn(h_in, wi, wu, wo):
        return _expert_ffn({"wi": wi, "wu": wu, "wo": wo}, h_in, dtype)

    def combine(out, dest, kept, gate_vals):
        n, d = gate_vals.shape[-2], out.shape[-1]
        return _combine(out, dest, kept, gate_vals, n, K, d, dtype)

    def ep_block_small(router, wi, wu, wo, xl):
        """Decode: routing replicated over the axis; each rank runs only
        its resident experts and the combined outputs are summed."""
        b, s, d = xl.shape[L:]
        xt = xl.reshape(*xl.shape[:L], b * s, d)
        gate_vals, gate_idx, aux = per_rank(route, xt, router, mesh=mesh)
        C = max(1, -(-(b * s * K) // E))  # ceil; no drops at decode
        buf, dest, kept = _dispatch_scatter(xt.to(dtype), gate_idx, E, C)
        out_loc = per_rank(ffn, own_chunk(buf, ep_axis, mesh, 0), wi, wu, wo, mesh=mesh)
        out = place_chunk(out_loc, ep_axis, mesh, 0)
        yt = psum(per_rank(combine, out, dest, kept, gate_vals, mesh=mesh), ep_axis, mesh)
        return yt.reshape(xl.shape), aux["moe_lb_loss"], aux["moe_z_loss"]

    def ep_block(router, wi, wu, wo, xl):
        """Each rank takes its slice of its data shard's tokens (the
        activations are replicated over the axis)."""
        b, s, d = xl.shape[L:]
        n_total = b * s
        n_loc = n_total // n_ep
        xt = own_chunk(xl.reshape(*xl.shape[:L], n_total, d), ep_axis, mesh, 0)
        gate_vals, gate_idx, aux = per_rank(route, xt, router, mesh=mesh)
        C = max(1, int(n_loc * K * cf) // E)
        buf, dest, kept = _dispatch_scatter(xt.to(dtype), gate_idx, E, C)
        # expert dim split across ranks, contributions concatenated:
        # [E/n_ep, n_ep*C, D], and back
        buf = all_to_all(buf, ep_axis, mesh, split_axis=0, concat_axis=1, tiled=True)
        out = per_rank(ffn, buf, wi, wu, wo, mesh=mesh)
        out = all_to_all(out, ep_axis, mesh, split_axis=1, concat_axis=0, tiled=True)
        yt = per_rank(combine, out, dest, kept, gate_vals, mesh=mesh)
        # reassemble the full token set over the axis
        full = psum(place_chunk(yt, ep_axis, mesh, 0), ep_axis, mesh)
        lb = pmean(aux["moe_lb_loss"], ep_axis, mesh)
        z = pmean(aux["moe_z_loss"], ep_axis, mesh)
        return full.reshape(xl.shape), lb, z

    return ep_block, ep_block_small


def _ep_apply(p, x, cfg, dtype, mesh, ep_axis: str):
    """Expert parallelism over ``ep_axis`` of ``mesh`` (see the module's
    docstring): ``([B,S,D], aux)``.  The blocks compute every rank at once,
    the ranks' tensors stacked in front (``shard_map(stacked_ranks=True)``)."""
    B, S, D = x.shape
    rules = active_rules()
    batch_spec = rules.physical("batch") if rules else ("data",)
    n_ep = mesh.shape[ep_axis]
    # batch too small for the batch axes (decode / long-context)?
    # replicate it instead of sharding
    x_spec = _valid_spec(mesh, P(batch_spec, None, None), tuple(x.shape))
    b_axes = x_spec[0]
    n_b = 1
    for a in (b_axes if isinstance(b_axes, tuple) else (b_axes,)) or ():
        n_b *= mesh.shape.get(a, 1) if a else 1
    tokens_per_shard = (B // max(n_b, 1)) * S
    small = tokens_per_shard % n_ep != 0

    # expert weights enter split over their expert dim (EP-resident); the
    # router is replicated
    w_spec = P(ep_axis, None, None)
    in_specs = (P(None, None), w_spec, w_spec, w_spec, x_spec)
    y, lb, z = shard_map(ep_blocks(cfg, dtype, mesh, ep_axis)[small], mesh=mesh,
                         in_specs=in_specs, out_specs=(x_spec, P(), P()), stacked_ranks=True)(
        p["router"], p["wi"], p["wu"], p["wo"], x)
    return y.to(dtype), {"moe_lb_loss": lb, "moe_z_loss": z}


def moe_apply(p, x, cfg, dtype, ep_axis: str = "model"):
    """x: [B,S,D] → ([B,S,D], aux).  Uses EP over ``ep_axis`` when a mesh
    with that axis is active and E % axis_size == 0."""
    mesh = active_mesh()
    E = cfg.moe.num_experts
    if (mesh is not None and ep_axis in mesh.shape and E % mesh.shape[ep_axis] == 0
            and mesh.shape[ep_axis] > 1):
        return _ep_apply(p, x, cfg, dtype, mesh, ep_axis)
    return single_rank(p, x, cfg, dtype)


def single_rank(p, x, cfg, dtype):
    """The single-rank path (no mesh, or expert parallelism not possible):
    x [B,S,D] → ([B,S,D], aux), every token routed into one buffer whose
    capacity is that of all ``B·S`` tokens, the aux losses theirs.  The
    tensor-parallel body runs it on each rank over the gathered global
    tokens (``models.tp.moe``)."""
    B, S, D = x.shape
    E, K = cfg.moe.num_experts, cfg.moe.top_k
    cf = cfg.moe.capacity_factor
    xt = x.reshape(B * S, D)
    gate_vals, gate_idx, aux = _route(p, xt, cfg, dtype)
    C = max(1, int(B * S * K * cf) // E)
    C = min(C, B * S)
    buf, dest, kept = _dispatch_scatter(xt.to(dtype), gate_idx, E, C)
    out = _expert_ffn(p, buf, dtype)
    yt = _combine(out, dest, kept, gate_vals, B * S, K, D, dtype)
    return yt.reshape(B, S, D).to(dtype), aux
