"""Top-k token-choice MoE with capacity-based scatter dispatch.

Port of the single-rank path of ``repro.models.moe`` (no mesh): route each
token to its top-k experts, scatter the assignments into an ``[E, C, D]``
buffer (capacity C per expert; overflow, in the order of the flattened
assignments, drops to the residual), run every expert's SwiGLU over its
buffer, then gather and gate-combine.  The reference's expert parallelism
(all-to-all under ``shard_map``) is not in the port.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, einsum32, einsum_lp, normal


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


def _route(p, xt, cfg, dtype):
    """xt: [n, D] → (gate_vals [n,K], gate_idx [n,K], aux)."""
    mcfg = cfg.moe
    logits = einsum32("nd,de->ne", xt, p["router"], dtype=dtype)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = top_k(probs, mcfg.top_k)
    gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)
    # each expert's count of assignments: the reference's scatter-add of
    # ones, exact in float32 (counts < 2**24), without atomics
    experts = torch.arange(mcfg.num_experts, device=xt.device)[:, None]
    density = (gate_idx.reshape(1, -1) == experts).sum(1).to(torch.float32)
    density = density / gate_idx.numel()
    lb_loss = mcfg.num_experts * torch.sum(density * probs.mean(0))
    z_loss = mcfg.router_z_loss * torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
    return gate_vals, gate_idx, {"moe_lb_loss": lb_loss, "moe_z_loss": z_loss}


class _RowGather(torch.autograd.Function):
    """``out[r] = src[idx[r]]``, a zero row where ``idx[r]`` is
    ``len(src)``, for an ``idx`` that is one-to-one onto the rows it
    takes, with ``inv`` its inverse (``inv[idx[r]] = r``; ``len(out)``
    for a row no one takes).  The backward is then the inverse gather,
    ``grad_src[i] = grad_out[inv[i]]``: each row's gradient is one row,
    where autograd's index backward would scatter-add with atomics (or
    sort, under deterministic algorithms)."""

    @staticmethod
    def forward(ctx, src, idx, inv):
        ctx.save_for_backward(inv)
        return torch.cat([src, src.new_zeros((1, src.shape[1]))]).index_select(0, idx)

    @staticmethod
    def backward(ctx, grad):
        (inv,) = ctx.saved_tensors
        return torch.cat([grad, grad.new_zeros((1, grad.shape[1]))]).index_select(0, inv), None, None


def _holder(dest, rows: int):
    """The assignment that fills each of ``rows`` buffer rows, where
    assignment ``i`` fills row ``dest[i]`` (the kept ones are distinct;
    ``rows`` is the dropped row): ``len(dest)`` for a row no one fills.
    A sort and a search, so no scatter with colliding indices."""
    n = dest.shape[0]
    sorted_dest, order = torch.sort(dest, stable=True)
    r = torch.arange(rows, device=dest.device)
    at = torch.searchsorted(sorted_dest, r).clamp_(max=n - 1)
    return torch.where(sorted_dest[at] == r, order[at], n)


def _dispatch_scatter(xt, gate_idx, E: int, C: int):
    """Scatter tokens into [E, C, D]; returns (buffer, dest [n*K], kept)."""
    n, K = gate_idx.shape
    flat_e = gate_idx.reshape(-1)                               # [n*K]
    # rank of each assignment within its expert bucket, in flattened order
    # (a scan along the last dim of the one-hot's transpose: along its first
    # dim the card scans 32 columns, one thread each)
    onehot_t = (flat_e[None, :] == torch.arange(E, device=xt.device)[:, None]).to(torch.int64)
    pos = torch.cumsum(onehot_t, dim=1) - 1                     # [E, n*K]
    slot = torch.gather(pos, 0, flat_e[None, :])[0]
    kept = slot < C
    dest = torch.where(kept, flat_e * C + slot, E * C)          # overflow → dropped row
    rows = xt[:, None, :].expand(n, K, xt.shape[1]).reshape(n * K, xt.shape[1])
    # + 0: the reference scatter-adds into zeros (0 + -0.0 is +0.0)
    buf = _RowGather.apply(rows * kept[:, None].to(xt.dtype), _holder(dest, E * C), dest) + 0
    return buf.reshape(E, C, xt.shape[1]), dest, kept


def _expert_ffn(p, h_in, dtype):
    """h_in: [E, T, D] → [E, T, D] through each expert's SwiGLU."""
    g = einsum32("etd,edf->etf", h_in, p["wi"], dtype=dtype)
    u = einsum32("etd,edf->etf", h_in, p["wu"], dtype=dtype)
    h = (F.silu(g) * u).to(dtype)
    return einsum_lp("etf,efd->etd", h, p["wo"], dtype)


def _combine(buf_out, dest, kept, gate_vals, n: int, K: int, D: int, dtype):
    flat = buf_out.reshape(-1, D)
    per_assignment = _RowGather.apply(flat, dest, _holder(dest, flat.shape[0]))  # [n*K, D]
    w = (gate_vals.reshape(-1) * kept).to(dtype)
    return (per_assignment * w[:, None]).reshape(n, K, D).sum(dim=1)


def moe_apply(p, x, cfg, dtype):
    """x: [B,S,D] → ([B,S,D], aux)."""
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
