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
    density = torch.zeros(mcfg.num_experts, dtype=torch.float32, device=xt.device)
    density.index_add_(0, gate_idx.reshape(-1), torch.ones(gate_idx.numel(), device=xt.device))
    density = density / gate_idx.numel()
    lb_loss = mcfg.num_experts * torch.sum(density * probs.mean(0))
    z_loss = mcfg.router_z_loss * torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
    return gate_vals, gate_idx, {"moe_lb_loss": lb_loss, "moe_z_loss": z_loss}


def _dispatch_scatter(xt, gate_idx, E: int, C: int):
    """Scatter tokens into [E, C, D]; returns (buffer, dest [n*K], kept)."""
    n, K = gate_idx.shape
    flat_e = gate_idx.reshape(-1)                               # [n*K]
    # rank of each assignment within its expert bucket, in flattened order
    onehot_pos = F.one_hot(flat_e, E)
    pos = torch.cumsum(onehot_pos, dim=0) - 1                   # [n*K, E]
    slot = torch.gather(pos, 1, flat_e[:, None])[:, 0]
    kept = slot < C
    dest = torch.where(kept, flat_e * C + slot, E * C)          # overflow → dropped row
    buf = torch.zeros((E * C + 1, xt.shape[1]), dtype=xt.dtype, device=xt.device)
    buf.index_add_(0, dest, xt.repeat_interleave(K, dim=0) * kept[:, None].to(xt.dtype))
    return buf[: E * C].reshape(E, C, xt.shape[1]), dest, kept


def _expert_ffn(p, h_in, dtype):
    """h_in: [E, T, D] → [E, T, D] through each expert's SwiGLU."""
    g = einsum32("etd,edf->etf", h_in, p["wi"], dtype=dtype)
    u = einsum32("etd,edf->etf", h_in, p["wu"], dtype=dtype)
    h = (F.silu(g) * u).to(dtype)
    return einsum_lp("etf,efd->etd", h, p["wo"], dtype)


def _combine(buf_out, dest, kept, gate_vals, n: int, K: int, D: int, dtype):
    flat = buf_out.reshape(-1, D)
    flat = torch.cat([flat, flat.new_zeros((1, D))], dim=0)
    per_assignment = flat[dest]                                 # [n*K, D]
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
