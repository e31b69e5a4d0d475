"""GQA attention: chunked training/prefill attention and cached decode.

Port of ``repro.models.attention``.  Covers the per-arch
variants: RoPE, QKV bias (qwen2), attention-logit softcap (gemma2),
sliding-window local attention (gemma2 local layers — a stencil on the
sequence axis), and cross-attention (seamless decoder).

The training/prefill path loops over query chunks so the S×S score matrix
never materializes; scores stay in float32.  Every product is spelled out
(no fused library attention), so the port computes what the reference's
``chunked_attention`` and decode paths compute, step by step.

Decode keeps one ``[B, T, Kh, hd]`` ring per layer, written in place at
each slot's position.  Under an active mesh (``repro_torch.dist.use_mesh``)
the layout comes from ``kv_cache_layout``, as in the reference:

- ``"seq"`` / ``"seq_all"``: the cache is sequence-sharded and decode is
  the distributed flash-decode (:func:`_flash_decode_sharded`): each rank
  reduces its slice with a softmax of its own, and the ranks combine by
  LSE weights (``pmax`` of the maxima, ``psum`` of the weighted sums).
  The ranks' slices are views of the one cache tensor, stacked (every
  rank on the cache's device): the cache is never copied or re-laid out
  between steps, and the new token's K/V is written into it in place;
- ``"heads"``, ``"batch"`` and ``"flat"`` compute as without a mesh; the
  reference's layout constraint on the cache (:func:`_constrain_cache`)
  is recorded, not applied, as ``shard`` does.

Without a mesh, caches longer than ``DECODE_KV_CHUNK`` reduce over KV
chunks with an online softmax.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.dist.sharding import (
    PartitionSpec as P,
    _valid_spec,
    active_mesh,
    active_rules,
    default_rules,
    kv_cache_layout,
    pmax,
    psum,
    record_spec,
    shard,
    shard_map,
)
from repro_torch.models.layers import apply_rope, dense_init, einsum32, einsum_lp, softcap, zeros

NEG_INF = -1e30

DECODE_KV_CHUNK = 4096


def attn_init(gen, device, cfg, lead: tuple = ()) -> dict:
    d, h, kh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    p = {
        "wq": dense_init(gen, device, d, (h, hd), lead=lead),
        "wk": dense_init(gen, device, d, (kh, hd), lead=lead),
        "wv": dense_init(gen, device, d, (kh, hd), lead=lead),
        "wo": dense_init(gen, device, h * hd, d, lead=lead).reshape(*lead, h, hd, d),
    }
    if cfg.qkv_bias:
        p["bq"] = zeros(device, (h, hd), lead)
        p["bk"] = zeros(device, (kh, hd), lead)
        p["bv"] = zeros(device, (kh, hd), lead)
    return p


def _project(eq: str, x, w, bias, dtype):
    """The projection, kept in float32 until the bias is added (the
    reference adds it to the float32 product), then cast to ``dtype``."""
    if bias is None:
        return einsum_lp(eq, x, w, dtype)
    return (einsum32(eq, x, w, dtype=dtype) + bias).to(dtype)


def _project_qkv(p, x, xkv, cfg, dtype, q_positions, kv_positions):
    """x: [B,S,D] queries source; xkv: [B,T,D] key/value source."""
    bias = cfg.qkv_bias
    wq = shard(p["wq"], "embed", "q_heads_p", None)
    wk = shard(p["wk"], "embed", "kv_heads_p", None)
    wv = shard(p["wv"], "embed", "kv_heads_p", None)
    q = _project("bsd,dhk->bshk", x, wq, p["bq"] if bias else None, dtype)
    k = _project("btd,dhk->bthk", xkv, wk, p["bk"] if bias else None, dtype)
    v = _project("btd,dhk->bthk", xkv, wv, p["bv"] if bias else None, dtype)
    if q_positions is not None:  # rope (self-attention only)
        q = apply_rope(q, q_positions, cfg.rope_theta)
        k = apply_rope(k, kv_positions, cfg.rope_theta)
    q = shard(q, "batch", "seq", "heads", None)
    k = shard(k, "batch", "seq", "kv_heads", None)
    v = shard(v, "batch", "seq", "kv_heads", None)
    return q, k, v


def _out_proj(p, o, cfg, dtype):
    wo = shard(p["wo"], "q_heads_p", None, "embed")
    return shard(einsum_lp("bshk,hkd->bsd", o, wo, dtype), "batch", "seq", "embed_act")


def chunked_attention(
    q, k, v, *,
    causal: bool,
    window: int = 0,
    attn_softcap: float = 0.0,
    q_chunk: int = 1024,
    q_offset: int = 0,
    kv_len: Optional[int] = None,
    dtype=torch.bfloat16,
):
    """q: [B,S,H,D], k/v: [B,T,Kh,D] → [B,S,H,D].

    Loops over query chunks; scores per step are [B, C, Kh, G, T] so peak
    memory is C/S of the naive product.  ``window > 0`` restricts to a
    causal sliding window (local attention).  ``kv_len`` masks a partially
    filled cache.
    """
    B, S, H, D = q.shape
    T, Kh = k.shape[1], k.shape[2]
    G = H // Kh
    scale = 1.0 / math.sqrt(D)
    q_chunk = min(q_chunk, S)
    if S % q_chunk != 0:
        q_chunk = S
    n_chunks = S // q_chunk

    qg = q.reshape(B, S, Kh, G, D)
    kv_pos = torch.arange(T, device=q.device)

    def one_chunk(ci, qc):
        # qc: [B,C,Kh,G,D]
        s = einsum32("bckgd,btkd->bckgt", qc, k, dtype=dtype) * scale
        s = softcap(s, attn_softcap)
        qpos = q_offset + ci * q_chunk + torch.arange(q_chunk, device=q.device)
        mask = torch.ones((q_chunk, T), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kv_pos[None, :] <= qpos[:, None]
        if window > 0:
            mask &= kv_pos[None, :] > qpos[:, None] - window
        if kv_len is not None:
            mask &= kv_pos[None, :] < kv_len
        s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        return einsum_lp("bckgt,btkd->bckgd", p, v, dtype)

    outs = [one_chunk(ci, qg[:, ci * q_chunk:(ci + 1) * q_chunk]) for ci in range(n_chunks)]
    out = outs[0] if n_chunks == 1 else torch.cat(outs, dim=1)
    return out.reshape(B, S, H, D)


def self_attention(p, x, cfg, *, kind: str, dtype, positions=None, q_chunk: int = 1024):
    """Training/prefill self-attention; returns [B,S,D] plus (k, v) for
    cache writes."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device).expand(B, S)
    q, k, v = _project_qkv(p, x, x, cfg, dtype, positions, positions)
    window = cfg.local_window if kind == "attn_local" else 0
    o = chunked_attention(
        q, k, v,
        causal=True,
        window=window,
        attn_softcap=cfg.attn_softcap,
        q_chunk=q_chunk,
        dtype=dtype,
    )
    return _out_proj(p, o, cfg, dtype), (k, v)


def cross_attention(p, x, memory, cfg, *, dtype):
    """Decoder cross-attention over encoder output (no rope, no mask)."""
    q, k, v = _project_qkv(p, x, memory, cfg, dtype, None, None)
    o = chunked_attention(q, k, v, causal=False, dtype=dtype)
    return _out_proj(p, o, cfg, dtype)


def project_cross_kv(p, memory, cfg, dtype):
    """Cross-attention K/V of the encoder memory (cached at prefill)."""
    bias = cfg.qkv_bias
    k = _project("btd,dhk->bthk", memory, p["wk"], p["bk"] if bias else None, dtype)
    v = _project("btd,dhk->bthk", memory, p["wv"], p["bv"] if bias else None, dtype)
    return k, v


def cross_decode_attention(p, x, ck, cv, cfg, *, dtype):
    """One-token cross-attention against cached encoder K/V."""
    B = x.shape[0]
    wq = shard(p["wq"], "embed", "q_heads_p", None)
    q = _project("bsd,dhk->bshk", x, wq, p["bq"] if cfg.qkv_bias else None, dtype)
    Kh, H, hd = ck.shape[2], q.shape[2], q.shape[-1]
    qg = q.reshape(B, 1, Kh, H // Kh, hd)
    s = einsum32("bckgd,btkd->bckgt", qg, ck, dtype=dtype) / math.sqrt(hd)
    pattn = torch.softmax(s, dim=-1)
    o = einsum_lp("bckgt,btkd->bckgd", pattn, cv, dtype)
    return _out_proj(p, o.reshape(B, 1, H, hd), cfg, dtype)


def decode_self_attention(p, x, cache_k, cache_v, pos, cfg, *, kind: str, dtype):
    """One-token decode.  x: [B,1,D]; cache_k/v: [B,T,Kh,D]; pos: a
    position for every row (int or 0-d tensor) or one per row ([B]: the
    serving engine's slots decode at different depths).  Returns
    (out [B,1,D], cache_k, cache_v).

    The new K/V are written into ``cache_k``/``cache_v`` in place (every
    caller rebinds the returned caches).  Local layers use a *rolling*
    cache of size window (position mod T) — the sequence-stencil footprint
    bounds the state.
    """
    B = x.shape[0]
    T = cache_k.shape[1]
    mesh = active_mesh()
    layout = (
        kv_cache_layout(B, T, cache_k.shape[2], mesh)
        if mesh is not None and mesh.shape.get("model", 1) > 1 else "flat"
    )
    dev = x.device
    pos = torch.as_tensor(pos, device=dev)
    per_seq = pos.ndim == 1
    positions = pos[:, None] if per_seq else pos.expand(B, 1)
    q, k, v = _project_qkv(p, x, x, cfg, dtype, positions, positions)
    slot = positions[:, 0] % T if T > 0 else torch.zeros_like(positions[:, 0])
    if per_seq:
        rows = torch.arange(B, device=dev)
        cache_k[rows, slot] = k[:, 0].to(cache_k.dtype)
        cache_v[rows, slot] = v[:, 0].to(cache_v.dtype)
    else:
        # index_copy_ with a device index: no read of the slot on the
        # host (which a meta tensor, in the dry run, cannot give)
        cache_k.index_copy_(1, slot[:1].long(), k.to(cache_k.dtype))
        cache_v.index_copy_(1, slot[:1].long(), v.to(cache_v.dtype))
    _constrain_cache(cache_k, layout, mesh)
    _constrain_cache(cache_v, layout, mesh)

    window = cfg.local_window if kind == "attn_local" else 0
    # valid entries: rolling cache holds [max(0,pos-T+1), pos]
    kv_pos = torch.arange(T, device=dev)[None, :]                 # [1,T]
    posb = positions                                              # [B,1]
    slotb = slot[:, None]                                         # [B,1]
    # the absolute position of each entry of the rolling cache
    abs_pos = torch.where(
        kv_pos <= slotb, posb - (slotb - kv_pos), posb - (slotb + T - kv_pos)
    )                                                             # [B,T]
    valid = (abs_pos >= 0) & (abs_pos <= posb)
    if window > 0:
        valid &= abs_pos > posb - window

    Kh = cache_k.shape[2]
    H = q.shape[2]
    hd = q.shape[-1]
    qg = q.reshape(B, Kh, H // Kh, hd)

    if layout in ("seq", "seq_all"):
        # distributed flash-decode over the sequence-sharded cache: each
        # rank reduces its slice, the ranks combine by LSE weights
        o = _flash_decode_sharded(qg, cache_k, cache_v, valid, cfg, dtype, mesh, layout)
    elif T > DECODE_KV_CHUNK and T % DECODE_KV_CHUNK == 0:
        # online softmax over KV chunks: the float32 score tensor is
        # [B,Kh,G,chunk] instead of [...,T]
        o = _online_softmax_decode(qg, cache_k, cache_v, valid, cfg, dtype)
    else:
        s = einsum32("bkgd,btkd->bkgt", qg, cache_k, dtype=dtype)
        s = s / math.sqrt(hd)
        s = softcap(s, cfg.attn_softcap)
        s = torch.where(valid[:, None, None, :], s, NEG_INF)
        pattn = torch.softmax(s, dim=-1)
        o = einsum_lp("bkgt,btkd->bkgd", pattn, cache_v, dtype)
    o = o.reshape(B, 1, H, hd).to(dtype)
    return _out_proj(p, o, cfg, dtype), cache_k, cache_v


def _cache_spec(layout: str, mesh, shape: tuple) -> P:
    """The spec of a [B,T,Kh,hd] cache in ``layout`` (clamped)."""
    rules = active_rules() or default_rules("pod" in mesh.axis_names)
    batch_ax = rules.physical("batch")
    if layout == "heads":
        spec = P(batch_ax, None, "model", None)
    elif layout == "seq":
        spec = P(batch_ax, "model", None, None)
    elif layout == "seq_all":
        axes = batch_ax if isinstance(batch_ax, tuple) else (batch_ax,)
        spec = P(None, tuple(a for a in axes if a) + ("model",), None, None)
    else:  # "batch"
        spec = P(batch_ax, None, None, None)
    return _valid_spec(mesh, spec, tuple(shape))


def _constrain_cache(c, layout: str, mesh):
    """The reference pins a [B,T,Kh,hd] cache to the layout from
    ``kv_cache_layout`` (``with_sharding_constraint``); the port records
    that spec, as ``shard`` does, and returns ``c`` unchanged: the cache
    is one tensor, whose ranks' slices the flash-decode takes as views."""
    if mesh is None or layout == "flat":
        return c
    record_spec(tuple(c.shape), _cache_spec(layout, mesh, tuple(c.shape)))
    return c


def _flash_decode_sharded(qg, cache_k, cache_v, valid, cfg, dtype, mesh, layout):
    """qg: [B,Kh,G,hd] (seq-replicated); cache_k/v: [B,T,Kh,hd] with T
    sharded — over "model" (layout "seq") or over every axis (layout
    "seq_all"); valid: [B,T].  Returns o [B,Kh,G,hd].

    Per rank an online-softmax block over its slice (``m``, ``l``,
    ``acc``), then the LSE combine over the sequence axes: ``pmax`` of m,
    ``psum`` of ``l·r`` and ``acc·r`` with ``r = exp(m - max)``.  The specs
    mirror ``launch.steps.kv_cache_spec``; the ranks' inputs are views of
    the global tensors, stacked (``shard_map(stacked_ranks=True)``)."""
    rules = active_rules() or default_rules("pod" in mesh.axis_names)
    batch_ax = rules.physical("batch")
    B, T = valid.shape
    hd = qg.shape[-1]
    scale = 1.0 / math.sqrt(hd)

    if layout == "seq":
        kv_spec = _valid_spec(mesh, P(batch_ax, "model", None, None), tuple(cache_k.shape))
        q_spec = _valid_spec(mesh, P(batch_ax, None, None, None), tuple(qg.shape))
    else:  # "seq_all": batch too small to shard — everything on T
        axes = batch_ax if isinstance(batch_ax, tuple) else (batch_ax,)
        seq_axes = tuple(a for a in axes if a) + ("model",)
        kv_spec = _valid_spec(mesh, P(None, seq_axes, None, None), tuple(cache_k.shape))
        q_spec = P(None, None, None, None)
    v_spec = _valid_spec(mesh, P(q_spec[0], kv_spec[1]), (B, T))
    ax = kv_spec[1]

    def block(qg_l, k_l, v_l, ok_l):
        # every rank at once: [*mesh dims, *local]
        s = einsum32("...kgd,...tkd->...kgt", qg_l, k_l, dtype=dtype) * scale
        s = softcap(s, cfg.attn_softcap)
        s = torch.where(ok_l[..., :, None, None, :], s, NEG_INF)
        m = s.amax(-1)
        p = torch.exp(s - m[..., None])
        l = p.sum(-1)
        acc = einsum32("...kgt,...tkd->...kgd", p, v_l, dtype=dtype)
        # LSE combine across the sequence shards
        if ax is not None:
            g = pmax(m, ax, mesh)
            r = torch.exp(m - g)
            l = psum(l * r, ax, mesh)
            acc = psum(acc * r[..., None], ax, mesh)
        return (acc / torch.maximum(l, l.new_full((), 1e-30))[..., None],)

    (o,) = shard_map(block, mesh=mesh, in_specs=(q_spec, kv_spec, kv_spec, v_spec),
                     out_specs=(q_spec,), stacked_ranks=True)(qg, cache_k, cache_v, valid)
    return o


def _online_softmax_decode(qg, cache_k, cache_v, valid, cfg, dtype):
    """qg: [B,Kh,G,hd]; cache_k/v: [B,T,Kh,hd]; valid: [B,T] →
    o [B,Kh,G,hd].  Running (max, denom, acc) over KV chunks."""
    B, Kh, G, hd = qg.shape
    T = cache_k.shape[1]
    C = DECODE_KV_CHUNK
    scale = 1.0 / math.sqrt(hd)
    dev = qg.device

    m = torch.full((B, Kh, G), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Kh, G), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Kh, G, hd), dtype=torch.float32, device=dev)
    for c in range(T // C):
        k = cache_k[:, c * C:(c + 1) * C]
        v = cache_v[:, c * C:(c + 1) * C]
        ok = valid[:, c * C:(c + 1) * C]
        s = einsum32("bkgd,btkd->bkgt", qg, k, dtype=dtype) * scale
        s = softcap(s, cfg.attn_softcap)
        s = torch.where(ok[:, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        pc = torch.exp(s - m_new[..., None])
        r = torch.exp(m - m_new)
        l = l * r + pc.sum(-1)
        acc = acc * r[..., None] + einsum32("bkgt,btkd->bkgd", pc, v, dtype=dtype)
        m = m_new
    return acc / torch.clamp(l, min=1e-30)[..., None]
