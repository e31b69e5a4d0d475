"""Tensor- and data-parallel blocks of the language models.

Inside the body of a tensor-parallel step (``dist.sharding.
tensor_parallel``) every tensor is stacked ranks, ``[*mesh dims,
*local]``: each weight is its rank's block of ``param_pspecs`` (clamped
by ``_valid_spec`` as the reference clamps it), the batch its data shard.
Each block computes its rank's part with the flat code on the local
blocks, one call a rank (``per_rank``), and runs the collectives that
GSPMD inserts for the reference's specs (the Megatron layout of
``default_rules``):

- the embedding is vocab-parallel: a rank looks up the ids of its rows,
  zeros the others, and the ranks psum;
- the logits stay vocab-sharded (``"vocab_act"``): the loss takes the
  max by a pmax, the exponentials' sum and the target's logit by psums;
- attention: ``wq``/``wk``/``wv`` and the biases are the rank's heads,
  ``wo`` row-parallel with the psum where the reference constrains the
  output to ``"embed_act"``.  Where ``_valid_spec`` keeps ``wq`` sharded
  and drops the KV spec (GQA with fewer KV heads than ranks), ``wk``/``wv``
  are whole and each rank's query heads read their own group's KV head,
  as GSPMD's slicing does;
- SwiGLU: ``wi``/``wu`` column-parallel, ``wo`` row-parallel, a psum;
- MoE, by the reference's rule (``moe.moe_apply``): where the experts
  split over a mesh axis of more than one rank (``"model"``: E % model
  == 0, model > 1), the expert-parallel blocks of ``moe`` (all-to-alls
  over that axis, the router replicated); otherwise the reference's
  single-rank route, which GSPMD runs over the global token set: each
  rank all-gathers the batch's rows, routes and dispatches every token
  with the capacity of all ``B·S`` of them, runs the experts on its
  weights (its columns of ``d_ff`` where ``"mlp"`` splits them, the
  partial outputs psummed), keeps its own rows, and returns the aux
  losses of the global tokens;
- mamba: ``in_proj`` is ``[x; z]`` along the dim ``"mlp"`` shards, so a
  rank's column block is not a block of ``x`` and of ``z``: the product's
  blocks are all-gathered and each rank takes its channels of both;
  the conv, the scan and ``out_proj`` (row-parallel, a psum) run on those
  channels.  The decode state ``h`` is whole in the cache (its spec names
  the batch alone): it is all-gathered after the scan;
- mLSTM: q, k and the gates replicated, ``up_z``/``wv``/``down_proj``
  sharded on hd_v; the per-head norm over hd_v sums its squares by a psum;
  the cache's C (whole) is all-gathered;
- sLSTM: the gates and the recurrence on the rank's heads, their outputs
  all-gathered for the gated MLP (column/row-parallel where its width
  divides, else replicated); the whole states all-gathered for the cache.

Reductions across ranks are chains in rank order (``psum``), and every
product and float reduction runs one call a rank, so a process mesh (one
process a rank) computes bitwise what the stacked ranks compute.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ATTN, ATTN_LOCAL, MAMBA, MLSTM, SLSTM
from repro_torch.dist.sharding import (
    PartitionSpec as P,
    _valid_spec,
    active_context,
    active_rules,
    all_gather,
    axes_index,
    axes_size,
    clamp_axes,
    enter,
    own,
    per_rank,
    place,
    pmax,
    psum,
    relayout,
    to_placed,
    use_context,
)
from repro_torch.models import attention as attn
from repro_torch.models import lm as lm_mod
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.layers import (
    einsum32,
    einsum_lp,
    operand,
    padded_vocab,
    rms_norm,
    softcap,
    swiglu_apply,
    torch_dtype,
)


def _lead(mesh) -> int:
    return len(mesh.axis_names)


def _local(mesh, f, *xs):
    return per_rank(f, *xs, mesh=mesh, coords=True)


def norm(x, gamma, eps, mesh):
    return per_rank(lambda x, g: rms_norm(x, g, eps), x, gamma, mesh=mesh)


def batch_axes(B: int) -> tuple:
    """The axes the batch of ``B`` rows is split over (``"batch"`` clamped)."""
    return clamp_axes("batch", B)


def global_rows(n_local: int, mesh) -> int:
    """The global rows of a batch that every batch axis splits, each rank
    holding ``n_local`` rows (a batch that some batch axis cannot split
    has fewer: its caller passes them)."""
    axes = tuple(a for a in _entry(P(active_rules().physical("batch")), 0) if a in mesh.shape)
    return n_local * axes_size(mesh, axes)


# -- embedding / logits / loss ------------------------------------------------


def embed_lookup(table, tokens, dtype, cfg, mesh):
    """Vocab-parallel lookup: each rank takes the ids of its rows (zero for
    the others) and the ranks psum, then the reference's scale."""
    axes = clamp_axes("vocab", padded_vocab(cfg.vocab_size))

    def local(c, t, ids):
        n = t.shape[0]
        rel = ids.long() - axes_index(mesh, axes, c) * n
        ok = (rel >= 0) & (rel < n)
        return t[torch.where(ok, rel, 0)].to(dtype) * ok[..., None].to(dtype)

    x = psum(_local(mesh, local, table, tokens), axes, mesh)
    return x * torch.tensor(math.sqrt(table.shape[-1]), dtype=dtype)


def logits(params, cfg, x, dtype, mesh):
    """Final norm and the vocab-sharded logits of the rank's rows of the
    (un)embedding, the padded columns masked by their global index."""
    x = norm(x, params["final_norm"], cfg.norm_eps, mesh)
    table = params.get("unembed", params["embed"])
    axes = clamp_axes("vocab", padded_vocab(cfg.vocab_size))

    def local(c, x, t):
        out = torch.matmul(operand(x, dtype), operand(t, dtype).transpose(0, 1))
        out = softcap(out, cfg.logit_softcap)
        first = cfg.vocab_size - axes_index(mesh, axes, c) * t.shape[0]
        if first < t.shape[0]:
            out[..., max(first, 0):] += -1e9
        return out

    return _local(mesh, local, x, table)


def cross_entropy(cfg, logits_s, tokens, B: int, mesh, z_loss: float):
    """``train_step.cross_entropy_loss`` on vocab-sharded logits: the
    logsumexp by a pmax and a psum of exponentials, the target's logit by a
    psum from its owner, the means over the global batch of ``B`` rows.
    Returns stacked scalars ``(ce, z)``, equal on every rank."""
    L = _lead(mesh)
    axes = clamp_axes("vocab", padded_vocab(cfg.vocab_size))
    S_tok = tokens.shape[L + 1]
    prefix = logits_s.shape[L + 1] - S_tok
    pred = logits_s.narrow(L + 1, prefix, S_tok - 1)
    tgt = tokens.narrow(L + 1, 1, S_tok - 1)
    m = pmax(per_rank(lambda p: p.amax(-1), pred, mesh=mesh), axes, mesh).detach()
    se = psum(per_rank(lambda p, m: torch.exp(p - m[..., None]).sum(-1), pred, m, mesh=mesh),
              axes, mesh)
    logz = m + torch.log(se)

    def gold(c, p, t):
        n = p.shape[-1]
        rel = t.long() - axes_index(mesh, axes, c) * n
        ok = (rel >= 0) & (rel < n)
        g = torch.gather(p, -1, torch.where(ok, rel, 0)[..., None])[..., 0]
        return torch.where(ok, g, torch.zeros((), dtype=g.dtype, device=g.device))

    logz_gold = logz - psum(_local(mesh, gold, pred, tgt), axes, mesh)
    count = B * (S_tok - 1)
    b_axes = batch_axes(B)
    ce = psum(per_rank(lambda a: a.sum(), logz_gold, mesh=mesh), b_axes, mesh) / count
    zl = psum(per_rank(lambda a: torch.square(a).sum(), logz, mesh=mesh), b_axes, mesh) / count
    return ce, z_loss * zl


# -- MLPs ---------------------------------------------------------------------


def swiglu(p, x, dtype, d_ff, mesh):
    """Column-parallel ``wi``/``wu``, row-parallel ``wo``, a psum."""
    y = per_rank(lambda x, wi, wu, wo: swiglu_apply({"wi": wi, "wu": wu, "wo": wo}, x, dtype),
                 x, p["wi"], p["wu"], p["wo"], mesh=mesh)
    return psum(y, clamp_axes("mlp", d_ff), mesh)


def moe(p, x, cfg, dtype, mesh, B: int):
    """MoE on the body's stacked ranks, of a batch of ``B`` global rows:
    the expert-parallel blocks of ``moe`` where the experts split over one
    mesh axis of more than one rank (``"expert"``'s axis: under the
    default rules the reference's rule, E % model == 0 and model > 1),
    else :func:`moe_single_rank`; the aux losses per rank."""
    axes = clamp_axes("expert", cfg.moe.num_experts)
    if len(axes) != 1 or mesh.shape[axes[0]] == 1:
        return moe_single_rank(p, x, cfg, dtype, mesh, B)
    L = _lead(mesh)
    B_loc, S = x.shape[L], x.shape[L + 1]
    small = (B_loc * S) % mesh.shape[axes[0]] != 0
    block = moe_mod.ep_blocks(cfg, dtype, mesh, axes[0])[small]
    y, lb, z = block(p["router"], p["wi"], p["wu"], p["wo"], x)
    return y.to(dtype), {"moe_lb_loss": lb, "moe_z_loss": z}


def moe_single_rank(p, x, cfg, dtype, mesh, B: int):
    """The reference's single-rank route (``moe.single_rank``) as GSPMD
    runs it, over the global token set: every rank all-gathers the rows of
    the batch's axes (global row order), runs the route on all ``B·S``
    tokens with its expert weights (whole experts; a block of ``d_ff``
    columns of ``wi``/``wu`` and rows of ``wo`` where the weights' spec
    gives ``"mlp"`` an axis, their partial outputs psummed over it after
    the combine) and keeps its own rows.  Each rank's rows depend on every
    token (the capacity, the slot order); the all-gather's backward sums
    the ranks' cotangents before each rank takes its block.  The aux
    losses are the global tokens', the same on every rank."""
    b_axes = tuple(a for a in batch_axes(B) if mesh.shape[a] > 1)
    E, D, d_ff = cfg.moe.num_experts, cfg.d_model, cfg.d_ff
    rules = active_rules()
    w_spec = _valid_spec(mesh, P(rules.physical("expert"), None, rules.physical("mlp")),
                         (E, D, d_ff))
    xg = all_gather(x, b_axes, mesh, 0) if b_axes else x

    def local(x, router, wi, wu, wo):
        y, aux = moe_mod.single_rank({"router": router, "wi": wi, "wu": wu, "wo": wo}, x, cfg,
                                     dtype)
        return y, aux["moe_lb_loss"], aux["moe_z_loss"]

    y, lb, z = per_rank(local, xg, p["router"], p["wi"], p["wu"], p["wo"], mesh=mesh)
    y = own(y, b_axes, mesh, 0) if b_axes else y
    return psum(y, _entry(w_spec, 2), mesh), {"moe_lb_loss": lb, "moe_z_loss": z}


# -- attention ----------------------------------------------------------------


def _heads(cfg):
    return clamp_axes("q_heads_p", cfg.n_heads), clamp_axes("kv_heads_p", cfg.n_kv_heads)


def _lp(p, ws):
    keys = ("wq", "wk", "wv", "wo", "bq", "bk", "bv")
    return dict(zip(keys, ws))


def _weights(p):
    return [p[k] for k in ("wq", "wk", "wv", "wo", "bq", "bk", "bv") if k in p]


def _kv_for_q(k, v, c, cfg, mesh, n_q: int):
    """The KV heads (dim 2) the rank's ``n_q`` local query heads read: the
    rank's own block where the KV heads are sharded too, else (KV whole,
    queries sharded: GQA with fewer KV heads than ranks) their groups'."""
    q_axes, kv_axes = _heads(cfg)
    if kv_axes or not q_axes:
        return k, v
    G = cfg.n_heads // cfg.n_kv_heads
    q0 = axes_index(mesh, q_axes, c) * n_q
    if n_q % G == 0:
        return k[:, :, q0 // G: q0 // G + n_q // G], v[:, :, q0 // G: q0 // G + n_q // G]
    if G % n_q == 0:
        return k[:, :, q0 // G: q0 // G + 1], v[:, :, q0 // G: q0 // G + 1]
    idx = torch.arange(q0, q0 + n_q, device=k.device) // G
    return k.index_select(2, idx), v.index_select(2, idx)


def attend(p, x, xkv, cfg, dtype, mesh, *, causal: bool, window: int = 0,
           attn_softcap: float = 0.0, q_chunk: int = 1024, rope: bool = False):
    """Attention of the rank's heads, its partial output psummed.  Returns
    ``(y, k, v)``: k and v in the layout the rank computed them (its KV
    heads, or all of them where the KV spec is dropped)."""
    q_axes, _ = _heads(cfg)
    ws = _weights(p)

    def local(c, x, xkv, *ws):
        lp = _lp(p, ws)
        pos = None
        if rope:
            pos = torch.arange(x.shape[1], device=x.device).expand(x.shape[0], x.shape[1])
        q, k, v = attn._project_qkv(lp, x, xkv, cfg, dtype, pos, pos)
        kq, vq = _kv_for_q(k, v, c, cfg, mesh, q.shape[2])
        o = attn.chunked_attention(q, kq, vq, causal=causal, window=window,
                                   attn_softcap=attn_softcap, q_chunk=q_chunk, dtype=dtype)
        return attn._out_proj(lp, o, cfg, dtype), k, v

    y, k, v = _local(mesh, local, x, xkv, *ws)
    return psum(y, q_axes, mesh), k, v


def self_attention(p, x, cfg, kind, dtype, q_chunk, mesh):
    window = cfg.local_window if kind == ATTN_LOCAL else 0
    return attend(p, x, x, cfg, dtype, mesh, causal=True, window=window,
                  attn_softcap=cfg.attn_softcap, q_chunk=q_chunk, rope=True)


def cross_kv(p, memory, cfg, dtype, mesh):
    """The cross-attention K/V of the memory, the rank's KV heads."""
    ws = [p["wk"], p["wv"]] + ([p["bk"], p["bv"]] if cfg.qkv_bias else [])

    def local(mem, wk, wv, *b):
        lp = {"wk": wk, "wv": wv}
        if b:
            lp.update(bk=b[0], bv=b[1])
        return attn.project_cross_kv(lp, mem, cfg, dtype)

    return per_rank(local, memory, *ws, mesh=mesh)


def _cache_spec(shape, mesh) -> tuple:
    """A [B, T, Kh, hd] cache's spec (``launch.steps.kv_cache_spec`` with
    the cells dim stripped)."""
    from repro_torch.launch.steps import kv_cache_spec

    return tuple(kv_cache_spec((1, *shape), mesh, active_rules()))[1:]


def to_cache(t, shape, cfg, mesh, B: int, whole_t: bool = False):
    """K or V ``[*mesh, B_loc, T, Kh_loc, hd]`` as computed into the layout
    of the cache spec of its global ``shape`` (with ``whole_t``, T kept
    whole: a decode step's one position)."""
    have = (batch_axes(B) or None, None, _heads(cfg)[1] or None, None)
    want = list(_cache_spec(shape, mesh)) + [None] * 4
    if whole_t:
        want[1] = None
    return relayout(t, have, tuple(want[:4]), mesh)


def _decode_local_attention(qg, k, v, ok, cfg, dtype):
    """The flat decode's softmax over one rank's cache: qg [B,Kh,G,hd],
    k/v [B,T,Kh,hd], ok [B,T] → o [B,Kh,G,hd]."""
    T = k.shape[1]
    if T > attn.DECODE_KV_CHUNK and T % attn.DECODE_KV_CHUNK == 0:
        return attn._online_softmax_decode(qg, k, v, ok, cfg, dtype)
    s = einsum32("bkgd,btkd->bkgt", qg, k, dtype=dtype) / math.sqrt(qg.shape[-1])
    s = softcap(s, cfg.attn_softcap)
    s = torch.where(ok[:, None, None, :], s, attn.NEG_INF)
    return einsum_lp("bkgt,btkd->bkgd", torch.softmax(s, dim=-1), v, dtype)


def row_positions(pos, B: int, device) -> torch.Tensor:
    """``pos`` as every row's global position, ``[B]``: an int or a 0-d
    tensor is the position of every row; a ``[B]`` tensor (the same on
    every process, or placed by ``P()``: size-1 mesh dims in front) holds
    one position a row."""
    pos = torch.as_tensor(pos, device=device)
    if pos.ndim == 0:
        return pos.expand(B)
    if pos.shape[-1] != B or pos.numel() != B:
        raise ValueError(f"pos {tuple(pos.shape)}: a position for every row or one per row "
                         f"([{B}])")
    return pos.reshape(B)


def write_slot(placed, new, spec, slots, mesh):
    """Write ``new`` (stacked ``[*mesh, B, 1, Kh, hd]`` in ``spec``'s
    layout) into a placed ``[B, T, Kh, hd]`` cache of ``spec`` in place,
    global row ``b`` at global slot ``slots[b]`` (``slots``: ``[B]``, the
    same on every process): the rank whose block of T holds a row's slot
    writes that row, the others keep theirs."""
    new = to_placed(new, mesh, spec)
    t_axes = _entry(spec, 1)
    rows = place(slots, mesh, P(*tuple(spec)[:1]))  # the rows' slots as the cache holds its rows
    lead = () if mesh.processes else tuple(placed.shape[:_lead(mesh)])
    k = len(lead)
    T_loc = placed.shape[k + 1]
    if mesh.processes:
        t0 = torch.tensor(axes_index(mesh, t_axes, mesh.coords(mesh.process_rank)) * T_loc,
                          device=placed.device)
    else:
        names = mesh.axis_names
        t0 = torch.zeros(lead, dtype=torch.long, device=placed.device)
        for a in t_axes:
            i = names.index(a)
            t0 = t0 * mesh.shape[a] + torch.arange(lead[i], device=placed.device).reshape(
                [lead[i] if j == i else 1 for j in range(k)])
        t0 = (t0 * T_loc)[..., None]
    local = rows.long() - t0
    ok = (local >= 0) & (local < T_loc)
    idx = local.clamp(0, T_loc - 1).reshape(*local.shape, 1, 1, 1).expand(new.shape)
    old = placed.gather(k + 1, idx)
    okb = ok.reshape(*ok.shape, 1, 1, 1)
    placed.scatter_(k + 1, idx, torch.where(okb, new.to(placed.dtype), old))


def _entry(spec, d) -> tuple:
    e = spec[d] if d < len(spec) else None
    return () if e is None else ((e,) if isinstance(e, str) else tuple(e))


def decode_self_attention(p, x, kc, vc, kspec, pos, cfg, kind, dtype, mesh, B: int):
    """One-token decode of the rank's heads against the placed cache
    ``kc``/``vc`` (a supercell's ``[B, T, Kh, hd]`` laid out by ``kspec``,
    written in place) at ``pos`` (:func:`row_positions`: one position for
    every row, or one a row): the flat softmax where the cache holds heads
    or batch blocks, the distributed flash-decode over T where it is
    sequence-sharded (the queries all-gathered first, the rank's heads
    taken after).  Each row writes its slot (``pos % T``: a rolling local
    cache wraps per row) on the rank whose block of T holds it, and reads
    the entries of its own window."""
    L = _lead(mesh)
    q_axes, _ = _heads(cfg)
    B_loc = x.shape[L]
    local_shape = tuple(kc.shape if mesh.processes else kc.shape[L:])
    t_axes = _entry(kspec, 1)
    T = local_shape[1] * axes_size(mesh, t_axes)
    dev = x.device
    pos = row_positions(pos, B, dev)
    slots = pos % T if T > 0 else torch.zeros_like(pos)
    # each rank's rows of the token's batch: [*mesh, B_loc, 1]
    bspec = P(batch_axes(B) or None)
    positions, slotb = (enter(place(t, mesh, bspec), mesh, bspec)[..., None]
                        for t in (pos, slots))
    ws = _weights(p)

    def project(x, positions, *ws):
        return attn._project_qkv(_lp(p, ws), x, x, cfg, dtype, positions, positions)

    q, k, v = per_rank(project, x, positions, *ws, mesh=mesh)
    full = (B, T, cfg.n_kv_heads, cfg.head_dim_)
    write_slot(kc, to_cache(k, full, cfg, mesh, B, whole_t=True), kspec, slots, mesh)
    write_slot(vc, to_cache(v, full, cfg, mesh, B, whole_t=True), kspec, slots, mesh)
    ck, cv = enter(kc, mesh, kspec), enter(vc, mesh, kspec)

    # each row's valid entries, as the flat decode builds them: [*mesh, B_loc, T]
    window = cfg.local_window if kind == ATTN_LOCAL else 0
    kv_pos = torch.arange(T, device=dev)
    abs_pos = torch.where(kv_pos <= slotb, positions - (slotb - kv_pos),
                          positions - (slotb + T - kv_pos))
    valid = (abs_pos >= 0) & (abs_pos <= positions)
    if window > 0:
        valid &= abs_pos > positions - window
    hd = cfg.head_dim_

    if t_axes:
        # sequence-sharded cache: every query head on every rank, each rank
        # its slice of T, the LSE combine over the T axes
        qa = all_gather(q, q_axes, mesh, 2) if q_axes else q
        Kh = ck.shape[L + 2]
        qg = qa.reshape(*qa.shape[:L], B_loc, Kh, cfg.n_heads // Kh, hd)
        o = attn.flash_decode_block(qg, ck, cv, own(valid, t_axes, mesh, 1), cfg, dtype, mesh,
                                    t_axes)
        o = o.reshape(*o.shape[:L], B_loc, 1, cfg.n_heads, hd)
        o = own(o, q_axes, mesh, 2) if q_axes else o
    else:
        def local(c, q, k, v, ok):
            kq, vq = _kv_for_q(k, v, c, cfg, mesh, q.shape[2])
            qg = q.reshape(B_loc, kq.shape[2], q.shape[2] // kq.shape[2], hd)
            return _decode_local_attention(qg, kq, vq, ok, cfg, dtype).reshape(q.shape)

        o = _local(mesh, local, q, ck, cv, valid)
    o = o.to(dtype)
    y = per_rank(lambda o, wo: attn._out_proj({"wo": wo}, o, cfg, dtype), o, p["wo"], mesh=mesh)
    return psum(y, q_axes, mesh)


def cross_decode_attention(p, x, kc, vc, kspec, cfg, dtype, mesh):
    """One-token cross-attention of the rank's heads against the cached
    encoder K/V (all-gathered where the cache splits T or the heads
    otherwise than the query heads need)."""
    _, kv_axes = _heads(cfg)
    ck, cv = enter(kc, mesh, kspec), enter(vc, mesh, kspec)
    want = (kspec[0], None, kv_axes or None, None)
    ck, cv = relayout(ck, kspec, want, mesh), relayout(cv, kspec, want, mesh)
    return attend_cached(p, x, ck, cv, cfg, dtype, mesh)


def attend_cached(p, x, ck, cv, cfg, dtype, mesh):
    q_axes, _ = _heads(cfg)
    ws = [p["wq"], p["wo"]] + ([p["bq"]] if cfg.qkv_bias else [])

    def local(c, x, k, v, wq, wo, *bq):
        q = attn._project("bsd,dhk->bshk", x, wq, bq[0] if bq else None, dtype)
        kq, vq = _kv_for_q(k, v, c, cfg, mesh, q.shape[2])
        B, H, hd = q.shape[0], q.shape[2], q.shape[-1]
        qg = q.reshape(B, 1, kq.shape[2], H // kq.shape[2], hd)
        s = einsum32("bckgd,btkd->bckgt", qg, kq, dtype=dtype) / math.sqrt(hd)
        o = einsum_lp("bckgt,btkd->bckgd", torch.softmax(s, dim=-1), vq, dtype)
        return attn._out_proj({"wo": wo}, o.reshape(B, 1, H, hd), cfg, dtype)

    return psum(_local(mesh, local, x, ck, cv, *ws), q_axes, mesh)


# -- mamba --------------------------------------------------------------------


def _channels(cfg, mesh, c, axes):
    """The rank's channels of d_inner as (first head, heads, first channel
    of the head, channels a head): a block of whole heads, or a part of
    one head."""
    d_inner, nh = mamba_mod.mamba_dims(cfg)
    P_ = mamba_mod.HEAD_P
    n = d_inner // axes_size(mesh, axes)
    off = axes_index(mesh, axes, c) * n
    if n % P_ == 0:
        return off // P_, n // P_, 0, P_
    if P_ % n:
        raise NotImplementedError(f"mamba channel blocks of {n} split the heads of {P_} unevenly")
    return off // P_, 1, off % P_, n


def mamba(p, x, cfg, dtype, mesh, state=None, chunk: int = 256):
    """Mamba over the rank's channels (see the module's docstring).
    ``state``: stacked (conv [B,K-1,d_inner_loc], h [B,nh,N,P] whole).
    Returns ``(y, (conv_loc, h_whole))``."""
    L = _lead(mesh)
    d_inner, nh = mamba_mod.mamba_dims(cfg)
    in_axes = clamp_axes("mlp", 2 * d_inner)
    ch_axes = clamp_axes("mlp", d_inner)
    xz = per_rank(lambda x, w: einsum32("bsd,de->bse", x, w, dtype=dtype), x, p["in_proj"],
                  mesh=mesh)
    xz = all_gather(xz, in_axes, mesh, 2) if in_axes else xz
    xs, z = xz[..., :d_inner], xz[..., d_inner:]
    if ch_axes:
        xs, z = own(xs, ch_axes, mesh, 2), own(z, ch_axes, mesh, 2)
    conv_state = state[0] if state is not None else None
    h_whole = state[1] if state is not None else None
    has = (conv_state is not None, h_whole is not None)

    names = ("conv_w", "conv_b", "dt_proj", "dt_bias", "B_proj", "C_proj", "A_log", "D",
             "out_proj")

    def local(c, x, xs, z, *ws):
        lp = dict(zip(names, ws))
        st = list(ws[len(names):])
        cs = st.pop(0) if has[0] else None
        h0 = st.pop(0) if has[1] else None
        h_first, n_h, p0, n_p = _channels(cfg, mesh, c, ch_axes) if ch_axes else (0, nh, 0,
                                                                                 mamba_mod.HEAD_P)
        n_ch = n_h * n_p
        c0 = h_first * mamba_mod.HEAD_P + p0
        if lp["conv_b"].shape[0] != n_ch:
            lp["conv_b"] = lp["conv_b"][c0:c0 + n_ch]
        hl = h0[:, h_first:h_first + n_h, :, p0:p0 + n_p] if h0 is not None else None
        out, conv, h = mamba_mod.mamba_channels(lp, x, xs, z, dtype, chunk, cs, hl, h_first, n_h)
        # h [B, n_h, N, n_p] as channels [B, N, n_ch] (head-major), for the gather
        return out, conv, h.permute(0, 2, 1, 3).reshape(x.shape[0], h.shape[2], n_ch)

    ins = [x, xs, z] + [p[k] for k in names] + [t for t in (conv_state, h_whole) if t is not None]
    y, conv, hc = _local(mesh, local, *ins)
    y = psum(y, ch_axes, mesh)
    hc = all_gather(hc, ch_axes, mesh, 2) if ch_axes else hc
    h = hc.reshape(*hc.shape[:L + 2], nh, mamba_mod.HEAD_P).movedim(L + 2, L + 1)
    return y, (conv, h)


# -- xLSTM --------------------------------------------------------------------


def mlstm(p, x, cfg, dtype, mesh, chunk: int = 256, state=None):
    """mLSTM with v, z and the down projection on the rank's block of
    hd_v; the per-head norm's sum of squares psummed; C all-gathered."""
    nh = cfg.n_heads
    hd = 2 * cfg.d_model // nh
    axes = clamp_axes("mlp", hd)
    has_state = state is not None

    names = ("up_x", "up_z", "wq", "wk", "wv", "wi", "wf", "bf")

    def local(c, x, *ws):
        z, q, k, v, logi, logf = xlstm_mod.mlstm_inputs(dict(zip(names, ws)), x, dtype)
        s0 = None
        if has_state:
            C, n = ws[len(names):]
            e0 = axes_index(mesh, axes, c) * v.shape[-1] if axes else 0
            s0 = (C[..., e0:e0 + v.shape[-1]], n)
        h, (C, n) = xlstm_mod.mlstm_chunk_scan(q, k, v, logf, logi, chunk, s0)
        return h, z, C, n, torch.square(h.float()).sum(-1)

    ins = [x] + [p[k] for k in names] + (list(state) if has_state else [])
    h, z, C, n, ss = _local(mesh, local, *ins)
    var = psum(ss, axes, mesh) / hd

    def out(c, h, z, var, gamma, down):
        n_v = h.shape[-1]
        e0 = axes_index(mesh, axes, c) * n_v if axes else 0
        g = gamma[..., e0:e0 + n_v] if gamma.shape[-1] != n_v else gamma
        return xlstm_mod.mlstm_output({"out_norm": g, "down_proj": down}, h, z, var, dtype)

    y = psum(_local(mesh, out, h, z, var, p["out_norm"], p["down_proj"]), axes, mesh)
    C = all_gather(C, axes, mesh, 3) if axes else C
    return y, (C, n)


def slstm(p, x, cfg, dtype, mesh, state=None):
    """sLSTM on the rank's heads; their outputs all-gathered for the gated
    MLP; the states all-gathered (whole in the cache)."""
    nh = cfg.n_heads
    h_axes = clamp_axes("heads", nh)
    m_axes = clamp_axes("mlp", (4 * cfg.d_model) // 3)
    has_state = state is not None

    def local(c, x, w_gates, r_gates, b_gates, *st):
        n_l = w_gates.shape[2]
        h0 = axes_index(mesh, h_axes, c) * n_l if h_axes else 0
        s0 = tuple(t[:, h0:h0 + n_l] for t in st) if has_state else None
        gates_x = einsum32("bsd,dghe->bsghe", x, w_gates, dtype=dtype)
        y, s1 = xlstm_mod.slstm_cells(gates_x, r_gates, b_gates, s0, x.dtype)
        return (y, *s1)

    ins = [x, p["w_gates"], p["r_gates"], p["b_gates"]] + (list(state) if has_state else [])
    y, *st = _local(mesh, local, *ins)
    if h_axes:
        y = all_gather(y, h_axes, mesh, 2)
        st = [all_gather(t, h_axes, mesh, 1) for t in st]

    def mlp(y, up1, up2, down):
        return xlstm_mod.slstm_mlp({"up1": up1, "up2": up2, "down": down}, y, dtype)

    out = psum(per_rank(mlp, y, p["up1"], p["up2"], p["down"], mesh=mesh), m_axes, mesh)
    return out, tuple(st)


# -- the models' entry points -------------------------------------------------


def _cells(tree, n: int, L: int) -> list:
    if isinstance(tree, dict):
        per_key = {k: _cells(v, n, L) for k, v in tree.items()}
        return [{k: v[c] for k, v in per_key.items()} for c in range(n)]
    return list(torch.unbind(tree, L))


def _ffn_part(slot_p, x, cfg, dtype, aux, mesh, B: int):
    if cfg.d_ff <= 0:
        return x, aux
    h = norm(x, slot_p["norm_ffn"], cfg.norm_eps, mesh)
    if "moe" in slot_p:
        y, moe_aux = moe(slot_p["moe"], h, cfg, dtype, mesh, B)
        aux = {k: aux.get(k, 0.0) + v for k, v in moe_aux.items()} if aux is not None else None
    else:
        y = swiglu(slot_p["ffn"], h, dtype, cfg.d_ff, mesh)
    return x + y, aux


def embed_inputs(params, cfg, tokens, modality, dtype, mesh):
    x = embed_lookup(params["embed"], tokens, dtype, cfg, mesh)
    if cfg.modality == "vision" and modality is not None:
        vis = per_rank(lambda m, w1, w2: lm_mod.project_vision(m, w1, w2, dtype), modality, params["projector"]["w1"], params["projector"]["w2"],
                       mesh=mesh)
        x = torch.cat([vis, x], dim=_lead(mesh) + 1)
    return x


def encode(params, cfg, frames, dtype, mesh, B: int):
    L = _lead(mesh)
    x = frames.to(dtype)
    enc_cfg = dataclasses.replace(cfg, block_pattern=(ATTN,))
    for lp in _cells(params["encoder"]["layers"], cfg.n_encoder_layers, L):
        h = norm(x, lp["norm_mixer"], cfg.norm_eps, mesh)
        y, _, _ = attend(lp["attn"], h, h, enc_cfg, dtype, mesh, causal=False)
        x = x + y
        x, _ = _ffn_part(lp, x, enc_cfg, dtype, None, mesh, B)
    return norm(x, params["encoder"]["norm"], cfg.norm_eps, mesh)


def run_slot(slot_p, x, cfg, slot, dtype, memory, aux, q_chunk, mesh, B: int):
    """One slot of a supercell (train and prefill) of a batch of ``B``
    global rows: ``(x, aux, state)``, ``state`` what the slot's cache
    keeps (K/V as computed, or the recurrent states)."""
    kind = cfg.layer_kind(slot)
    h = norm(x, slot_p["norm_mixer"], cfg.norm_eps, mesh)
    if kind in (ATTN, ATTN_LOCAL):
        y, k, v = self_attention(slot_p["attn"], h, cfg, kind, dtype, q_chunk, mesh)
        state = (k, v)
    elif kind == MAMBA:
        y, state = mamba(slot_p["mamba"], h, cfg, dtype, mesh)
    elif kind == MLSTM:
        y, state = mlstm(slot_p["mlstm"], h, cfg, dtype, mesh)
    elif kind == SLSTM:
        y, state = slstm(slot_p["slstm"], h, cfg, dtype, mesh)
    else:
        raise ValueError(kind)
    x = x + y
    if memory is not None:
        hc = norm(x, slot_p["norm_cross"], cfg.norm_eps, mesh)
        y, _, _ = attend(slot_p["cross"], hc, memory, cfg, dtype, mesh, causal=False)
        x = x + y
    x, aux = _ffn_part(slot_p, x, cfg, dtype, aux, mesh, B)
    return x, aux, state


def _init_aux(cfg, x, mesh):
    if cfg.moe is None or cfg.moe_every <= 0:
        return {}
    z = torch.zeros(x.shape[:_lead(mesh)], device=x.device)
    return {"moe_lb_loss": z, "moe_z_loss": z}


def forward_train(params, cfg, tokens, modality, remat: bool, q_chunk: int, mesh,
                  B: Optional[int] = None):
    """``lm.forward_train`` in the body: ``(vocab-sharded logits, aux)``,
    stacked; a remat'd supercell runs again in the backward inside the
    same body.  ``B``: the batch's global rows (default
    :func:`global_rows`: a batch that every batch axis splits)."""
    dtype = torch_dtype(cfg.dtype)
    L = _lead(mesh)
    B = global_rows(tokens.shape[L], mesh) if B is None else B
    memory = None
    if cfg.is_encoder_decoder:
        memory = encode(params, cfg, modality, dtype, mesh, B)
        x = embed_inputs(params, cfg, tokens, None, dtype, mesh)
    else:
        x = embed_inputs(params, cfg, tokens, modality, dtype, mesh)
    aux = _init_aux(cfg, x, mesh)
    ctx = active_context()

    def cell(x, aux, cell_p):
        with use_context(ctx):
            for s in range(len(cfg.block_pattern)):
                x, aux, _ = run_slot(cell_p[f"slot{s}"], x, cfg, s, dtype, memory, aux, q_chunk,
                                     mesh, B)
        return x, aux

    remat = remat and torch.is_grad_enabled()
    for cell_p in _cells(params["cells"], cfg.n_supercells, L):
        if remat:
            x, aux = checkpoint(cell, x, aux, cell_p, use_reentrant=False,
                                preserve_rng_state=False)
        else:
            x, aux = cell(x, aux, cell_p)
    return logits(params, cfg, x, dtype, mesh), aux


def forward_prefill(params, cfg, tokens, modality, q_chunk: int, mesh, B: int):
    """``lm.forward_prefill`` in the body: ``(vocab-sharded logits of the
    last position, cache)``, stacked, each cache leaf in the layout of
    ``launch.steps.cache_pspecs``."""
    from repro_torch.models.lm import _slot_cache_len

    dtype = torch_dtype(cfg.dtype)
    L = _lead(mesh)
    memory = None
    if cfg.is_encoder_decoder:
        memory = encode(params, cfg, modality, dtype, mesh, B)
        x = embed_inputs(params, cfg, tokens, None, dtype, mesh)
    else:
        x = embed_inputs(params, cfg, tokens, modality, dtype, mesh)
    S = x.shape[L + 1]
    kh, hd = cfg.n_kv_heads, cfg.head_dim_
    cells = []
    for cell_p in _cells(params["cells"], cfg.n_supercells, L):
        caches = {}
        for s in range(len(cfg.block_pattern)):
            slot_p = cell_p[f"slot{s}"]
            kind = cfg.layer_kind(s)
            x, _, state = run_slot(slot_p, x, cfg, s, dtype, memory, None, q_chunk, mesh, B)
            if kind in (ATTN, ATTN_LOCAL):
                T = _slot_cache_len(cfg, s, S)
                kc, vc = (t.narrow(L + 1, S - T, T) for t in state)
                if S % T:
                    kc, vc = (torch.roll(t, S % T, dims=L + 1) for t in (kc, vc))
                caches[f"slot{s}"] = {"k": to_cache(kc, (B, T, kh, hd), cfg, mesh, B),
                                      "v": to_cache(vc, (B, T, kh, hd), cfg, mesh, B)}
                if memory is not None:
                    ck, cv = cross_kv(slot_p["cross"], memory, cfg, dtype, mesh)
                    Tm = ck.shape[L + 1]
                    caches[f"slot{s}"]["ck"] = to_cache(ck, (B, Tm, kh, hd), cfg, mesh, B)
                    caches[f"slot{s}"]["cv"] = to_cache(cv, (B, Tm, kh, hd), cfg, mesh, B)
            elif kind == MAMBA:
                caches[f"slot{s}"] = {"conv": state[0], "h": state[1]}
            elif kind == MLSTM:
                caches[f"slot{s}"] = {"C": state[0], "n": state[1]}
            else:
                caches[f"slot{s}"] = {f"s{i}": t for i, t in enumerate(state)}
        cells.append(caches)
    cache = {k: {n: torch.stack([c[k][n] for c in cells], dim=L) for n in cells[0][k]}
             for k in cells[0]}
    return logits(params, cfg, x.select(L + 1, S - 1), dtype, mesh), cache


def _cell_of(leaf, c: int, mesh):
    return leaf[c] if mesh.processes else leaf.select(_lead(mesh), c)


def decode_step(params, cfg, token, pos, cache, cspecs, mesh, B: int):
    """``lm.decode_step`` in the body: ``token`` stacked, ``pos`` one
    position for every row (an int or a 0-d tensor) or every row's own
    (``[B]``, the same on every process; :func:`row_positions`), ``cache``
    the placed cache (written in place) laid out by ``cspecs``.  Returns
    the vocab-sharded logits, stacked."""
    dtype = torch_dtype(cfg.dtype)
    L = _lead(mesh)
    pos = row_positions(pos, B, token.device)
    x = embed_lookup(params["embed"], token.unsqueeze(-1), dtype, cfg, mesh)
    for c, cell_p in enumerate(_cells(params["cells"], cfg.n_supercells, L)):
        for s in range(len(cfg.block_pattern)):
            slot_p = cell_p[f"slot{s}"]
            sc = {n: _cell_of(t, c, mesh) for n, t in cache[f"slot{s}"].items()}
            sp = {n: P(*tuple(t)[1:]) for n, t in cspecs[f"slot{s}"].items()}
            kind = cfg.layer_kind(s)
            h = norm(x, slot_p["norm_mixer"], cfg.norm_eps, mesh)
            if kind in (ATTN, ATTN_LOCAL):
                y = decode_self_attention(slot_p["attn"], h, sc["k"], sc["v"], sp["k"], pos, cfg,
                                          kind, dtype, mesh, B)
                new = {}
            else:
                names = {MAMBA: ("conv", "h"), MLSTM: ("C", "n"),
                         SLSTM: ("s0", "s1", "s2", "s3")}[kind]
                st = tuple(enter(sc[n], mesh, sp[n]) for n in names)
                if kind == MAMBA:
                    y, st = mamba(slot_p["mamba"], h, cfg, dtype, mesh, state=st, chunk=1)
                elif kind == MLSTM:
                    y, st = mlstm(slot_p["mlstm"], h, cfg, dtype, mesh, chunk=1, state=st)
                else:
                    y, st = slstm(slot_p["slstm"], h, cfg, dtype, mesh, state=st)
                new = dict(zip(names, st))
            for n, t in new.items():
                sc[n].copy_(to_placed(t, mesh, sp[n]))
            x = x + y
            if "ck" in sc:
                hc = norm(x, slot_p["norm_cross"], cfg.norm_eps, mesh)
                x = x + cross_decode_attention(slot_p["cross"], hc, sc["ck"], sc["cv"], sp["ck"],
                                               cfg, dtype, mesh)
            x, _ = _ffn_part(slot_p, x, cfg, dtype, None, mesh, B)
    return logits(params, cfg, x.select(L + 1, 0), dtype, mesh)
