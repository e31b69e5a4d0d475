"""Model assembly: embedding → stacked supercells → norm → logits.

Port of ``repro.models.lm``.  Heterogeneous stacks (jamba, gemma2, xlstm)
repeat a *supercell* of block kinds; parameters are stacked per slot over
supercells (``[n_cells, …]`` leaves, the reference's pytree paths) and the
forward passes loop over the stacked cell dim (the reference's
``lax.scan``).

Three entry points per model:
  forward_train    — full-sequence forward, logits for the loss; autograd
                     differentiates it (``repro_torch.train``), and
                     ``remat=True`` recomputes each supercell in the
                     backward (``torch.utils.checkpoint``, the reference's
                     ``jax.checkpoint``);
  forward_prefill  — forward + cache construction (inference prefill),
                     under ``torch.no_grad()``;
  decode_step      — one token against the cache (decode / long-context),
                     under ``torch.no_grad()``.

Encoder-decoder (seamless) adds an encoder stack + cross-attention;
modality stubs (audio frames / ViT patches) enter as precomputed
embeddings.  Parameters and caches live on the card unless the caller
asks for another device.

Under ``repro_torch.dist.use_mesh`` the same entry points run the mesh
branches: the sequence-sharded flash-decode (``attention``) and expert
parallelism (``moe``) compute per rank; every ``shard`` annotation (the
reference's ``with_sharding_constraint``) records its layout and returns
its input unchanged, so the rest computes as without a mesh.  A remat'd
supercell runs again in the backward under the forward's mesh.  Inside a
tensor-parallel body (``dist.sharding.tensor_parallel``) the weights are
each rank's blocks and ``models.tp`` computes the entry points
(``ShardedTrainStep``, ``launch.steps.ShardedPrefill``/``ShardedDecode``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ATTN, ATTN_LOCAL, MAMBA, MLSTM, ModelConfig, SLSTM
from repro_torch.dist.sharding import active_context, body_mesh, shard, use_context
from repro_torch.models import attention as attn
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.layers import (
    dense_init,
    einsum32,
    einsum_lp,
    embed_init,
    embed_lookup,
    rms_norm,
    swiglu_apply,
    swiglu_init,
    torch_dtype,
    unembed_logits,
    zeros,
)


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return torch_dtype(cfg.dtype)


def default_device(device=None) -> torch.device:
    """``device``, or the card; raises where the card is asked for and
    there is none (nothing falls back to the CPU)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of a nested dict (leaf order: insertion) and
    the matching leaves of ``rest``, nested dicts of the same keys."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def _cell(tree: dict, c: int) -> dict:
    """Supercell ``c`` of stacked ``[n_cells, …]`` leaves (views)."""
    return tree_map(lambda t: t[c], tree)


def _cells(tree: dict, n: int) -> list:
    """Every supercell of stacked ``[n_cells, …]`` leaves (views, like
    :func:`_cell`): one ``unbind`` a leaf, whose backward stacks the cells'
    gradients once instead of scattering each into a full-size zero."""
    if isinstance(tree, dict):
        per_key = {k: _cells(v, n) for k, v in tree.items()}
        return [{k: v[c] for k, v in per_key.items()} for c in range(n)]
    return list(torch.unbind(tree, 0))


def _stack(cells: list) -> dict:
    return {
        k: _stack([c[k] for c in cells]) if isinstance(cells[0][k], dict)
        else torch.stack([c[k] for c in cells])
        for k in cells[0]
    }


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------


def _slot_init(gen, device, cfg: ModelConfig, slot: int, cross: bool, lead: tuple) -> dict:
    kind = cfg.block_pattern[slot]
    p: dict[str, Any] = {"norm_mixer": zeros(device, (cfg.d_model,), lead)}
    if kind in (ATTN, ATTN_LOCAL):
        p["attn"] = attn.attn_init(gen, device, cfg, lead)
    elif kind == MAMBA:
        p["mamba"] = mamba_mod.mamba_init(gen, device, cfg, lead)
    elif kind == MLSTM:
        p["mlstm"] = xlstm_mod.mlstm_init(gen, device, cfg, lead)
    elif kind == SLSTM:
        p["slstm"] = xlstm_mod.slstm_init(gen, device, cfg, lead)
    if cross:
        p["norm_cross"] = zeros(device, (cfg.d_model,), lead)
        p["cross"] = attn.attn_init(gen, device, cfg, lead)
    if cfg.d_ff > 0:
        p["norm_ffn"] = zeros(device, (cfg.d_model,), lead)
        if cfg.layer_is_moe(slot):
            p["moe"] = moe_mod.moe_init(gen, device, cfg, lead)
        else:
            p["ffn"] = swiglu_init(gen, device, cfg.d_model, cfg.d_ff, lead)
    return p


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device=None) -> dict:
    """Random float32 parameters: the reference's pytree (same paths,
    shapes and initial distributions), drawn from ``generator`` (default:
    one seeded with 0 on ``device``) onto ``device`` (default: the card).
    ``device="meta"`` gives the shapes alone."""
    dev = default_device(device)
    gen = None
    if dev.type != "meta":
        gen = generator if generator is not None else torch.Generator(device=dev).manual_seed(0)
    lead = (cfg.n_supercells,)
    params = {
        "embed": embed_init(gen, dev, cfg.vocab_size, cfg.d_model),
        "final_norm": zeros(dev, (cfg.d_model,)),
        "cells": {
            f"slot{s}": _slot_init(gen, dev, cfg, s, cfg.is_encoder_decoder, lead)
            for s in range(len(cfg.block_pattern))
        },
    }
    if not cfg.tie_embeddings:
        params["unembed"] = embed_init(gen, dev, cfg.vocab_size, cfg.d_model)
    if cfg.is_encoder_decoder:
        enc_cfg = dataclasses.replace(cfg, block_pattern=(ATTN,))
        params["encoder"] = {
            "layers": _slot_init(gen, dev, enc_cfg, 0, False, (cfg.n_encoder_layers,)),
            "norm": zeros(dev, (cfg.d_model,)),
        }
    if cfg.modality == "vision" and cfg.modality_dim:
        params["projector"] = {
            "w1": dense_init(gen, dev, cfg.modality_dim, cfg.d_model),
            "w2": dense_init(gen, dev, cfg.d_model, cfg.d_model),
        }
    return params


def leaves(tree: dict, prefix: str = "") -> dict:
    """``{path: leaf}``, the path the reference's pytree keys joined by
    ``.`` (``cells.slot0.attn.wq``)."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        out.update(leaves(v, path + ".") if isinstance(v, dict) else {path: v})
    return out


# --------------------------------------------------------------------------
# blocks
# --------------------------------------------------------------------------


def _ffn_part(slot_p, x, cfg, dtype, aux):
    if cfg.d_ff <= 0:
        return x, aux
    h = rms_norm(x, slot_p["norm_ffn"], cfg.norm_eps)
    if "moe" in slot_p:
        y, moe_aux = moe_mod.moe_apply(slot_p["moe"], h, cfg, dtype)
        aux = {k: aux.get(k, 0.0) + v for k, v in moe_aux.items()} if aux is not None else None
    else:
        y = swiglu_apply(slot_p["ffn"], h, dtype)
    return x + y, aux


def _run_slot_train(slot_p, x, cfg, slot, dtype, memory, aux, q_chunk):
    kind = cfg.layer_kind(slot)
    h = rms_norm(x, slot_p["norm_mixer"], cfg.norm_eps)
    if kind in (ATTN, ATTN_LOCAL):
        y, _ = attn.self_attention(slot_p["attn"], h, cfg, kind=kind, dtype=dtype, q_chunk=q_chunk)
    elif kind == MAMBA:
        y, _ = mamba_mod.mamba_apply(slot_p["mamba"], h, cfg, dtype)
    elif kind == MLSTM:
        y, _ = xlstm_mod.mlstm_apply(slot_p["mlstm"], h, cfg, dtype)
    elif kind == SLSTM:
        y, _ = xlstm_mod.slstm_apply(slot_p["slstm"], h, cfg, dtype)
    else:
        raise ValueError(kind)
    x = x + y
    if memory is not None:
        hc = rms_norm(x, slot_p["norm_cross"], cfg.norm_eps)
        x = x + attn.cross_attention(slot_p["cross"], hc, memory, cfg, dtype=dtype)
    return _ffn_part(slot_p, x, cfg, dtype, aux)


# --------------------------------------------------------------------------
# embedding / frontends
# --------------------------------------------------------------------------


def project_vision(modality, w1, w2, dtype):
    """The vision projector: modality features [B,M,F] to [B,M,D]."""
    h = einsum32("bmd,de->bme", modality, w1, dtype=dtype)
    h = F.gelu(h, approximate="tanh").to(dtype)  # jax.nn.gelu's default
    return einsum_lp("bme,ef->bmf", h, w2, dtype)


def embed_inputs(params, cfg: ModelConfig, tokens, modality=None, dtype=None):
    dtype = dtype or _dtype(cfg)
    x = embed_lookup(params["embed"], tokens, dtype)
    if cfg.modality == "vision" and modality is not None:
        vis = project_vision(modality, params["projector"]["w1"], params["projector"]["w2"],
                             dtype)
        x = torch.cat([vis, x], dim=1)
    return shard(x, "batch", "seq", "embed_act")


def encode(params, cfg: ModelConfig, frames, dtype=None):
    """Bidirectional encoder over (stub) modality frame embeddings."""
    dtype = dtype or _dtype(cfg)
    x = frames.to(dtype)
    enc_cfg = dataclasses.replace(cfg, block_pattern=(ATTN,))
    layers = params["encoder"]["layers"]
    for lp in _cells(layers, cfg.n_encoder_layers):
        h = rms_norm(x, lp["norm_mixer"], cfg.norm_eps)
        q, k, v = attn._project_qkv(lp["attn"], h, h, enc_cfg, dtype, None, None)
        o = attn.chunked_attention(q, k, v, causal=False, dtype=dtype)
        x = x + attn._out_proj(lp["attn"], o, enc_cfg, dtype)
        x, _ = _ffn_part(lp, x, enc_cfg, dtype, None)
    return rms_norm(x, params["encoder"]["norm"], cfg.norm_eps)


def _logits(params, cfg, x, dtype):
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    table = params.get("unembed", params["embed"])
    return unembed_logits(x, table, cfg.vocab_size, dtype, cfg.logit_softcap)


# --------------------------------------------------------------------------
# train / prefill forward
# --------------------------------------------------------------------------


def forward_train(params, cfg: ModelConfig, tokens, modality=None, remat: bool = True,
                  q_chunk: int = 1024):
    """tokens: [B, S_text] → (logits [B,S,Vpad], aux dict).

    Differentiable: under grad mode with ``remat``, each supercell keeps
    only its input for the backward and runs again there.  Inside a
    tensor-parallel body (``dist.sharding.tensor_parallel``) the arguments
    are stacked ranks and the logits come back vocab-sharded
    (``models.tp``)."""
    mesh = body_mesh()
    if mesh is not None:
        from repro_torch.models import tp

        return tp.forward_train(params, cfg, tokens, modality, remat, q_chunk, mesh)
    dtype = _dtype(cfg)
    memory = None
    if cfg.is_encoder_decoder:
        assert modality is not None, "encoder-decoder needs encoder frames"
        memory = encode(params, cfg, modality, dtype)
        x = embed_inputs(params, cfg, tokens, None, dtype)
    else:
        x = embed_inputs(params, cfg, tokens, modality, dtype)
    aux = (
        {"moe_lb_loss": torch.zeros((), device=x.device),
         "moe_z_loss": torch.zeros((), device=x.device)}
        if cfg.moe is not None and cfg.moe_every > 0
        else {}
    )

    # the backward recomputes a remat'd cell after this function returns:
    # it runs under the mesh (and rules) of the forward
    ctx = active_context()

    def cell(x, aux, cell_p):
        with use_context(ctx):
            for s in range(len(cfg.block_pattern)):
                x, aux = _run_slot_train(cell_p[f"slot{s}"], x, cfg, s, dtype, memory, aux,
                                         q_chunk)
                x = shard(x, "batch", "seq", "embed_act")
        return x, aux

    remat = remat and torch.is_grad_enabled()
    for cell_p in _cells(params["cells"], cfg.n_supercells):
        if remat:
            x, aux = checkpoint(cell, x, aux, cell_p, use_reentrant=False,
                                preserve_rng_state=False)
        else:
            x, aux = cell(x, aux, cell_p)
    return shard(_logits(params, cfg, x, dtype), "batch", "seq", "vocab_act"), aux


# --------------------------------------------------------------------------
# caches
# --------------------------------------------------------------------------


def _slot_cache_len(cfg: ModelConfig, slot: int, max_len: int) -> int:
    kind = cfg.layer_kind(slot)
    if kind == ATTN_LOCAL and cfg.local_window > 0:
        return min(cfg.local_window, max_len)
    return max_len


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None, memory_len: int = 0,
               device=None) -> dict:
    """Cache tree, stacked over supercells per slot, on ``device`` (default:
    the card).

    For encoder-decoder models, ``memory_len`` adds cached cross-attention
    K/V per slot (filled at prefill, read-only during decode)."""
    dev = default_device(device)
    dtype = dtype or _dtype(cfg)
    n = cfg.n_supercells
    kh, hd = cfg.n_kv_heads, cfg.head_dim_
    cache: dict[str, Any] = {}
    for s, kind in enumerate(cfg.block_pattern):
        if kind in (ATTN, ATTN_LOCAL):
            T = _slot_cache_len(cfg, s, max_len)
            cache[f"slot{s}"] = {
                "k": torch.zeros((n, batch, T, kh, hd), dtype=dtype, device=dev),
                "v": torch.zeros((n, batch, T, kh, hd), dtype=dtype, device=dev),
            }
            if cfg.is_encoder_decoder and memory_len:
                for name in ("ck", "cv"):
                    cache[f"slot{s}"][name] = torch.zeros(
                        (n, batch, memory_len, kh, hd), dtype=dtype, device=dev)
        elif kind == MAMBA:
            states = mamba_mod.mamba_init_state(cfg, batch, dtype, dev)
            cache[f"slot{s}"] = {
                name: t.expand(n, *t.shape).clone() for name, t in zip(("conv", "h"), states)
            }
        elif kind == MLSTM:
            states = xlstm_mod.mlstm_init_state(cfg, batch, dev)
            cache[f"slot{s}"] = {
                name: t.expand(n, *t.shape).clone() for name, t in zip(("C", "n"), states)
            }
        elif kind == SLSTM:
            states = xlstm_mod.slstm_init_state(cfg, batch, dev)
            cache[f"slot{s}"] = {
                f"s{i}": t.expand(n, *t.shape).clone() for i, t in enumerate(states)
            }
    return cache


def grow_cache(cfg: ModelConfig, cache: dict, new_len: int, prefill_len: int) -> dict:
    """Extend attention-cache capacity with a zero tail (serving: prefill
    length < decode budget).  Valid when the existing ring has not wrapped
    (prefill_len ≤ current capacity), so slot == position."""
    out = {}
    for key, sc in cache.items():
        s = int(key[4:])
        kind = cfg.layer_kind(s)
        if kind in (ATTN, ATTN_LOCAL) and "k" in sc:
            T = sc["k"].shape[2]
            target = _slot_cache_len(cfg, s, new_len)
            if target > T:
                assert prefill_len <= T, (
                    "cannot grow a wrapped ring cache (prefill_len > capacity)"
                )

                def pad(t):
                    tail = t.new_zeros((*t.shape[:2], target - T, *t.shape[3:]))
                    return torch.cat([t, tail], dim=2)

                sc = dict(sc, k=pad(sc["k"]), v=pad(sc["v"]))
        out[key] = sc
    return out


# --------------------------------------------------------------------------
# prefill
# --------------------------------------------------------------------------


@torch.no_grad()
def forward_prefill(params, cfg: ModelConfig, tokens, modality=None, q_chunk: int = 1024):
    """Full-sequence forward that also builds the decode cache.

    Returns (logits_last [B,Vpad], cache).  Cache lengths equal the
    prompt length (local layers: the window, as a ring)."""
    dtype = _dtype(cfg)
    memory = None
    if cfg.is_encoder_decoder:
        memory = encode(params, cfg, modality, dtype)
        x = embed_inputs(params, cfg, tokens, None, dtype)
    else:
        x = embed_inputs(params, cfg, tokens, modality, dtype)
    S = x.shape[1]
    cells = []
    for c in range(cfg.n_supercells):
        cell_p = _cell(params["cells"], c)
        caches = {}
        for s in range(len(cfg.block_pattern)):
            slot_p = cell_p[f"slot{s}"]
            kind = cfg.layer_kind(s)
            h = rms_norm(x, slot_p["norm_mixer"], cfg.norm_eps)
            if kind in (ATTN, ATTN_LOCAL):
                y, (k, v) = attn.self_attention(
                    slot_p["attn"], h, cfg, kind=kind, dtype=dtype, q_chunk=q_chunk
                )
                T = _slot_cache_len(cfg, s, S)
                kc, vc = k[:, -T:], v[:, -T:]
                if S % T:
                    # ring layout: slot = position % T (what decode's
                    # rolling-cache reconstruction expects)
                    kc = torch.roll(kc, S % T, dims=1)
                    vc = torch.roll(vc, S % T, dims=1)
                caches[f"slot{s}"] = {"k": kc, "v": vc}
                if memory is not None:
                    ck, cv = attn.project_cross_kv(slot_p["cross"], memory, cfg, dtype)
                    caches[f"slot{s}"]["ck"] = ck
                    caches[f"slot{s}"]["cv"] = cv
            elif kind == MAMBA:
                y, (conv, hst) = mamba_mod.mamba_apply(slot_p["mamba"], h, cfg, dtype)
                caches[f"slot{s}"] = {"conv": conv, "h": hst}
            elif kind == MLSTM:
                y, (C, n) = xlstm_mod.mlstm_apply(slot_p["mlstm"], h, cfg, dtype)
                caches[f"slot{s}"] = {"C": C, "n": n}
            elif kind == SLSTM:
                y, st = xlstm_mod.slstm_apply(slot_p["slstm"], h, cfg, dtype)
                caches[f"slot{s}"] = {f"s{i}": t for i, t in enumerate(st)}
            x = x + y
            if memory is not None:
                hc = rms_norm(x, slot_p["norm_cross"], cfg.norm_eps)
                x = x + attn.cross_attention(slot_p["cross"], hc, memory, cfg, dtype=dtype)
            x, _ = _ffn_part(slot_p, x, cfg, dtype, None)
            x = shard(x, "batch", "seq", "embed_act")
        cells.append(caches)
    return _logits(params, cfg, x[:, -1], dtype), _stack(cells)


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------


@torch.no_grad()
def decode_step(params, cfg: ModelConfig, token, pos, cache, memory=None):
    """token: [B] ids; pos: one position (int or 0-d tensor) or one per
    row ([B]); cache from init_cache/prefill.

    Returns (logits [B,Vpad], cache).  The cache is written in place and
    returned: every caller rebinds it, as the reference's callers rebind
    its functional update."""
    dtype = _dtype(cfg)
    x = embed_lookup(params["embed"], token[:, None], dtype)  # [B,1,D]
    for c in range(cfg.n_supercells):
        cell_p = _cell(params["cells"], c)
        cell_cache = _cell(cache, c)
        for s in range(len(cfg.block_pattern)):
            slot_p = cell_p[f"slot{s}"]
            sc = cell_cache[f"slot{s}"]
            kind = cfg.layer_kind(s)
            h = rms_norm(x, slot_p["norm_mixer"], cfg.norm_eps)
            if kind in (ATTN, ATTN_LOCAL):
                # writes this token's K/V into the cache views in place
                y, _, _ = attn.decode_self_attention(
                    slot_p["attn"], h, sc["k"], sc["v"], pos, cfg, kind=kind, dtype=dtype,
                )
                new = {}
            elif kind == MAMBA:
                y, (conv, hst) = mamba_mod.mamba_decode_step(
                    slot_p["mamba"], h, cfg, dtype, (sc["conv"], sc["h"])
                )
                new = {"conv": conv, "h": hst}
            elif kind == MLSTM:
                y, (C, n) = xlstm_mod.mlstm_apply(
                    slot_p["mlstm"], h, cfg, dtype, chunk=1, state=(sc["C"], sc["n"])
                )
                new = {"C": C, "n": n}
            elif kind == SLSTM:
                st = tuple(sc[f"s{i}"] for i in range(4))
                y, st = xlstm_mod.slstm_apply(slot_p["slstm"], h, cfg, dtype, state=st)
                new = {f"s{i}": t for i, t in enumerate(st)}
            for name, t in new.items():
                sc[name].copy_(t)
            x = x + y
            if "ck" in sc:  # cached cross-attention K/V from prefill
                hc = rms_norm(x, slot_p["norm_cross"], cfg.norm_eps)
                x = x + attn.cross_decode_attention(
                    slot_p["cross"], hc, sc["ck"], sc["cv"], cfg, dtype=dtype
                )
            elif memory is not None:
                hc = rms_norm(x, slot_p["norm_cross"], cfg.norm_eps)
                x = x + attn.cross_attention(slot_p["cross"], hc, memory, cfg, dtype=dtype)
            x, _ = _ffn_part(slot_p, x, cfg, dtype, None)
    return _logits(params, cfg, x[:, 0], dtype), cache
