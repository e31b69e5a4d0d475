"""Shared neural primitives (pure functions over nested dicts of tensors).

Port of ``repro.models.layers``.  Conventions, as in the reference:

- params are float32; compute casts to the config dtype (bfloat16) and
  products accumulate in float32.  Where the reference keeps a product in
  float32 (``preferred_element_type=jnp.float32`` used as such), the port
  multiplies the operands rounded to the compute dtype in float32
  (:func:`einsum32`, :func:`matmul`): products of bfloat16 values are exact
  in float32, so this is the reference's product up to summation order.
  Where the reference casts the product straight back to the compute dtype,
  the port multiplies in that dtype (:func:`einsum_lp`), whose GEMM
  accumulates in float32 and rounds once;
- initialisers take an explicit ``torch.Generator`` and a device, and a
  ``lead`` of stacked dims (supercells, layers) that each draw carries in
  front of its own shape.  ``gen=None`` with the ``meta`` device gives the
  shapes alone (``repro_torch.interop.params_from_numpy`` reads them);
- the reference's ``shard`` annotations sit where the reference has
  them; the port's ``repro_torch.dist.sharding.shard`` records the layout
  under an active mesh and returns its input unchanged (no-op without
  one), so no value changes.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import shard

VOCAB_PAD = 512  # embedding tables padded for clean TP sharding


def padded_vocab(v: int) -> int:
    return ((v + VOCAB_PAD - 1) // VOCAB_PAD) * VOCAB_PAD


def torch_dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


# -- initialisers -------------------------------------------------------------


def normal(gen: Optional[torch.Generator], device, shape) -> torch.Tensor:
    """Standard normal draws of ``shape`` from ``gen`` (on the generator's
    device), on ``device``; ``gen=None`` gives an uninitialised tensor
    (the shape alone on the ``meta`` device)."""
    if gen is None:
        return torch.empty(tuple(shape), device=device)
    return torch.randn(tuple(shape), generator=gen, device=gen.device).to(device)


def dense_init(gen, device, in_dim: int, out_dims, scale: Optional[float] = None,
               lead: tuple = ()) -> torch.Tensor:
    out_dims = (out_dims,) if isinstance(out_dims, int) else tuple(out_dims)
    scale = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    return normal(gen, device, (*lead, in_dim, *out_dims)).mul_(scale)


def zeros(device, shape, lead: tuple = ()) -> torch.Tensor:
    return torch.zeros((*lead, *shape), dtype=torch.float32, device=device)


# -- products -----------------------------------------------------------------


def operand(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` rounded to ``dtype``, held in float32: an operand of a product
    the reference keeps in float32."""
    return t.to(dtype).float()


def einsum32(eq: str, *ops: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``jnp.einsum(eq, *(o.astype(dtype) …), preferred_element_type=f32)``."""
    return torch.einsum(eq, *(operand(o, dtype) for o in ops))


def einsum_lp(eq: str, a: torch.Tensor, b: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``einsum32(eq, a, b).astype(dtype)``: the product in ``dtype``."""
    return torch.einsum(eq, a.to(dtype), b.to(dtype))


def matmul(x: torch.Tensor, w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x``'s last dim against ``w``'s first, kept in float32."""
    return torch.tensordot(operand(x, dtype), operand(w, dtype), dims=([x.ndim - 1], [0]))


def matmul_lp(x: torch.Tensor, w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``matmul(x, w, dtype).astype(dtype)``: the product in ``dtype``."""
    return torch.tensordot(x.to(dtype), w.to(dtype), dims=([x.ndim - 1], [0]))


# -- norms --------------------------------------------------------------------


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    # the reference multiplies x by a float32 rsqrt array, which promotes
    # a bfloat16 x to float32 before the cast back
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + gamma)).to(x.dtype)


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, correction=0, keepdim=True)  # jnp.var: the population variance
    return ((xf - mu) * torch.rsqrt(var + eps) * (1.0 + gamma) + beta).to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if cap <= 0.0:
        return x
    return torch.tanh(x / cap) * cap


# -- rotary embeddings --------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (
        theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim)
    )


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; positions: [..., seq]."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs  # [..., S, D/2]
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -- embedding / unembedding --------------------------------------------------


def embed_init(gen, device, vocab: int, d_model: int) -> torch.Tensor:
    return normal(gen, device, (padded_vocab(vocab), d_model)).mul_(0.02)


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    # gather, then cast: bitwise the reference's cast-then-gather, without
    # casting the whole table on every call; the scale is rounded to dtype
    # first, as jnp.asarray(sqrt(d), dtype) is
    out = table[tokens].to(dtype)
    return out * torch.tensor(math.sqrt(table.shape[1]), dtype=dtype)


def unembed_logits(x: torch.Tensor, table: torch.Tensor, vocab: int, dtype: torch.dtype,
                   final_softcap: float = 0.0) -> torch.Tensor:
    """x @ table^T in float32, with the padded columns masked."""
    logits = torch.matmul(operand(x, dtype), operand(table, dtype).transpose(0, 1))
    logits = softcap(logits, final_softcap)
    if table.shape[0] > vocab:
        logits[..., vocab:] += -1e9
    return logits


# -- MLPs ---------------------------------------------------------------------


def swiglu_init(gen, device, d_model: int, d_ff: int, lead: tuple = ()) -> dict:
    return {
        "wi": dense_init(gen, device, d_model, d_ff, lead=lead),   # gate
        "wu": dense_init(gen, device, d_model, d_ff, lead=lead),   # up
        "wo": dense_init(gen, device, d_ff, d_model, lead=lead),
    }


def swiglu_apply(p: dict, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    x = shard(x, "batch", "seq", "embed_act")
    g = matmul(x, shard(p["wi"], "embed", "mlp"), dtype)
    u = matmul(x, shard(p["wu"], "embed", "mlp"), dtype)
    h = shard((F.silu(g) * u).to(dtype), "batch", "seq", "mlp_act")
    return shard(matmul_lp(h, shard(p["wo"], "mlp", "embed"), dtype), "batch", "seq", "embed_act")
