"""Gradient compressors — the bandwidth lever for slow links (port of
``repro.dist.compression``).

Multi-node training all-reduces gradients over links an order of
magnitude slower than those inside a node; these compressors trade
precision for wire bytes on that hop.  Both work leaf by leaf on nested
dicts of tensors and are pure (quantize and dequantize in one call), so
they compose with microbatching.

- ``int8_roundtrip``  — symmetric per-leaf int8 quantization; worst-case
  error ≤ max|x| / 127 (one quantization step), 4× fewer bytes than f32.
- ``topk_sparsify``   — magnitude top-k masking; keeps the largest
  ``keep_fraction`` of entries per leaf and zeroes the rest.

Both round and break ties as the reference does: ``torch.round`` rounds
half to even like ``jnp.round``, and the top-k threshold's ties are kept
in index order.
"""
from __future__ import annotations

import torch

from repro_torch.models.lm import tree_map


def _int8_leaf(x):
    if not isinstance(x, torch.Tensor) or not x.is_floating_point() or x.ndim == 0:
        return x
    scale = x.abs().max() / 127.0
    # all-zero leaf: keep scale finite so dequantization returns zeros
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(x / safe), -127, 127).to(torch.int8)
    return (q.to(x.dtype) * safe).to(x.dtype)


def int8_roundtrip(tree):
    """Quantize every floating leaf to int8 and back (symmetric, per-leaf
    scale).  |out - in| ≤ max|in| / 127 · (1/2 rounding + clip slack)."""
    return tree_map(_int8_leaf, tree)


def _topk_leaf(x, keep_fraction: float):
    if not isinstance(x, torch.Tensor) or not x.is_floating_point() or x.ndim == 0:
        return x
    n = x.numel()
    k = max(1, int(n * keep_fraction))
    flat = x.reshape(-1)
    if k >= n:
        return x
    # threshold at the k-th largest magnitude: everything strictly above
    # it is kept unconditionally; ties AT the threshold are kept in index
    # order so exactly k entries survive (tie-breaking must not touch the
    # strictly-above set, or a sparse leaf with thresh == 0 would zero its
    # actual nonzeros)
    mag = flat.abs()
    thresh = torch.sort(mag, descending=True, stable=True).values[k - 1]
    above = mag > thresh
    ties = mag == thresh
    budget = k - above.sum()
    keep_ties = ties & (torch.cumsum(ties.to(torch.int32), 0) <= budget)
    return torch.where(above | keep_ties, flat, torch.zeros_like(flat)).reshape(x.shape)


def topk_sparsify(tree, keep_fraction: float = 0.01):
    """Zero all but the top ``keep_fraction`` entries (by magnitude) of
    every floating leaf."""
    return tree_map(lambda x: _topk_leaf(x, keep_fraction), tree)
