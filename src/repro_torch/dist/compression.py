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


def _int8_leaf(x, whole_max=None):
    if not isinstance(x, torch.Tensor) or not x.is_floating_point() or x.ndim == 0:
        return x
    scale = (x.abs().max() if whole_max is None else whole_max) / 127.0
    # all-zero leaf: keep scale finite so dequantization returns zeros
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(x / safe), -127, 127).to(torch.int8)
    return (q.to(x.dtype) * safe).to(x.dtype)


def _whole_max(x, spec, mesh):
    """``max |x|`` over the whole leaf of which ``x`` is placed blocks
    (``dist.sharding.place``): the blocks' maxima, then a pmax over the
    mesh axes ``spec`` shards the leaf on (exact: a max rounds nothing)."""
    from repro_torch.dist.sharding import _spec_axes, pmax

    L = len(mesh.axis_names)
    axes = tuple(a for a in mesh.axis_names if a in _spec_axes(spec) and mesh.shape[a] > 1)
    if mesh.processes:
        m = x.abs().amax().reshape((1,) * L)
    else:  # [*lead, *block]: one max a distinct block, spread over the mesh dims
        m = x.abs().amax(dim=tuple(range(L, x.ndim))).expand(tuple(mesh.shape.values()))
    return pmax(m, axes, mesh).reshape(-1)[0]


def int8_roundtrip(tree, specs=None, mesh=None):
    """Quantize every floating leaf to int8 and back (symmetric, per-leaf
    scale).  |out - in| ≤ max|in| / 127 · (1/2 rounding + clip slack).
    With ``specs`` and ``mesh`` the leaves are placed blocks, and each
    block is quantized with its whole leaf's scale (:func:`_whole_max`):
    the blocks of the flat leaf's quantization."""
    if mesh is None:
        return tree_map(_int8_leaf, tree)
    if isinstance(tree, dict):
        return {k: int8_roundtrip(v, specs[k], mesh) for k, v in tree.items()}
    if not isinstance(tree, torch.Tensor) or not tree.is_floating_point() or tree.ndim == 0:
        return tree
    return _int8_leaf(tree, _whole_max(tree, specs, mesh))


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
