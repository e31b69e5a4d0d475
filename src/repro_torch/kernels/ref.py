"""Plain PyTorch oracles for the stencil kernels and sliding-window
attention.

Independent implementations (no code shared with ``core.lowering`` or the
kernels) used by the allclose test sweeps.  Ports of ``repro.kernels.ref``.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.core.fd import laplacian_star


def star_stencil_ref(x, coeffs: Dict[Tuple[int, ...], float], halo: Tuple[int, ...]):
    """Weighted sum of shifted reads.

    ``x`` is halo-inclusive; the output is the core (x minus ``halo`` on
    both sides per dim).  Out-of-core values come from the halo content —
    boundary semantics live in whoever filled the halo.
    """
    core = tuple(s - 2 * h for s, h in zip(x.shape, halo))
    out = torch.zeros(core, dtype=x.dtype, device=x.device)
    for off, c in coeffs.items():
        idx = tuple(
            slice(h + o, h + o + n) for h, o, n in zip(halo, off, core)
        )
        out = out + torch.tensor(c, dtype=x.dtype, device=x.device) * x[idx]
    return out


def heat_step_ref(u, alpha: float, order: int, halo: int):
    """u_core + alpha * laplacian(u) — Jacobi-like heat-diffusion update."""
    rank = u.ndim
    lap = star_stencil_ref(u, laplacian_star(rank, order), (halo,) * rank)
    core = tuple(slice(halo, s - halo) for s in u.shape)
    return u[core] + torch.tensor(alpha, dtype=u.dtype, device=u.device) * lap


def wave_step_ref(u_t, u_tm1, c2dt2: float, order: int, halo: int):
    """2nd-order-in-time acoustic update:
    u_{t+1} = 2 u_t - u_{t-1} + c²dt² ∇²u_t."""
    rank = u_t.ndim
    lap = star_stencil_ref(u_t, laplacian_star(rank, order), (halo,) * rank)
    core = tuple(slice(halo, s - halo) for s in u_t.shape)
    c = torch.tensor(c2dt2, dtype=u_t.dtype, device=u_t.device)
    return 2.0 * u_t[core] - u_tm1[core] + c * lap


def sliding_window_attention_ref(q, k, v, window: int, causal: bool = True):
    """O(S²) oracle of sliding-window attention by explicit masking of
    full attention (small shapes).

    q,k,v: [heads, seq, dim] (kv may have fewer heads — GQA broadcast).
    Token i attends to [i-window+1, i] (causal sliding window)."""
    hq, s, d = q.shape
    hk = k.shape[0]
    rep = hq // hk
    k = torch.repeat_interleave(k, rep, dim=0)
    v = torch.repeat_interleave(v, rep, dim=0)
    scores = torch.einsum("hsd,htd->hst", q, k) / math.sqrt(d)
    i = torch.arange(s, device=q.device)[:, None]
    j = torch.arange(s, device=q.device)[None, :]
    mask = (j > i) if causal else torch.zeros((s, s), dtype=torch.bool, device=q.device)
    mask = mask | (j <= i - window)
    scores = torch.where(mask[None], -torch.inf, scores)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("hst,htd->hsd", p, v)
