"""Plain PyTorch oracles for the stencil kernels.

Independent implementations (no code shared with ``core.lowering`` or the
kernels) used by the allclose test sweeps.  Ports of ``repro.kernels.ref``.
"""
from __future__ import annotations

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
