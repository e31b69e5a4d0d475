"""Star-stencil operations on kernel K1 — the stable public surface (port of
``repro.kernels.ops``).

Each op takes halo-inclusive inputs and returns the core, mirroring the
post-swap calling convention of the lowering (halos are filled by
dmp/comm upstream).  The tensor's device decides the route: CUDA tensors
launch the kernel, CPU tensors run its plain version.
"""
from __future__ import annotations

from typing import Dict, Tuple

from repro_torch.core import ir
from repro_torch.core.builder import build_apply
from repro_torch.core.dialects import stencil
from repro_torch.core.fd import laplacian_star, radius
from repro_torch.kernels.stencil_apply import run_apply_cuda


def star_apply_ir(coeffs: Dict[Tuple[int, ...], float], core: tuple, halo: tuple):
    """A one-operand apply computing the weighted-star sum over ``core``,
    and the bounds of its halo-grown operand."""
    func = ir.FuncOp("star", [])
    operand_bounds = stencil.Bounds(
        tuple(-h for h in halo), tuple(c + h for c, h in zip(core, halo))
    )
    # fabricate a block argument typed as the halo-grown temp
    holder = ir.Block([stencil.TempType(operand_bounds)])
    rb = stencil.Bounds.from_shape(core)

    def body(b, u):
        acc = None
        for off, c in sorted(coeffs.items()):
            term = u.at(*off) * float(c)
            acc = term if acc is None else acc + term
        return acc

    apply_op = build_apply(func.body, [holder.args[0]], rb, body)
    return apply_op, operand_bounds


def star_stencil(x, coeffs: Dict[Tuple[int, ...], float], halo: Tuple[int, ...]):
    """Apply a star/box stencil with static coefficients through K1."""
    core = tuple(s - 2 * h for s, h in zip(x.shape, halo))
    apply_op, ob = star_apply_ir(coeffs, core, halo)
    rb = stencil.Bounds.from_shape(core)
    (out,) = run_apply_cuda(apply_op, [x], [ob.lb], rb)
    return out


def laplacian(x, order: int = 2, halo: int = None):  # type: ignore[assignment]
    h = halo if halo is not None else radius(order)
    return star_stencil(x, laplacian_star(x.ndim, order), (h,) * x.ndim)


def heat_step(u, alpha: float, order: int = 2):
    """Fused u + alpha∇²u (one kernel, one pass over device memory)."""
    h = radius(order)
    star = {k: alpha * v for k, v in laplacian_star(u.ndim, order).items()}
    center = tuple([0] * u.ndim)
    star[center] = star.get(center, 0.0) + 1.0
    return star_stencil(u, star, (h,) * u.ndim)


def wave_step(u_t, u_tm1_core, c2dt2: float, order: int = 2):
    """2 u_t - u_{t-1} + c²dt² ∇²u_t; u_t halo-inclusive, u_{t-1} core."""
    h = radius(order)
    star = {k: c2dt2 * v for k, v in laplacian_star(u_t.ndim, order).items()}
    center = tuple([0] * u_t.ndim)
    star[center] = star.get(center, 0.0) + 2.0
    lap2u = star_stencil(u_t, star, (h,) * u_t.ndim)
    return lap2u - u_tm1_core
