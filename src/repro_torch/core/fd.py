# Copied from src/repro/core/fd.py with repro. renamed to repro_torch.; keep its logic in step with that file.
"""Finite-difference coefficient tables (central differences on uniform
grids) — shared by the Devito-like frontend and the kernel library.

``second_derivative(order)`` returns ``(offsets, coeffs)`` for d²/dx² with
the given *space discretization order* (SDO ∈ {2, 4, 8} in the paper's
evaluation, radius = order/2), normalized to unit grid spacing.
"""
from __future__ import annotations

from fractions import Fraction


_D2_COEFFS = {
    2: [1, -2, 1],
    4: [Fraction(-1, 12), Fraction(4, 3), Fraction(-5, 2), Fraction(4, 3), Fraction(-1, 12)],
    6: [
        Fraction(1, 90), Fraction(-3, 20), Fraction(3, 2), Fraction(-49, 18),
        Fraction(3, 2), Fraction(-3, 20), Fraction(1, 90),
    ],
    8: [
        Fraction(-1, 560), Fraction(8, 315), Fraction(-1, 5), Fraction(8, 5),
        Fraction(-205, 72), Fraction(8, 5), Fraction(-1, 5), Fraction(8, 315),
        Fraction(-1, 560),
    ],
}

_D1_COEFFS = {
    2: [Fraction(-1, 2), 0, Fraction(1, 2)],
    4: [Fraction(1, 12), Fraction(-2, 3), 0, Fraction(2, 3), Fraction(-1, 12)],
}


def second_derivative(order: int, spacing: float = 1.0):
    """(offsets, coeffs) for d²/dx², offsets in [-order/2, order/2]."""
    if order not in _D2_COEFFS:
        raise ValueError(f"unsupported space order {order} (have {sorted(_D2_COEFFS)})")
    c = _D2_COEFFS[order]
    r = order // 2
    offsets = list(range(-r, r + 1))
    coeffs = [float(x) / spacing**2 for x in c]
    return offsets, coeffs


def first_derivative(order: int, spacing: float = 1.0):
    if order not in _D1_COEFFS:
        raise ValueError(f"unsupported space order {order} (have {sorted(_D1_COEFFS)})")
    c = _D1_COEFFS[order]
    r = order // 2
    offsets = list(range(-r, r + 1))
    coeffs = [float(x) / spacing for x in c]
    return offsets, coeffs


def laplacian_star(ndim: int, order: int, spacing: float = 1.0) -> dict:
    """Star-stencil {offset_tuple: coeff} for the n-D Laplacian."""
    offsets, coeffs = second_derivative(order, spacing)
    star: dict[tuple, float] = {}
    for d in range(ndim):
        for o, c in zip(offsets, coeffs):
            key = tuple(o if k == d else 0 for k in range(ndim))
            star[key] = star.get(key, 0.0) + c
    return star


def radius(order: int) -> int:
    return order // 2
