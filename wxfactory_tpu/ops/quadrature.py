"""Gauss-Legendre quadrature nodes and weights (host-side, high precision).

Capability parity with the reference's ``wx_factory/geometry/quadrature.py``
(gauss_legendre): nodes are computed at 34 significant digits so the
downstream Lagrange-derivative operator matrices are accurate to the last
float64 ulp, which the reference requires for its skew-centrosymmetry check.
The nodes come from Newton's iteration on the Legendre recurrence in
``decimal`` arithmetic; only the standard library and numpy are needed.

All of this runs once at setup on the host; the resulting float64 matrices
become compile-time constants of the jitted RHS.
"""

import math
from decimal import Decimal, localcontext
from functools import lru_cache
from typing import List, Tuple

import numpy as np

N_DIGITS = 34  # ~quadruple precision, same as the reference
_GUARD = 12  # extra working digits for the Newton iteration


def legendre_with_derivative(n: int, x):
    """``(P_n(x), P_n'(x))`` by the three-term recurrence, in the arithmetic
    of ``x`` (Decimal or Fraction). Valid for ``x != +-1``."""
    p_prev, p = 1, x
    for k in range(2, n + 1):
        p_prev, p = p, ((2 * k - 1) * x * p - (k - 1) * p_prev) / k
    return p, n * (x * p - p_prev) / (x * x - 1)


@lru_cache(maxsize=None)
def gauss_legendre_decimal(n: int) -> Tuple[Tuple[Decimal, ...], Tuple[Decimal, ...]]:
    """Gauss-Legendre nodes (ascending, rounded to N_DIGITS significant
    digits) and weights on [-1, 1] as Decimals.

    Nodes are the roots of P_n; weights w_i = 2 / ((1 - x_i^2) P_n'(x_i)^2).
    The node set is built symmetric: the positive roots are iterated and
    mirrored, and the middle node of an odd rule is exactly 0.
    """
    positive = []
    with localcontext() as ctx:
        ctx.prec = N_DIGITS + _GUARD
        tol = Decimal(10) ** -(N_DIGITS + _GUARD - 2)
        for i in range(n // 2):
            x = Decimal(math.cos(math.pi * (i + 0.75) / (n + 0.5)))
            for _ in range(100):
                p, dp = legendre_with_derivative(n, x)
                step = p / dp
                x -= step
                if abs(step) < tol:
                    break
            else:
                raise RuntimeError(f"Newton iteration for the Gauss-Legendre nodes (n={n}) did not converge")
            positive.append(x)
    with localcontext() as ctx:
        ctx.prec = N_DIGITS
        positive = [+x for x in positive]  # round to N_DIGITS significant digits
    middle = [Decimal(0)] if n % 2 else []
    nodes = tuple([-x for x in positive] + middle + positive[::-1])
    with localcontext() as ctx:
        ctx.prec = N_DIGITS + _GUARD
        weights = []
        for x in nodes:
            _, dp = legendre_with_derivative(n, x)
            weights.append(2 / ((1 - x * x) * dp * dp))
    return nodes, tuple(weights)


def gauss_legendre(n: int) -> Tuple[List[Decimal], np.ndarray, np.ndarray]:
    """Gauss-Legendre quadrature points (high precision + float64) and weights.

    Returns ``(points_hp, points, weights)`` with points sorted ascending;
    ``points_hp`` are the N_DIGITS-digit Decimal nodes.
    """
    if n < 1:
        raise ValueError(f"Invalid number of quadrature points: {n}")
    nodes, weights = gauss_legendre_decimal(n)
    points = np.array([float(x) for x in nodes], dtype=np.float64)
    weights_num = np.array([float(w) for w in weights], dtype=np.float64)
    return list(nodes), points, weights_num
