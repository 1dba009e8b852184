"""Stiff 2D finite-difference PDE laboratory.

Capability parity with the reference's wx_factory/stiff_pdes/ (JTV.py +
rhs_jac_pdefuncs.py + initWorld.py): the four benchmark problems used for
the low-synchronization Krylov scaling studies —

  1. Allen-Cahn:      u_t = eps * lap(u) + u - u^3              (Neumann)
  2. Adv-Diff-React:  u_t = eps * lap(u) - alpha * adv(u)
                            + gamma * u (u - 1/2)(1 - u)         (Neumann)
  3. Porous medium:   u_t = lap(u^2) + alpha * adv(u)            (periodic)
  4. Burgers:         u_t = eps * lap(u) - alpha * (u^2/2)_adv   (Dirichlet)

Design: the reference hand-rolls per-point loops with MPI halo
Send/Recv per direction (JTV.py, 1363 LoC); here each operator is a
padded-stencil jnp expression on the full (N, N) grid — one fused XLA
kernel, distributed by sharding the grid axes. The Jacobian action needs
no hand-written JTV functions at all: it is the exact jvp of the jittable
RHS. Boundary treatments mirror the reference (one-sided 2/3-4/3 Neumann
closures, zero Dirichlet ghosts, periodic wrap).
"""

import math
from typing import Callable, Tuple

import jax.numpy as jnp
import numpy as np


def _pad_dirichlet(u):
    return jnp.pad(u, 1, mode="constant")


def _pad_periodic(u):
    return jnp.pad(u, 1, mode="wrap")


def laplacian_dirichlet(u, eps, dx):
    v = _pad_dirichlet(u)
    return eps / dx**2 * (v[:-2, 1:-1] + v[2:, 1:-1] + v[1:-1, :-2] + v[1:-1, 2:] - 4.0 * u)


def laplacian_periodic(u, eps, dx):
    v = _pad_periodic(u)
    return eps / dx**2 * (v[:-2, 1:-1] + v[2:, 1:-1] + v[1:-1, :-2] + v[1:-1, 2:] - 4.0 * u)


def laplacian_neumann(u, eps, dx):
    """Interior 5-point stencil; at the domain edges the missing-neighbor
    contribution is replaced by the reference's one-sided closure
    2/3*inner + 4/3*self (JTV.py:373-430)."""
    v = jnp.pad(u, 1, mode="constant")
    lap = v[:-2, 1:-1] + v[2:, 1:-1] + v[1:-1, :-2] + v[1:-1, 2:] - 4.0 * u
    # The zero ghost from the pad means the interior-neighbor term at each
    # edge is present but the outside one is 0; swap in the closure by
    # replacing (inner) with (2/3 inner + 4/3 self).
    lap = lap.at[0, :].add(-(1.0 / 3.0) * u[1, :] + (4.0 / 3.0) * u[0, :])
    lap = lap.at[-1, :].add(-(1.0 / 3.0) * u[-2, :] + (4.0 / 3.0) * u[-1, :])
    lap = lap.at[:, 0].add(-(1.0 / 3.0) * u[:, 1] + (4.0 / 3.0) * u[:, 0])
    lap = lap.at[:, -1].add(-(1.0 / 3.0) * u[:, -2] + (4.0 / 3.0) * u[:, -1])
    return eps / dx**2 * lap


def advection_neumann(u, alpha, dx):
    """Centered differences in both directions, one-sided 4/3 closures at the
    domain edges (JTV.py:772-860)."""
    v = jnp.pad(u, 1, mode="constant")
    ddx = v[1:-1, 2:] - v[1:-1, :-2]
    ddy = v[2:, 1:-1] - v[:-2, 1:-1]
    ddx = ddx.at[:, 0].set((4.0 / 3.0) * (u[:, 1] - u[:, 0]))
    ddx = ddx.at[:, -1].set((4.0 / 3.0) * (u[:, -1] - u[:, -2]))
    ddy = ddy.at[0, :].set((4.0 / 3.0) * (u[1, :] - u[0, :]))
    ddy = ddy.at[-1, :].set((4.0 / 3.0) * (u[-1, :] - u[-2, :]))
    return alpha * (ddx + ddy) / (2.0 * dx)


def advection_periodic(u, alpha, dx):
    v = _pad_periodic(u)
    return alpha * ((v[1:-1, 2:] - v[1:-1, :-2]) + (v[2:, 1:-1] - v[:-2, 1:-1])) / (2.0 * dx)


def advection_usquared_dirichlet(u, dx):
    """(u^2/2)_x + (u^2/2)_y with zero Dirichlet ghosts (JTV.py:958)."""
    v = _pad_dirichlet(0.5 * u * u)
    return ((v[1:-1, 2:] - v[1:-1, :-2]) + (v[2:, 1:-1] - v[:-2, 1:-1])) / (2.0 * dx)


def _grid(num_points: int, domain: Tuple[float, float], interior: bool):
    lo, hi = domain
    dx = (hi - lo) / (num_points - 1)
    if interior:
        x = lo + dx * (1 + np.arange(num_points - 2))
    else:
        x = lo + dx * np.arange(num_points)
    return x, dx


def initial_condition(num_points: int = 202, domain=(-1.0, 1.0), interior: bool = False) -> np.ndarray:
    """The benchmark's standard IC: 0.1 + 0.1 cos(2 pi x) cos(2 pi y)
    (reference tests/lowsync_benchmark/main_ac.py:43-48)."""
    x, _ = _grid(num_points, domain, interior)
    xx, yy = np.meshgrid(x, x, indexing="ij")
    return 0.1 + 0.1 * np.cos(2.0 * math.pi * xx) * np.cos(2.0 * math.pi * yy)


def _dx(num_points, domain):
    return (domain[1] - domain[0]) / (num_points - 1)


def make_allen_cahn(num_points: int = 202, domain=(-1.0, 1.0), eps: float = 0.1) -> Callable:
    dx = _dx(num_points, domain)

    def rhs(u):
        return laplacian_neumann(u, eps, dx) + u - u**3

    return rhs


def make_adr(num_points: int = 202, domain=(-1.0, 1.0), eps: float = 1e-2,
             alpha: float = -10.0, gamma: float = 100.0) -> Callable:
    dx = _dx(num_points, domain)

    def rhs(u):
        return (
            laplacian_neumann(u, eps, dx)
            - advection_neumann(u, alpha, dx)
            + gamma * u * (u - 0.5) * (1.0 - u)
        )

    return rhs


def make_porous_medium(num_points: int = 202, domain=(-1.0, 1.0), alpha: float = 1.0) -> Callable:
    dx = _dx(num_points, domain)

    def rhs(u):
        return laplacian_periodic(u * u, 1.0, dx) + advection_periodic(u, alpha, dx)

    return rhs


def make_burgers(num_points: int = 202, domain=(-1.0, 1.0), eps: float = 1e-3, alpha: float = 1.0) -> Callable:
    dx = _dx(num_points, domain)

    def rhs(u):
        return laplacian_dirichlet(u, eps, dx) - alpha * advection_usquared_dirichlet(u, dx)

    return rhs
