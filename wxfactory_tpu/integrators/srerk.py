"""Stiffness-resilient exponential Runge-Kutta (SRERK) integrators.

Capability parity with the reference's integrators/srerk.py (Srerk): stage
nodes from the minimal-error-term polynomial roots (opt_nodes), per-stage
nonlinear-remainder projections with alpha coefficients, and the same
adaptive Krylov phi solvers (KIOPS/PMEX) underneath.

Design: one jitted jvp program supplies every Jacobian action; the
per-stage RHS evaluations reuse the jitted RHS.
"""

import math
from typing import Callable, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .. import solvers as _solvers
from ..solvers import kiops, pmex
from .base import Integrator, SolverInfo
from .epi import alpha_coeff


def opt_nodes(order: int) -> List[np.ndarray]:
    """Projection nodes with minimal error terms (reference srerk.py:29-46)."""
    if order < 3:
        raise ValueError("SRERK order must be at least 3")

    def coeff(p, q):
        return (-1) ** (p + q) * math.factorial(p + q + 2) / (
            math.factorial(q) * math.factorial(q + 2) * math.factorial(p - q)
        )

    nodes = []
    for o in list(range(2, order - 2, 2)) + [order - 2]:
        poly = np.polynomial.Polynomial([coeff(o, q) for q in range(o + 1)])
        nodes.append(np.real_if_close(poly.roots()))
    nodes.append(np.ones(1))
    return nodes


class Srerk(Integrator):
    def __init__(
        self,
        rhs: Callable,
        order: int = 3,
        nodes: Optional[List] = None,
        tolerance: float = 1e-7,
        exponential_solver: str = "kiops",
        krylov_size: int = 1,
        mmin: int = 16,
        mmax: int = 64,
        jtv: Optional[Callable] = None,
        **kwargs,
    ) -> None:
        """With `nodes` given, uses them directly and ignores `order`.
        `jtv(v, dt, q, rhs_q)` optionally supplies a custom Jacobian action
        (the reference's Srerk_others)."""
        super().__init__(**kwargs)
        self.rhs = rhs
        self.jtv = jtv
        self.tol = tolerance
        self.exponential_solver = exponential_solver
        self.krylov_size = krylov_size
        self.mmin = mmin
        self.mmax = mmax

        self.c = nodes if nodes else opt_nodes(order)
        self.n_proj = len(self.c)
        self.alpha = [alpha_coeff(self.c[i]) for i in range(self.n_proj - 1)]

        @jax.jit
        def _jvp(q, v, scale):
            return scale * jax.jvp(rhs, (q,), (v.reshape(q.shape),))[1].ravel()

        self._jvp = _jvp

        @jax.jit
        def _rhs(q):
            return rhs(q)

        self._rhs = _rhs

    def _solve_phi(self, tau_out, matvec, vec):
        name = self.exponential_solver
        if name == "kiops":
            solver = kiops
        elif name in ("pmex", "pmex_ne"):
            solver = pmex
        elif hasattr(_solvers, name):
            solver = getattr(_solvers, name)
        else:
            raise ValueError(f"Unrecognized exponential solver {self.exponential_solver}")
        z, stats = solver(tau_out, matvec, vec, tol=self.tol, m_init=self.krylov_size,
                          mmin=self.mmin, mmax=self.mmax)
        self.krylov_size = max(1, math.floor(0.7 * stats.last_krylov_size + 0.3 * self.krylov_size))
        if self.solver_info is None:
            self.solver_info = SolverInfo()
        self.solver_info.total_num_it += stats.krylov_steps
        self.solver_info.num_substeps += stats.substeps
        self.solver_info.num_rejected += stats.rejected
        return z

    def __step__(self, q, dt: float):
        rhs_q = self._rhs(q)
        f_flat = np.asarray(rhs_q).ravel()
        n = f_flat.size

        if self.jtv is not None:
            def matvec(v):
                return np.asarray(self.jtv(v, dt, q, rhs_q)).ravel()
        else:
            def matvec(v):
                return np.asarray(self._jvp(q, jnp.asarray(v), dt))

        vec = np.zeros((2, n))
        vec[1, :] = f_flat
        z = self._solve_phi(self.c[0], matvec, vec)

        for i_proj in range(1, self.n_proj):
            # Stage states at the previous projection's nodes.
            z = np.asarray(z)
            stages = [q + dt * jnp.asarray(z[i]).reshape(q.shape) for i in range(z.shape[0])]

            # Nonlinear remainders R(z_i) = f(z_i) - f(q) - J (z_i - q).
            rz = np.empty((len(stages), n))
            for i, zi in enumerate(stages):
                j_dz = np.asarray(self._jvp(q, (zi - q).ravel(), 1.0))
                rz[i, :] = np.asarray(self._rhs(zi) - rhs_q).ravel() - j_dz

            vec = np.zeros((len(stages) + 3, n))
            vec[1, :] = f_flat
            vec[3:, :] = self.alpha[i_proj - 1] @ rz
            z = self._solve_phi(self.c[i_proj], matvec, vec)

        return q + dt * jnp.asarray(np.asarray(z)[-1]).reshape(q.shape)
