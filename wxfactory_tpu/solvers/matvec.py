"""Matrix-free Jacobian-action operators.

The reference approximates J(Q)·v with a complex-step or finite-difference
RHS evaluation (solvers/matvec.py:36-88 there) — which is why its whole C++
kernel stack is templated on complex<double>. Here we use exact
forward-mode AD (`jax.jvp`), which is cheaper than complex arithmetic, exact
to machine precision, and removes the need for complex kernels entirely.
An FD variant is kept as a parity/debug mode.
"""

from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np


def make_jvp_matvec(rhs: Callable, q, dt: float = 1.0) -> Callable:
    """Return ``v -> dt * J(q)·v`` using exact forward-mode AD.

    The returned callable takes/returns flat vectors (any leading reshape of
    q) and is backed by a single jitted jvp program.
    """
    shape = q.shape

    @jax.jit
    def _apply(q_in, v, scale):
        _, tangent = jax.jvp(rhs, (q_in,), (v.reshape(shape),))
        return scale * tangent.ravel()

    def matvec(v):
        return _apply(q, jnp.asarray(v), dt)

    return matvec


def make_fd_matvec(rhs: Callable, q, rhs_q, dt: float = 1.0) -> Callable:
    """Finite-difference Jacobian action (parity/debug mode, matches the
    reference's method='fd': eps = sqrt(float32 eps))."""
    shape = q.shape
    epsilon = float(np.sqrt(np.finfo(np.float32).eps))

    @jax.jit
    def _apply(q_in, rq, v, scale):
        qvec = q_in + epsilon * v.reshape(shape)
        return scale * ((rhs(qvec) - rq) / epsilon).ravel()

    def matvec(v):
        return _apply(q, rhs_q, jnp.asarray(v), dt)

    return matvec


def make_rat_matvec(rhs: Callable, q, dt: float) -> Callable:
    """Return ``v -> v - dt/2 * J(q)·v``, the system operator of the Ros2 /
    Crank-Nicolson rational form (reference solvers/matvec.py:76-88)."""
    shape = q.shape

    @jax.jit
    def _apply(q_in, v, half_dt):
        _, tangent = jax.jvp(rhs, (q_in,), (v.reshape(shape),))
        return v - half_dt * tangent.ravel()

    def matvec(v):
        return _apply(q, jnp.asarray(v), 0.5 * dt)

    return matvec
