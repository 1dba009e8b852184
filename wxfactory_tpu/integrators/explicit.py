"""Explicit time integrators (forward Euler, TVD-RK3).

Capability parity with the reference's integrators/euler1.py and tvdrk3.py.
Each step is a single jitted function that takes the RHS as an argument.
"""

from functools import partial
from typing import Callable

import jax

from .base import Integrator, SolverInfo, as_pytree


@jax.jit
def _euler1_step(rhs, q, dt):
    return q + rhs(q) * dt


@jax.jit
def _tvdrk3_step(rhs, q, dt):
    q1 = q + rhs(q) * dt
    q2 = 0.75 * q + 0.25 * q1 + 0.25 * rhs(q1) * dt
    return q / 3.0 + 2.0 / 3.0 * q2 + 2.0 / 3.0 * rhs(q2) * dt


class Euler1(Integrator):
    """First-order forward Euler."""

    def __init__(self, rhs: Callable, **kwargs) -> None:
        super().__init__(**kwargs)
        self.rhs = as_pytree(rhs)
        self._step = partial(_euler1_step, self.rhs)

    def __step__(self, q, dt):
        return self._step(q, dt)


class Tvdrk3(Integrator):
    """3rd-order total-variation-diminishing Runge-Kutta (Shu-Osher)."""

    def __init__(self, rhs: Callable, **kwargs) -> None:
        super().__init__(**kwargs)
        self.rhs = as_pytree(rhs)
        self._step = partial(_tvdrk3_step, self.rhs)

    def __step__(self, q, dt):
        self.solver_info = SolverInfo(total_num_it=1)
        return self._step(q, dt)
