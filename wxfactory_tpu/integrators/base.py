"""Time-integrator base class.

Capability parity with the reference's integrators/integrator.py:18-113:
the `step` template tracks wall time, convergence info, and optional
preconditioner preparation; concrete schemes implement `__step__`.

Design difference: concrete integrators are encouraged to expose their
entire step as one jittable function (`self._step`), so a whole timestep
(RHS evaluations + Krylov loops included) compiles to a single XLA program.
"""

from abc import ABC, abstractmethod
from dataclasses import dataclass, field
from time import time
from typing import Any, Callable, List, Optional

import jax
from jax.tree_util import Partial


def as_pytree(fn: Optional[Callable]) -> Optional[Partial]:
    """``fn`` as a value a jitted program can take as an ARGUMENT. The
    models build their RHS as a ``jax.tree_util.Partial`` that carries its
    constants as leaves, which the program then receives as parameters
    instead of embedding them as literals. Any other callable (a user's
    own RHS) is wrapped with no leaves: its closure stays embedded."""
    if fn is None or isinstance(fn, Partial):
        return fn
    return Partial(fn)


@jax.jit
def apply_rhs(rhs, q):
    """``rhs(q)`` as one program that takes the RHS as an argument."""
    return rhs(q)


@dataclass
class SolverInfo:
    """Per-step convergence / cost report from the inner solver."""

    total_num_it: int = 0
    num_substeps: int = 0
    num_rejected: int = 0
    error_estimate: float = 0.0
    converged: bool = True
    residuals: List[Any] = field(default_factory=list)


class Integrator(ABC):
    def __init__(self, verbose: int = 0, output_manager=None, preconditioner=None) -> None:
        self.verbose = verbose
        self.output_manager = output_manager
        self.preconditioner = preconditioner
        self.solver_info: Optional[SolverInfo] = None
        self.latest_time: float = 0.0
        self.sim_time: float = -1.0
        self.failure_flag: int = 0
        self.num_completed_steps: int = 0

    @abstractmethod
    def __step__(self, q, dt: float):
        ...

    def __prestep__(self, q, dt: float) -> None:
        pass

    def step(self, q, dt: float):
        """Advance the state one timestep, with timing + stats accounting."""
        t0 = time()
        self.__prestep__(q, dt)
        if self.preconditioner is not None:
            self.preconditioner.prepare(dt, q)
        self.solver_info = None  # concrete __step__ fills it (or leaves None)
        result = self.__step__(q, dt)
        self.latest_time = time() - t0
        self.sim_time += dt
        self.num_completed_steps += 1
        return result

    def steps_device(self, q, dt: float, nsteps: int):
        """Advance ``nsteps`` equal timesteps as few host round trips as the
        scheme allows. Base fallback: repeated single steps (semantics
        identical to calling `step` in a loop; `solver_info` reflects the
        last step). Device-resident schemes override this with ONE XLA
        program per chunk (Epi/kiops_jit and Ros2/fgmres_jit: lax.scan over
        the whole step), which is the production fast path the
        `device_step_chunk` config knob selects (simulation.py)."""
        for _ in range(nsteps):
            q = self.step(q, dt)
        return q
