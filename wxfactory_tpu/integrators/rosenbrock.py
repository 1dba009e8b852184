"""Ros2: second-order Rosenbrock integrator.

Solves (I - dt/2 J) Q^{n+1} = (I - dt/2 J) Q^n + dt f(Q^n) with FGMRES,
matching the reference's integrators/ros2.py. The rational-form operator
uses an exact jvp Jacobian action.
"""

from functools import partial
from time import time
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from ..solvers import fgmres
from .base import Integrator, SolverInfo, apply_rhs, as_pytree


@jax.jit
def _rat_apply(rhs, q, v, half_dt):
    jv = jax.jvp(rhs, (q,), (v.reshape(q.shape),))[1].ravel()
    return v - half_dt * jv


class Ros2(Integrator):
    def __init__(
        self,
        rhs: Callable,
        tolerance: float = 1e-7,
        gmres_restart: int = 30,
        linear_solver: str = "auto",
        rhs32: Callable = None,
        **kwargs,
    ) -> None:
        """`linear_solver`: "fgmres" (host-orchestrated 1-sync), "fgmres_jit"
        (whole solve as ONE device program, solvers/fgmres_jit.py),
        "fgmres_jit_1s" (same, with the 1-collective-per-iteration
        norm-estimate orthogonalization — the multi-host operating point),
        "gcrot" (recycled-subspace GCROT(m,k), solvers/gcrot.py — reference
        ros2.py:40 offers the same pair), or "auto" (fgmres_jit when no —
        generally untraceable — preconditioner is set).

        ``rhs32``: optional float32 companion RHS (ideally the
        perturbation-form operator, models/*.py perturbation_base). On the
        device path the INNER FGMRES Arnoldi then runs the f32 rational
        matvec on an f32 basis while every outer residual/update keeps the
        exact f64 operator (restarted iterative refinement — see
        solvers/fgmres_jit.py)."""
        super().__init__(**kwargs)
        # The RHS (and its constants) is an argument of every jitted program.
        self.rhs = as_pytree(rhs)
        self._rhs32_d = as_pytree(getattr(rhs32, "xla", rhs32))
        self.tol = tolerance
        self.gmres_restart = gmres_restart
        self.linear_solver = linear_solver
        self._rat_apply = partial(_rat_apply, self.rhs)
        self._rhs = partial(apply_rhs, self.rhs)
        self._dev_step = None

    def _get_dev_step(self, flat: bool):
        """Build (once per layout) the jitted whole-step program: RHS, b
        assembly, and the full restarted FGMRES solve of (I - dt/2 J) x = b.

        Vector layout: RAVELED on a single device (the state's small
        trailing dim would give the basis algebra a narrow, padded minor
        axis), the NATURAL state shape on a multi-device mesh
        (a 1D view of a sharded state has no representable sharding, so
        ravel would force an all-to-all relayout every iteration;
        fgmres_jit is shape-agnostic either way)."""
        if self._dev_step is None:
            self._dev_step = {}
        if flat not in self._dev_step:
            from ..solvers.fgmres_jit import fgmres_jit

            tol, restart = self.tol, self.gmres_restart
            max_outer = max(1, 20000 // restart)  # same budget as the host path
            one_sync = self.linear_solver == "fgmres_jit_1s"
            shp = (lambda a, q: a.reshape(q.shape)) if flat else (lambda a, q: a)
            vv = (lambda a: a.ravel()) if flat else (lambda a: a)

            @jax.jit
            def dev_step(rhs, rhs32, q, dt):
                half_dt = 0.5 * dt

                def A(v):
                    jv = jax.jvp(rhs, (q,), (shp(v, q),))[1]
                    return v - half_dt * vv(jv)

                if rhs32 is None:
                    A32 = None
                    basis_dtype = None
                else:
                    q32 = q.astype(jnp.float32)
                    hdt32 = half_dt.astype(jnp.float32)

                    def A32(v):
                        jv = jax.jvp(rhs32, (q32,), (shp(v, q).astype(jnp.float32),))[1]
                        return v - hdt32 * vv(jv)

                    basis_dtype = jnp.float32

                qv = vv(q)
                b = A(qv) + vv(rhs(q)) * dt
                x, info = fgmres_jit(A, b, x0=qv, tol=tol, restart=restart,
                                     max_outer=max_outer, one_sync=one_sync,
                                     A32=A32, basis_dtype=basis_dtype)
                # One small array -> one device->host transfer for ALL the
                # solver info.
                info_arr = jnp.stack([
                    info.converged.astype(jnp.float64),
                    info.num_iter.astype(jnp.float64),
                    info.norm_r.astype(jnp.float64),
                    info.norm_b.astype(jnp.float64),
                ])
                return shp(x, q), info_arr

            self._dev_step[flat] = dev_step
        return self._dev_step[flat]

    def _step_device(self, q, dt: float):
        """One XLA program for the whole Ros2 step (see _get_dev_step)."""
        from .epi import _single_device

        q_new, info = self._get_dev_step(_single_device(q))(
            self.rhs, self._rhs32_d, q, jnp.asarray(dt, q.dtype))
        ia = np.asarray(info)
        converged = bool(ia[0])
        self.solver_info = SolverInfo(total_num_it=int(ia[1]), converged=converged)
        self.failure_flag = 0 if converged else -1
        if self.verbose > 0:
            print(f"FGMRES(jit) {'convergence' if converged else 'stagnation'} "
                  f"at iteration {int(ia[1])}, relative residual "
                  f"{ia[2] / ia[3]:.2e}", flush=True)
        return q_new

    def _use_jit_solver(self) -> bool:
        return self.linear_solver in ("fgmres_jit", "fgmres_jit_1s") or (
            self.linear_solver == "auto" and self.preconditioner is None
        )

    def steps_device(self, q, dt: float, nsteps: int):
        """``nsteps`` Ros2 steps as ONE XLA program (lax.scan over the
        whole-step solve) — the same per-step dispatch amortization the EPI
        family gets from its steps_device. FGMRES carries no cross-step
        solver state (the warm start IS the incoming state), so the carry
        is just q; per-step info rows are summed for ``solver_info``."""
        if not self._use_jit_solver():
            return Integrator.steps_device(self, q, dt, nsteps)
        from .epi import _single_device

        flat = _single_device(q)
        inner = self._get_dev_step(flat)
        key = ("scan", flat)
        if key not in self._dev_step:

            @partial(jax.jit, static_argnums=(4,))
            def dev_steps(rhs, rhs32, q, dt, nsteps):
                def body(qc, _):
                    return inner(rhs, rhs32, qc, dt)

                return jax.lax.scan(body, q, None, length=nsteps)

            self._dev_step[key] = dev_steps

        t0 = time()
        q, infos = self._dev_step[key](self.rhs, self._rhs32_d, q, jnp.asarray(dt, q.dtype), nsteps)
        ia = np.asarray(infos)  # (nsteps, 4): converged, num_iter, norm_r, norm_b
        self.latest_time = time() - t0
        converged = bool(ia[:, 0].all())
        self.solver_info = SolverInfo(total_num_it=int(ia[:, 1].sum()), converged=converged)
        self.failure_flag = 0 if converged else -1
        self.sim_time += dt * nsteps
        self.num_completed_steps += nsteps
        if self.verbose > 0:
            print(f"FGMRES(jit) chunk of {nsteps}: {int(ia[:, 1].sum())} total iterations, "
                  f"last relative residual {ia[-1, 2] / ia[-1, 3]:.2e}", flush=True)
        return q

    def __step__(self, q, dt: float):
        if self._use_jit_solver():
            return self._step_device(q, dt)

        rhs_q = self._rhs(q)
        q_flat = np.asarray(q).ravel()

        def A(v):
            return np.asarray(self._rat_apply(q, jnp.asarray(v), 0.5 * dt))

        b = A(q_flat) + np.asarray(rhs_q).ravel() * dt

        maxiter = 20000 // self.gmres_restart
        if self.preconditioner is not None:
            maxiter = 400 // self.gmres_restart

        if self.linear_solver == "gcrot":
            from ..solvers import gcrot as _solve
        else:
            _solve = fgmres
        t0 = time()
        q_new, norm_r, norm_b, num_iter, flag, residuals = _solve(
            A,
            b,
            x0=q_flat,
            tol=self.tol,
            restart=self.gmres_restart,
            maxiter=maxiter,
            preconditioner=self.preconditioner,
            verbose=self.verbose,
        )
        t1 = time()
        self.solver_info = SolverInfo(total_num_it=num_iter, converged=(flag == 0), residuals=residuals)
        self.failure_flag = flag
        if self.verbose > 0:
            kind = "convergence" if flag == 0 else "stagnation"
            print(f"{_solve.__name__} {kind} at iteration {num_iter} in {t1-t0:4.3f} s, "
                  f"relative residual {norm_r/norm_b:.2e}", flush=True)

        return jnp.asarray(q_new).reshape(q.shape)
