"""Exponential Propagation Iterative (EPI) integrators.

Multistep exponential integrators of orders 2-6 (Epi) and their
stiffness-resilient variants (EpiStiff, orders 3+), driven by an adaptive
Krylov phi-function solver (KIOPS or PMEX). Capability parity with the
reference's integrators/epi.py and epi_stiff.py, including the fixed
A-coefficient tables, the Epi2 self-bootstrap of multistep history, and the
Krylov-size warm start.

Design: the Jacobian action is an exact jitted jvp of the RHS (one
program, reused for the history residuals and every Krylov iteration).
"""

import math
from collections import deque
from functools import partial
from itertools import combinations
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .. import solvers as _solvers
from ..solvers import kiops, pmex
from .base import Integrator, SolverInfo, apply_rhs, as_pytree


def _single_device(q) -> bool:
    """True when q lives on one device (flat Krylov vectors are the faster
    layout there); False on a multi-device mesh (keep the state shape so
    dots stay fused all-reduces without relayouts)."""
    sharding = getattr(q, "sharding", None)
    return sharding is None or len(sharding.device_set) <= 1


@jax.jit
def _jvp_scaled(rhs, q, v, scale):
    return scale * jax.jvp(rhs, (q,), (v.reshape(q.shape),))[1].ravel()


def alpha_coeff(c) -> np.ndarray:
    """Coefficients of stiffness-resilient exponential methods from node
    values c (reference integrator.py:135-146)."""
    m = len(c)
    alpha = np.zeros((m, m))
    for i in range(m):
        c_no_i = [cc for (j, cc) in enumerate(c) if j != i]
        denom = c[i] ** 2 * math.prod([c[i] - cl for cl in c_no_i])
        for k in range(m):
            sp = sum(math.prod(v) for v in combinations(c_no_i, m - k - 1))
            alpha[k, i] = (-1) ** (m - k + 1) * math.factorial(k + 2) * sp / denom
    return alpha


# Fixed EPI multistep coefficient tables (Tokman et al.); rows = phi order - 2
_EPI_A = {
    2: np.zeros((0, 0)),
    3: np.array([[2 / 3]]),
    4: np.array([[-3 / 10, 3 / 40], [32 / 5, -11 / 10]]),
    5: np.array([[-4 / 5, 2 / 5, -4 / 45], [12, -9 / 2, 8 / 9], [3, 0, -1 / 3]]),
    6: np.array(
        [
            [-49 / 60, 351 / 560, -359 / 1260, 367 / 6720],
            [92 / 7, -99 / 14, 176 / 63, -1 / 2],
            [485 / 21, -151 / 14, 23 / 9, -31 / 168],
        ]
    ),
}


class Epi(Integrator):
    def __init__(
        self,
        rhs: Callable,
        order: int = 2,
        tolerance: float = 1e-7,
        exponential_solver: str = "kiops",
        krylov_size: int = 1,
        mmin: int = 16,
        mmax: int = 64,
        init_method: Optional[Integrator] = None,
        init_substeps: int = 1,
        jtv: Optional[Callable] = None,
        rhs32: Optional[Callable] = None,
        **kwargs,
    ) -> None:
        """`jtv(v, dt, q, rhs_q)` optionally supplies a custom Jacobian action
        (the reference's Epi_others, integrators/epi_for_others.py, takes a
        user JTV for the stiff-PDE lab); default is the exact jvp of `rhs`.

        ``rhs32``: optional float32 companion RHS (a perturbation-form
        operator, ``make_rhs_*(..., perturbation_base=q0)``; its ``.xla``
        absolute form, when present, is what the matvec differentiates)
        enabling
        MIXED-PRECISION exponential stepping with the device-resident solver:
        the KIOPS Arnoldi matvec (the hot loop, one RHS jvp per Krylov
        iteration — reference solvers/kiops.py:152-338) runs in f32 while the
        outer residuals, the Krylov basis/H and the adaptivity controller
        stay f64; the Krylov recurrence tolerates the f32 operator like any
        inexact-Krylov method."""
        super().__init__(**kwargs)
        self.rhs = as_pytree(rhs)
        self.rhs32 = rhs32
        # What the mixed-precision matvec differentiates (see above).
        self._rhs32_d = as_pytree(getattr(rhs32, "xla", rhs32))
        self.jtv = jtv
        self.tol = tolerance
        self.exponential_solver = exponential_solver
        self.krylov_size = krylov_size
        self.mmin = mmin
        self.mmax = mmax

        if order not in _EPI_A:
            raise ValueError(f"Unsupported order {order} for EPI method")
        self.A = _EPI_A[order]
        k = self.A.shape[0] if order > 2 else 0
        self.n_prev = self.A.shape[1] if self.A.size else 0
        self.max_phi = k + 1
        self.previous_q: deque = deque()
        self.previous_rhs: deque = deque()
        self.dt = 0.0

        if init_method is not None or self.n_prev == 0:
            self.init_method = init_method
        else:
            # The bootstrap sub-integrator gets the same f32 companion so
            # mixed precision applies from the very first (sub)step too.
            self.init_method = Epi(rhs, 2, tolerance, exponential_solver, krylov_size, mmin, mmax,
                                   rhs32=rhs32)
        self.init_substeps = init_substeps

        # One jitted program for every Jacobian action this integrator
        # needs; the RHS (and its constants) is an argument of each program.
        self._jvp = partial(_jvp_scaled, self.rhs)
        self._rhs = partial(apply_rhs, self.rhs)
        self._dev_step = None  # built lazily for exponential_solver="kiops_jit"
        self._phi_offset = 2  # vec row of the first history residual

    def _build_dev_step(self, flat: bool):
        """ONE jitted program for the whole EPI step: RHS, history-residual
        jvps, vec assembly, the full device-resident KIOPS evaluation
        (solvers/kiops_jit.py) and the state update. The host path pays one
        device dispatch per Krylov iteration; this pays one per STEP.

        ``flat``: run the Krylov algebra on RAVELED vectors — the right
        layout on a single device, where the state's small trailing dim
        (s^3 <= 128) would otherwise give the basis ops a narrow, padded
        minor axis. On a MULTI-DEVICE mesh the natural state shape is used
        instead: a 1D view of a mesh-sharded state has no representable
        sharding, so ravel/reshape would force an all-to-all relayout every
        iteration (kiops_jit is shape-agnostic either way)."""
        from ..solvers.kiops_jit import kiops_jit

        A_tbl = jnp.asarray(self.A) if self.A.size else None
        n_prev, max_phi, offset = self.n_prev, self.max_phi, self._phi_offset
        tol, mmin, mmax = self.tol, self.mmin, self.mmax
        shp = (lambda a, q: a.reshape(q.shape)) if flat else (lambda a, q: a)
        vv = (lambda a: a.ravel()) if flat else (lambda a: a)

        @jax.jit
        def dev_step(rhs, rhs32, q, prev_q, prev_rhs, dt, m0):
            rhs_q = rhs(q)

            def jvp(v):
                return vv(jax.jvp(rhs, (q,), (shp(v, q),))[1])

            if rhs32 is None:
                kry_jvp = jvp
            else:
                # The matvec keeps everything in f32: with basis_dtype=f32
                # below, kiops_jit hands it f32 vectors and stores the basis
                # in f32, so no casts appear in the hot loop.
                q32 = q.astype(jnp.float32)

                def kry_jvp(v):
                    return vv(jax.jvp(rhs32, (q32,), (shp(v, q).astype(jnp.float32),))[1])

            fq = vv(rhs_q)
            rows = [jnp.zeros_like(fq), fq] + [jnp.zeros_like(fq) for _ in range(max_phi - 1)]
            for i in range(n_prev):
                dq = vv(prev_q[i] - q)
                r = vv(prev_rhs[i] - rhs_q) - jvp(dq)
                for k in range(A_tbl.shape[0]):
                    rows[k + offset] = rows[k + offset] + A_tbl[k, i] * r
            vec = jnp.stack(rows)

            mixed = rhs32 is not None
            dt_m = dt.astype(jnp.float32) if mixed else dt
            w, stats = kiops_jit(
                lambda v: dt_m * kry_jvp(v), vec, tau_end=1.0, tol=tol,
                m_init=m0, mmin=mmin, mmax=mmax,
                # Inexact (f32) operators require a fully orthogonal basis;
                # see kiops_jit's full_ortho docstring. The basis itself
                # also lives in f32 (see kiops_jit's basis_dtype docstring);
                # H/controller/expm stay f64.
                full_ortho=mixed,
                basis_dtype=jnp.float32 if mixed else None,
            )
            # Pack the stats into ONE small array: each separate scalar
            # fetch is a full device->host round trip, and the host reads
            # five of them per step.
            stats_arr = jnp.stack([
                stats.krylov_steps.astype(jnp.float64),
                stats.substeps.astype(jnp.float64),
                stats.rejected.astype(jnp.float64),
                stats.error_estimate.astype(jnp.float64),
                stats.last_krylov_size.astype(jnp.float64),
            ])
            return q + shp(w, q) * dt, rhs_q, stats_arr

        return dev_step

    def steps_device(self, q, dt: float, nsteps: int):
        """Run ``nsteps`` device-resident EPI steps as ONE XLA program
        (lax.scan): the per-step dispatch + stats round trip amortizes to
        once per CHUNK, and the
        Krylov-size warm start stays on device (m_init is a traced carry).
        The multistep history (n_prev > 0) rides the scan carry, so every
        EPI order is supported once the history is primed; order 2 needs no
        priming. Aggregate stats land in ``solver_info``."""
        if self.exponential_solver != "kiops_jit" or self.jtv is not None:
            for _ in range(nsteps):
                q = self.step(q, dt)
            return q
        while len(self.previous_q) < self.n_prev:
            q = self.step(q, dt)  # bootstrap history with single steps
            nsteps -= 1
            if nsteps == 0:
                return q
        flat = _single_device(q)
        key = ("scan", flat)
        if self._dev_step is None:
            self._dev_step = {}
        if key not in self._dev_step:
            inner = self._build_dev_step(flat)

            @partial(jax.jit, static_argnums=(7,))
            def dev_steps(rhs, rhs32, q, prev_q, prev_rhs, dt, m0, nsteps):
                def body(carry, _):
                    q, prev_q, prev_rhs, m = carry
                    q_new, rhs_q, stats = inner(rhs, rhs32, q, prev_q, prev_rhs, dt, m)
                    m_new = jnp.maximum(
                        1, jnp.floor(0.7 * stats[4] + 0.3 * m.astype(jnp.float64))
                    ).astype(jnp.int32)
                    if self.n_prev > 0:
                        prev_q = jnp.concatenate([q[None], prev_q[:-1]], axis=0)
                        prev_rhs = jnp.concatenate([rhs_q[None], prev_rhs[:-1]], axis=0)
                    return (q_new, prev_q, prev_rhs, m_new), stats

                (q, prev_q, prev_rhs, m), stats = jax.lax.scan(
                    body, (q, prev_q, prev_rhs, m0), None, length=nsteps
                )
                return q, prev_q, prev_rhs, m, stats.sum(axis=0), stats[-1]

            self._dev_step[key] = dev_steps

        shape = ((self.n_prev,) + q.shape) if self.n_prev else (0,) + q.shape
        prev_q = jnp.stack(list(self.previous_q)) if self.n_prev else jnp.zeros(shape, q.dtype)
        prev_rhs = jnp.stack(list(self.previous_rhs)) if self.n_prev else jnp.zeros(shape, q.dtype)
        q, prev_q, prev_rhs, m, tot, last = self._dev_step[key](
            self.rhs, self._rhs32_d, q, prev_q, prev_rhs, jnp.asarray(dt, q.dtype),
            jnp.int32(self.krylov_size), nsteps
        )
        sa, la = np.asarray(tot), np.asarray(last)
        self.krylov_size = max(1, int(m))
        self.solver_info = SolverInfo(
            total_num_it=int(sa[0]), num_substeps=int(sa[1]),
            num_rejected=int(sa[2]), error_estimate=float(la[3]),
        )
        if self.n_prev > 0:
            self.previous_q = deque(list(prev_q))
            self.previous_rhs = deque(list(prev_rhs))
        self.dt = dt
        self.sim_time += dt * nsteps
        self.num_completed_steps += nsteps
        return q

    def _step_device(self, q, dt: float):
        """Device-resident step (exponential_solver="kiops_jit")."""
        flat = _single_device(q)
        if self._dev_step is None:
            self._dev_step = {}
        if flat not in self._dev_step:
            self._dev_step[flat] = self._build_dev_step(flat)
        shape = ((self.n_prev,) + q.shape) if self.n_prev else (0,) + q.shape
        prev_q = jnp.stack(list(self.previous_q)) if self.n_prev else jnp.zeros(shape, q.dtype)
        prev_rhs = jnp.stack(list(self.previous_rhs)) if self.n_prev else jnp.zeros(shape, q.dtype)
        q_new, rhs_q, stats = self._dev_step[flat](
            self.rhs, self._rhs32_d, q, prev_q, prev_rhs, jnp.asarray(dt, q.dtype), int(self.krylov_size)
        )
        sa = np.asarray(stats)  # one transfer for all five stats
        ksteps = int(sa[0])
        self.krylov_size = max(1, math.floor(0.7 * int(sa[4]) + 0.3 * self.krylov_size))
        self.solver_info = SolverInfo(
            total_num_it=ksteps,
            num_substeps=int(sa[1]),
            num_rejected=int(sa[2]),
            error_estimate=float(sa[3]),
        )
        if self.n_prev > 0:
            self.previous_q.pop()
            self.previous_q.appendleft(q)
            self.previous_rhs.pop()
            self.previous_rhs.appendleft(rhs_q)
        return q_new

    def _solve_phi(self, matvec, vec):
        # The reference caps the Krylov size at 64 (epi.py:325-336): the
        # incomplete (IOP-2) orthogonalization silently degrades for large m,
        # so tau-substepping with modest m is both faster and stable.
        name = self.exponential_solver
        if name in ("pmex", "pmex_ne"):
            solver = pmex
        elif name == "kiops":
            solver = kiops
        elif name == "exode":
            from ..solvers.exode import exode as _ex

            phiv, stats = _ex(1.0, matvec, vec, method=getattr(self, "exode_method", "BS3(2)"),
                              controller=getattr(self, "exode_controller", ""), atol=self.tol)
            self.solver_info = SolverInfo(total_num_it=stats.krylov_steps)
            return phiv
        elif hasattr(_solvers, name):
            solver = getattr(_solvers, name)
        else:
            raise ValueError(f"Unrecognized exponential solver {self.exponential_solver}")
        phiv, stats = solver([1.0], matvec, vec, tol=self.tol, m_init=self.krylov_size,
                             mmin=self.mmin, mmax=self.mmax)
        self.krylov_size = max(1, math.floor(0.7 * stats.last_krylov_size + 0.3 * self.krylov_size))
        if self.verbose > 0:
            print(
                f"{self.exponential_solver} converged at iteration {stats.krylov_steps} "
                f"({stats.substeps} substeps, {stats.rejected} rejected) "
                f"local error {stats.error_estimate:.2e}",
                flush=True,
            )
        self.solver_info = SolverInfo(total_num_it=stats.krylov_steps,
                                      num_substeps=stats.substeps,
                                      num_rejected=stats.rejected,
                                      error_estimate=stats.error_estimate)
        return phiv

    def __step__(self, q, dt: float):
        # Multistep history is only valid at constant dt.
        if self.dt and abs(self.dt - dt) > 1e-10:
            self.previous_q.clear()
            self.previous_rhs.clear()
        self.dt = dt

        if len(self.previous_q) < self.n_prev:
            # Bootstrap history with the (lower-order) init method.
            self.previous_q.appendleft(q)
            self.previous_rhs.appendleft(self._rhs(q))
            sub_dt = dt / self.init_substeps
            for _ in range(self.init_substeps):
                q = self.init_method.step(q, sub_dt)
            return q

        if self.exponential_solver == "kiops_jit" and self.jtv is None:
            return self._step_device(q, dt)

        rhs_q = self._rhs(q)

        if self.jtv is not None:
            def matvec(v):
                return np.asarray(self.jtv(v, dt, q, rhs_q)).ravel()
        else:
            def matvec(v):
                return np.asarray(self._jvp(q, jnp.asarray(v), dt))

        n = rhs_q.size
        vec = np.zeros((self.max_phi + 1, n))
        vec[1, :] = np.asarray(rhs_q).ravel()
        for i in range(self.n_prev):
            dq = self.previous_q[i] - q
            j_dq = self._jvp(q, dq.ravel(), 1.0)
            r = np.asarray((self.previous_rhs[i] - rhs_q).ravel() - j_dq)
            for k, alpha in enumerate(self.A[:, i], start=2):
                vec[k, :] += alpha * r

        phiv = self._solve_phi(matvec, vec)

        if self.n_prev > 0:
            self.previous_q.pop()
            self.previous_q.appendleft(q)
            self.previous_rhs.pop()
            self.previous_rhs.appendleft(rhs_q)

        return q + jnp.asarray(phiv[0]).reshape(q.shape) * dt


class EpiStiff(Epi):
    """Stiffness-resilient EPI: alpha coefficients from the integer nodes
    -1, -2, ..., contributions starting at phi_3 (reference epi_stiff.py)."""

    def __init__(self, rhs: Callable, order: int = 3, **kwargs) -> None:
        if order < 3:
            raise ValueError("EpiStiff requires order >= 3")
        super().__init__(rhs, 2, **kwargs)  # base init; then override tables
        self.A = alpha_coeff([-i for i in range(-1, 1 - order, -1)])
        self.n_prev = self.A.shape[1]
        self.max_phi = order if order > 2 else 1
        self._phi_offset = 3  # EpiStiff residuals start at phi_3
        self._dev_step = None
        self.init_method = Epi(rhs, 2, self.tol, self.exponential_solver, self.krylov_size,
                               self.mmin, self.mmax, rhs32=self.rhs32)

    def __step__(self, q, dt: float):
        if self.dt and abs(self.dt - dt) > 1e-10:
            self.previous_q.clear()
            self.previous_rhs.clear()
        self.dt = dt

        if len(self.previous_q) < self.n_prev:
            self.previous_q.appendleft(q)
            self.previous_rhs.appendleft(self._rhs(q))
            sub_dt = dt / self.init_substeps
            for _ in range(self.init_substeps):
                q = self.init_method.step(q, sub_dt)
            return q

        if self.exponential_solver == "kiops_jit" and self.jtv is None:
            return self._step_device(q, dt)

        rhs_q = self._rhs(q)

        if self.jtv is not None:
            def matvec(v):
                return np.asarray(self.jtv(v, dt, q, rhs_q)).ravel()
        else:
            def matvec(v):
                return np.asarray(self._jvp(q, jnp.asarray(v), dt))

        n = rhs_q.size
        vec = np.zeros((self.max_phi + 1, n))
        vec[1, :] = np.asarray(rhs_q).ravel()
        for i in range(self.n_prev):
            dq = self.previous_q[i] - q
            j_dq = self._jvp(q, dq.ravel(), 1.0)
            r = np.asarray((self.previous_rhs[i] - rhs_q).ravel() - j_dq)
            for k, alpha in enumerate(self.A[:, i]):
                vec[k + 3, :] += alpha * r

        phiv = self._solve_phi(matvec, vec)

        self.previous_q.pop()
        self.previous_q.appendleft(q)
        self.previous_rhs.pop()
        self.previous_rhs.appendleft(rhs_q)

        return q + jnp.asarray(phiv[0]).reshape(q.shape) * dt
