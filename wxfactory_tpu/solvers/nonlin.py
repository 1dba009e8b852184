"""Jacobian-free Newton-Krylov nonlinear solver.

Capability parity with the reference's solvers/nonlin.py:12-218 (scipy-style
newton_krylov with an FGMRES inner solve, Armijo line search, and
Eisenstat-Walker forcing). Design difference: the Jacobian action is an
exact jax.jvp of the residual function instead of a finite-difference
directional derivative.
"""

from time import time
from typing import Callable, Optional

import jax
import numpy as np
from scipy.optimize._linesearch import scalar_search_armijo

from .fgmres import fgmres


def newton_krylov(
    F: Callable,
    x0,
    f_tol: Optional[float] = None,
    f_rtol: float = np.inf,
    x_tol: float = np.inf,
    x_rtol: float = np.inf,
    fgmres_restart: int = 30,
    fgmres_maxiter: int = 1,
    fgmres_precond: Optional[Callable] = None,
    line_search: Optional[str] = "armijo",
    maxiter: Optional[int] = None,
    verbose: bool = False,
):
    """Solve F(x) = 0. Returns (x, num_iterations, residual_history).

    `F` must be jax-traceable (it is linearized with jvp each Newton step).
    """
    t_start = time()
    shape = np.shape(x0)

    if f_tol is None:
        f_tol = float(np.finfo(np.float64).eps ** (1.0 / 3.0))
    if maxiter is None:
        maxiter = 100 * (int(np.prod(shape)) + 1)

    @jax.jit
    def _fx(x_in):
        return F(x_in.reshape(shape)).ravel()

    @jax.jit
    def _jvp(x_in, v):
        return jax.jvp(lambda z: F(z.reshape(shape)).ravel(), (x_in,), (v,))[1]

    x = np.asarray(x0, dtype=np.float64).ravel()
    fx = np.asarray(_fx(x))
    fx_norm = float(np.linalg.norm(fx))

    # Eisenstat-Walker forcing parameters
    gamma, eta_max, eta_threshold = 0.9, 0.9999, 0.1
    eta = 1e-3

    residuals = []
    f0_norm = None
    dx_inf = np.inf
    iteration = 0

    for _ in range(maxiter):
        iteration += 1
        f_inf = float(np.max(np.abs(fx)))
        x_inf = float(np.max(np.abs(x)))
        residuals.append((f_inf, time() - t_start, 0.0))
        if f0_norm is None:
            f0_norm = f_inf

        if f_inf == 0.0 or (
            f_inf <= f_tol and f_inf / f_rtol <= f0_norm and dx_inf <= x_tol and dx_inf / x_rtol <= x_inf
        ):
            break

        # Inexact Newton: solve J dx = -F to the forcing tolerance.
        tol = min(eta, eta * fx_norm)
        x_frozen = x.copy()
        sol, *_ = fgmres(
            lambda v: np.asarray(_jvp(x_frozen, v)),
            fx,
            tol=tol,
            restart=fgmres_restart,
            maxiter=fgmres_maxiter,
            preconditioner=fgmres_precond,
        )
        dx = -sol
        dx_inf = float(np.max(np.abs(dx)))

        if line_search == "armijo":
            x, fx, fx_norm_new = _armijo_step(_fx, x, fx, dx)
        else:
            x = x + dx
            fx = np.asarray(_fx(x))
            fx_norm_new = float(np.linalg.norm(fx))

        # Eisenstat-Walker update of the forcing term
        eta_a = gamma * fx_norm_new**2 / fx_norm**2 if fx_norm > 0 else eta_max
        if gamma * eta**2 < eta_threshold:
            eta = min(eta_max, eta_a)
        else:
            eta = min(eta_max, max(eta_a, gamma * eta**2))
        fx_norm = fx_norm_new

        if verbose:
            print(f"newton_krylov {iteration:3d}: |F|_inf = {float(np.max(np.abs(fx))):.3e}", flush=True)
    else:
        print("newton_krylov: maximum iterations reached", flush=True)

    return x.reshape(shape), iteration, residuals


def _armijo_step(fx_fun, x, fx, dx):
    """Armijo backtracking on phi(s) = |F(x + s*dx)|^2."""
    cache = {}

    def phi(s):
        if s in cache:
            return cache[s]
        val = np.asarray(fx_fun(x + s * dx))
        norm2 = float(val @ val)
        cache[s] = norm2
        cache[(s, "v")] = val
        return norm2

    phi0 = float(fx @ fx)
    s, _ = scalar_search_armijo(phi, phi0, -phi0, amin=1e-2)
    if s is None:
        s = 1.0
        phi(s)
    fx_new = cache.get((s, "v"))
    if fx_new is None:
        fx_new = np.asarray(fx_fun(x + s * dx))
    return x + s * dx, fx_new, float(np.linalg.norm(fx_new))
