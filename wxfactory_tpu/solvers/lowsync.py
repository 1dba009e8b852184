"""Low-synchronization Krylov phi-function solvers.

Capability parity with the reference's low-sync zoo — pmex_1s, pmex_ne1s,
cwy_1s/ne/ne1s, icwy_1s/ne/ne1s/neiop, dcgs2, kiops_nest (solvers/*.py
there, ~350-410 LoC each). The reference duplicates the adaptive
substepping outer loop per variant; here ONE engine hosts pluggable
orthogonalization schemes (CWY / ICWY / DCGS2) crossed with the three
DISTINCT synchronization structures of the family — each a different way
to reach ONE global reduction per Arnoldi iteration:

  * ``ne``   — norm ESTIMATE: normalize the new vector immediately with the
               Pythagorean estimate ||v - Vh||^2 = ||v||^2 - ||h||^2 read
               off the same fused Gram product, with an exact-norm fallback
               reduction under cancellation (reference icwy_ne.py).
  * ``1s``   — LAGGED exact normalization: leave the new vector
               unnormalized; its true norm arrives in the NEXT iteration's
               fused product (the matvec is linear, so both rows rescale),
               and H[j-1, j-2] is written one iteration late (reference
               icwy_1s.py:150-233). One extra reduction normalizes the
               final basis vector after the loop.
  * ``ne1s`` — both: normalize NOW with the estimate (keeps vectors at
               unit scale for conditioning), then rescale with the true
               norm when it arrives next iteration (reference
               icwy_ne1s.py:165-245).

plus ``neiop`` — the norm estimate over an incomplete-orthogonalization
window (iop=2), the reference's icwy_neiop.py / kiops_nest.py structure.

On a device mesh the "1 sync" property translates to a single fused collective per
Krylov iteration under GSPMD — the Gram product is one matmul + psum. The
module counts its global reductions (NUM_REDUCTIONS) so tests can assert
the per-iteration budget of each variant.

CWY vs ICWY: the T-matrix correction differs —
  T[j,:j] = -gram^T @ T  (compact WY, reference cwy_ne.py:204-207)
  T[j,:j] = -gram        (inverse compact WY / Neumann, icwy_ne.py:175-181)
"""

import math
from typing import Callable, Sequence, Tuple

import numpy as np
import scipy.linalg

from .stats import PhiStats

# Global-reduction accounting: every site that would be an allreduce in the
# reference (or a psum under GSPMD) bumps this. Tests assert the budget.
NUM_REDUCTIONS = 0


def _count(k: int = 1) -> None:
    global NUM_REDUCTIONS
    NUM_REDUCTIONS += k


def _pythagoras(own_sq: float, coeffs: np.ndarray) -> float:
    """Norm estimate of the orthogonalized vector from the fused Gram data;
    returns -1.0 when cancellation invalidates it (caller falls back to an
    exact norm — the same trade the reference's *_ne solvers make)."""
    sum_sqrd = float(np.sum(np.array(coeffs, np.longdouble) ** 2))
    if own_sq >= sum_sqrd:
        return float(np.sqrt(np.longdouble(own_sq) - sum_sqrd))
    return -1.0


def lowsync_phi(
    tau_out: Sequence[float],
    A: Callable,
    u: np.ndarray,
    scheme: str = "icwy",
    mode: str = "ne",
    iop: int = 2,
    tol: float = 1e-7,
    m_init: int = 10,
    mmin: int = 10,
    mmax: int = 64,
    task1: bool = False,
) -> Tuple[np.ndarray, PhiStats]:
    """Adaptive phi-combination evaluation with a low-sync orthogonalizer.

    ``scheme``: "cwy" | "icwy" | "dcgs2"; ``mode``: "ne" | "1s" | "ne1s" |
    "neiop" (icwy window variant). Same outer loop as kiops/pmex (tau
    substepping + Krylov-size adaptivity); see those modules for the
    controller details.
    """
    if scheme == "dcgs2":
        mode = "dcgs2"
    u = np.asarray(u, dtype=np.float64)
    tau_out = np.asarray(tau_out, dtype=np.float64)
    ppo, n = u.shape
    p = ppo - 1
    if p == 0:
        p = 1
        u = np.vstack((u, np.zeros((1, n))))

    m = max(mmin, min(m_init, mmax))
    V = np.zeros((mmax + 1, n + p))
    H = np.zeros((mmax + 1, mmax + 1))
    T = np.eye(mmax + 1)

    stats = PhiStats()
    sgn = float(np.sign(tau_out[-1]))
    tau_now, tau_end = 0.0, float(abs(tau_out[-1]))
    happy = False
    j = 0
    num_steps = len(tau_out)
    w = np.zeros((num_steps, n))
    w[0, :] = u[0, :]

    norm_u = float(np.max(np.sum(np.abs(u[1:, :]), axis=1)))
    if ppo > 1 and norm_u > 0:
        ex = math.ceil(math.log2(norm_u))
        nu, mu = 2.0**-ex, 2.0**ex
    else:
        nu, mu = 1.0, 1.0
    u_flip = nu * np.flipud(u[1:, :])

    tau = tau_end
    gamma, gamma_mmax = (0.2, 0.1) if tau_end > 1 else (0.9, 0.6)
    delta = 1.4

    oldm, oldtau, omega = -1, math.nan, math.nan
    order_old = kest_old = True
    order, kest = 1.0, 2.0
    ireject = 0
    l = 0
    beta = 0.0
    lagged = mode in ("1s", "ne1s")
    prev_normalized = False  # lag modes: is V[j] normalized with its TRUE norm?
    reached_mmax = False  # skip final normalization after hitting mmax
    prev_nrm_est = 1.0  # ne1s: the estimate used to scale the previous vector

    def exact_norm(row) -> float:
        _count()
        return math.sqrt(float(row @ row))

    def t_update(gram_col0, jj):
        """Loss-of-orthogonality correction row of T from the fused Gram
        column (projections of v_{jj-1} on the older basis rows)."""
        if jj > 1:
            if scheme == "cwy":
                T[jj - 1, : jj - 1] = -gram_col0[: jj - 1].T @ T[: jj - 1, : jj - 1]
            else:
                T[jj - 1, : jj - 1] = -gram_col0[: jj - 1]

    while tau_now < tau_end:
        if j == 0:
            H[:, :] = 0.0
            T[:, :] = np.eye(mmax + 1)
            V[0, :n] = w[l, :]
            for k in range(p - 1):
                i = p - k + 1
                V[0, n + k] = (tau_now**i) / math.factorial(i) * mu
            V[0, n + p - 1] = mu
            if not lagged:
                beta = exact_norm(V[0, :])
                V[0, :] /= beta
            prev_normalized = False

        while j < m:
            j += 1
            V[j, :n] = np.asarray(A(V[j - 1, :n])) + V[j - 1, n : n + p] @ u_flip
            V[j, n : n + p - 1] = V[j - 1, n + 1 : n + p]
            V[j, n + p - 1] = 0.0

            if mode == "neiop":
                # Windowed (incomplete) orthogonalization + norm estimate
                # (reference icwy_neiop.py:160-210 / kiops_nest.py).
                ilow = max(0, j - iop)
                gram = V[ilow : j + 1, :] @ V[j - 1 : j + 1, :].T
                _count()
                jw = j - ilow  # row of v_{j-1} within the window
                # ICWY correction restricted to the window.
                if j > 1:
                    Tw = np.eye(jw)
                    Tw[jw - 1, : jw - 1] = -gram[: jw - 1, 0]
                    coeffs = Tw @ gram[:jw, 1]
                else:
                    coeffs = gram[:jw, 1].copy()
                V[j, :] -= coeffs @ V[ilow:j, :]
                nrm = _pythagoras(gram[jw, 1], coeffs)
                if nrm < 0.0:
                    nrm = exact_norm(V[j, :])
                if nrm < tol:
                    happy = True
                    break
                H[ilow:j, j - 1] = coeffs
                H[j, j - 1] = nrm
                V[j, :] /= nrm
                stats.krylov_steps += 1
                continue

            if mode == "ne1s" and j > 1 and not prev_normalized:
                # Undo the estimate scaling -> raw vectors, so the fused
                # product below carries the TRUE previous norm
                # (reference icwy_ne1s.py:170-175).
                V[j - 1 : j + 1, :] *= prev_nrm_est

            # THE single fused reduction of the iteration.
            gram = V[: j + 1, :] @ V[j - 1 : j + 1, :].T  # (j+1, 2)
            _count()

            if lagged:
                nrm_prev = math.sqrt(max(gram[j - 1, 0], 0.0))
                if j == 1:
                    beta = nrm_prev
                if not prev_normalized:
                    # Rescale both rows (A is linear) and the Gram entries;
                    # quadratic entries get the factor twice
                    # (reference icwy_1s.py:190-199).
                    V[j - 1 : j + 1, :] /= nrm_prev
                    gram[:, 1] /= nrm_prev
                    gram[j - 1 : j + 1, 1] /= nrm_prev
                    gram[: j - 1, 0] /= nrm_prev
                    if j > 1:
                        H[j - 1, j - 2] = nrm_prev

            t_update(gram[:, 0], j)
            coeffs = T[:j, :j] @ gram[:j, 1]
            V[j, :] -= coeffs @ V[:j, :]

            if mode == "ne":
                nrm = _pythagoras(gram[j, 1], coeffs)
                if nrm < 0.0:
                    nrm = exact_norm(V[j, :])
                if nrm < tol:
                    happy = True
                    break
                H[:j, j - 1] = coeffs
                H[j, j - 1] = nrm
                V[j, :] /= nrm
            elif mode == "1s":
                # Happy check on the LAGGED (previous-vector) norm
                # (reference icwy_1s.py:210-213); the new vector stays
                # unnormalized until the next fused product.
                if j > 1 and H[j - 1, j - 2] < tol:
                    happy = True
                    break
                H[:j, j - 1] = coeffs
                prev_normalized = False
            else:  # ne1s
                H[:j, j - 1] = coeffs
                if j < m:
                    nrm = _pythagoras(gram[j, 1], coeffs)
                    if nrm < 0.0:
                        nrm = exact_norm(V[j, :])
                    if nrm < tol:
                        happy = True
                        break
                    V[j, :] /= nrm
                    prev_nrm_est = nrm
                prev_normalized = False

            stats.krylov_steps += 1

        if lagged and not reached_mmax and not happy:
            # Normalize the final basis vector exactly — the one extra
            # reduction of the lagged schemes (reference icwy_1s.py:223-233).
            final_nrm = exact_norm(V[j, :])
            V[j, :] /= final_nrm
            H[j, j - 1] = final_nrm
            prev_normalized = True

        H[0, j] = 1.0
        nrm = H[j, j - 1]
        H[j, j - 1] = 0.0
        F = scipy.linalg.expm(sgn * tau * H[: j + 1, : j + 1])
        stats.num_expm += 1
        H[j, j - 1] = nrm

        if happy:
            omega, err = 0.0, 0.0
            tau_new, m_new = min(tau_end - (tau_now + tau), tau), m
            happy = False
        else:
            err = abs(beta * nrm * F[j - 1, j])
            oldomega = omega
            omega = tau_end * err / (tau * tol)
            if not math.isfinite(omega):
                omega = 1e300

            if m == oldm and tau != oldtau and ireject >= 1 and oldomega > 0 and math.isfinite(oldomega):
                try:
                    order = max(1.0, math.log(omega / oldomega) / math.log(tau / oldtau))
                except (ValueError, ZeroDivisionError, OverflowError):
                    order = max(1.0, j / 4)
                order_old = False
            elif order_old or ireject == 0:
                order_old = True
                order = j / 4
            else:
                order_old = True
            if not math.isfinite(order) or order <= 0:
                order = max(1.0, j / 4)

            if m != oldm and tau == oldtau and ireject >= 1 and oldomega > 0 and math.isfinite(oldomega):
                try:
                    kest = max(1.1, (omega / oldomega) ** (1.0 / (oldm - m)))
                except (ValueError, ZeroDivisionError, OverflowError):
                    kest = 2.0
                kest_old = False
            elif kest_old or ireject == 0:
                kest_old = True
                kest = 2.0
            else:
                kest_old = True
            if not math.isfinite(kest) or kest <= 1.0:
                kest = 2.0

            remaining_time = tau_end - tau_now if omega > delta else tau_end - (tau_now + tau)
            same_tau = min(remaining_time, tau)
            tau_opt = tau * (gamma / omega) ** (1.0 / order)
            tau_opt = min(remaining_time, max(tau / 5, min(5 * tau, tau_opt)))
            try:
                m_opt = math.ceil(j + math.log(omega / gamma) / math.log(kest))
            except (ValueError, OverflowError):
                m_opt = j
            m_opt = max(mmin, min(mmax, max(math.floor(3 / 4 * m), min(m_opt, math.ceil(4 / 3 * m)))))

            if j == mmax:
                reached_mmax = True
                if omega > delta:
                    m_new = j
                    tau_new = tau * (gamma_mmax / omega) ** (1.0 / order)
                    tau_new = min(tau_end - tau_now, max(tau / 5, tau_new))
                else:
                    tau_new, m_new = tau_opt, m
            else:
                m_new, tau_new = m_opt, same_tau

        if omega <= delta:
            stats.rejected += ireject
            stats.substeps += 1
            blown = 0
            next_t = tau_now + tau
            for k in range(l, num_steps):
                if abs(tau_out[k]) < abs(next_t):
                    blown += 1
            if blown:
                w[l + blown, :] = w[l, :]
                for k in range(blown):
                    tau_phantom = tau_out[l + k] - tau_now
                    F2 = scipy.linalg.expm(sgn * tau_phantom * H[:j, :j])
                    w[l + k, :] = beta * F2[:j, 0] @ V[:j, :n]
                l += blown
            w[l, :] = beta * F[:j, 0] @ V[:j, :n]
            tau_now += tau
            j = 0
            ireject = 0
            reached_mmax = False
            prev_normalized = False
            stats.error_estimate += err
        else:
            ireject += 1
            H[0, j] = 0.0

        oldtau, tau = tau, tau_new
        oldm, m = m, m_new
        if tau <= 0.0 and tau_now < tau_end:
            tau = tau_end - tau_now

    if task1:
        for k in range(num_steps):
            w[k, :] /= tau_out[k]

    stats.last_krylov_size = m
    return w, stats


def _dcgs2_phi(tau_out, A, u, tol, m_init, mmin, mmax, task1):
    """Delayed classical Gram-Schmidt-2: two-pass CGS where the second pass
    of vector j rides the reduction of iteration j+1 (reference
    dcgs2.py:155-230) — one fused reduction per iteration at CGS2
    robustness. Kept as its own inner loop (the delayed second pass does
    not fit the T-matrix engine)."""
    return _dcgs2_impl(tau_out, A, u, tol, m_init, mmin, mmax, task1)


def _dcgs2_impl(tau_out, A, u, tol, m_init, mmin, mmax, task1):
    u = np.asarray(u, dtype=np.float64)
    tau_out = np.asarray(tau_out, dtype=np.float64)
    ppo, n = u.shape
    p = ppo - 1
    if p == 0:
        p = 1
        u = np.vstack((u, np.zeros((1, n))))

    m = max(mmin, min(m_init, mmax))
    V = np.zeros((mmax + 1, n + p))
    H = np.zeros((mmax + 1, mmax + 1))

    stats = PhiStats()
    sgn = float(np.sign(tau_out[-1]))
    tau_now, tau_end = 0.0, float(abs(tau_out[-1]))
    happy = False
    j = 0
    num_steps = len(tau_out)
    w = np.zeros((num_steps, n))
    w[0, :] = u[0, :]

    norm_u = float(np.max(np.sum(np.abs(u[1:, :]), axis=1)))
    if ppo > 1 and norm_u > 0:
        ex = math.ceil(math.log2(norm_u))
        nu, mu = 2.0**-ex, 2.0**ex
    else:
        nu, mu = 1.0, 1.0
    u_flip = nu * np.flipud(u[1:, :])

    tau = tau_end
    gamma, gamma_mmax = (0.2, 0.1) if tau_end > 1 else (0.9, 0.6)
    delta = 1.4

    oldm, oldtau, omega = -1, math.nan, math.nan
    order_old = kest_old = True
    order, kest = 1.0, 2.0
    ireject = 0
    l = 0
    beta = 0.0

    def exact_norm(row):
        _count()
        return math.sqrt(float(row @ row))

    while tau_now < tau_end:
        if j == 0:
            H[:, :] = 0.0
            V[0, :n] = w[l, :]
            for k in range(p - 1):
                i = p - k + 1
                V[0, n + k] = (tau_now**i) / math.factorial(i) * mu
            V[0, n + p - 1] = mu
            beta = exact_norm(V[0, :])
            V[0, :] /= beta

        while j < m:
            j += 1
            V[j, :n] = np.asarray(A(V[j - 1, :n])) + V[j - 1, n : n + p] @ u_flip
            V[j, n : n + p - 1] = V[j - 1, n + 1 : n + p]
            V[j, n + p - 1] = 0.0

            # One fused reduction: first-pass projections of v_j AND the
            # delayed second-pass corrections of v_{j-1}.
            gram = V[: j + 1, :] @ V[j - 1 : j + 1, :].T  # (j+1, 2)
            _count()

            coeffs = gram[:j, 1].copy()
            V[j, :] -= coeffs @ V[:j, :]
            if j > 1:
                corr = gram[: j - 1, 0]
                V[j - 1, :] -= corr @ V[: j - 1, :]
                H[: j - 1, j - 2] += corr
            nrm = exact_norm(V[j, :])
            if nrm < tol:
                happy = True
                break
            H[:j, j - 1] = coeffs
            H[j, j - 1] = nrm
            V[j, :] /= nrm
            stats.krylov_steps += 1

        H[0, j] = 1.0
        nrm = H[j, j - 1]
        H[j, j - 1] = 0.0
        F = scipy.linalg.expm(sgn * tau * H[: j + 1, : j + 1])
        stats.num_expm += 1
        H[j, j - 1] = nrm

        if happy:
            omega, err = 0.0, 0.0
            tau_new, m_new = min(tau_end - (tau_now + tau), tau), m
            happy = False
        else:
            err = abs(beta * nrm * F[j - 1, j])
            oldomega = omega
            omega = tau_end * err / (tau * tol)
            if not math.isfinite(omega):
                omega = 1e300

            if m == oldm and tau != oldtau and ireject >= 1 and oldomega > 0 and math.isfinite(oldomega):
                try:
                    order = max(1.0, math.log(omega / oldomega) / math.log(tau / oldtau))
                except (ValueError, ZeroDivisionError, OverflowError):
                    order = max(1.0, j / 4)
                order_old = False
            elif order_old or ireject == 0:
                order_old = True
                order = j / 4
            else:
                order_old = True
            if not math.isfinite(order) or order <= 0:
                order = max(1.0, j / 4)

            if m != oldm and tau == oldtau and ireject >= 1 and oldomega > 0 and math.isfinite(oldomega):
                try:
                    kest = max(1.1, (omega / oldomega) ** (1.0 / (oldm - m)))
                except (ValueError, ZeroDivisionError, OverflowError):
                    kest = 2.0
                kest_old = False
            elif kest_old or ireject == 0:
                kest_old = True
                kest = 2.0
            else:
                kest_old = True
            if not math.isfinite(kest) or kest <= 1.0:
                kest = 2.0

            remaining_time = tau_end - tau_now if omega > delta else tau_end - (tau_now + tau)
            same_tau = min(remaining_time, tau)
            tau_opt = tau * (gamma / omega) ** (1.0 / order)
            tau_opt = min(remaining_time, max(tau / 5, min(5 * tau, tau_opt)))
            try:
                m_opt = math.ceil(j + math.log(omega / gamma) / math.log(kest))
            except (ValueError, OverflowError):
                m_opt = j
            m_opt = max(mmin, min(mmax, max(math.floor(3 / 4 * m), min(m_opt, math.ceil(4 / 3 * m)))))

            if j == mmax:
                if omega > delta:
                    m_new = j
                    tau_new = tau * (gamma_mmax / omega) ** (1.0 / order)
                    tau_new = min(tau_end - tau_now, max(tau / 5, tau_new))
                else:
                    tau_new, m_new = tau_opt, m
            else:
                m_new, tau_new = m_opt, same_tau

        if omega <= delta:
            stats.rejected += ireject
            stats.substeps += 1
            blown = 0
            next_t = tau_now + tau
            for k in range(l, num_steps):
                if abs(tau_out[k]) < abs(next_t):
                    blown += 1
            if blown:
                w[l + blown, :] = w[l, :]
                for k in range(blown):
                    tau_phantom = tau_out[l + k] - tau_now
                    F2 = scipy.linalg.expm(sgn * tau_phantom * H[:j, :j])
                    w[l + k, :] = beta * F2[:j, 0] @ V[:j, :n]
                l += blown
            w[l, :] = beta * F[:j, 0] @ V[:j, :n]
            tau_now += tau
            j = 0
            ireject = 0
            stats.error_estimate += err
        else:
            ireject += 1
            H[0, j] = 0.0

        oldtau, tau = tau, tau_new
        oldm, m = m, m_new
        if tau <= 0.0 and tau_now < tau_end:
            tau = tau_end - tau_now

    if task1:
        for k in range(num_steps):
            w[k, :] /= tau_out[k]

    stats.last_krylov_size = m
    return w, stats


# --- Named variants matching the reference's solver registry -----------------


def _variant(scheme: str, mode: str):
    def solver(tau_out, A, u, tol=1e-7, m_init=10, mmin=10, mmax=64, task1=False, **kw):
        return lowsync_phi(tau_out, A, u, scheme=scheme, mode=mode,
                           tol=tol, m_init=m_init, mmin=mmin, mmax=mmax, task1=task1)

    return solver


cwy_1s = _variant("cwy", "1s")
cwy_ne = _variant("cwy", "ne")
cwy_ne1s = _variant("cwy", "ne1s")
icwy_1s = _variant("icwy", "1s")
icwy_ne = _variant("icwy", "ne")
icwy_ne1s = _variant("icwy", "ne1s")
icwy_neiop = _variant("icwy", "neiop")


def dcgs2(tau_out, A, u, tol=1e-7, m_init=10, mmin=10, mmax=64, task1=False, **kw):
    return _dcgs2_phi(tau_out, A, u, tol, m_init, mmin, mmax, task1)


def pmex_1s(tau_out, A, u, tol=1e-7, m_init=10, mmin=10, mmax=64, task1=False, **kw):
    from .pmex import pmex

    return pmex(tau_out, A, u, tol=tol, m_init=m_init, mmin=mmin, mmax=mmax, task1=task1)


pmex_ne1s = pmex_1s


def kiops_nest(tau_out, A, u, tol=1e-7, m_init=10, mmin=10, mmax=64, task1=False, **kw):
    """KIOPS with norm-estimate incomplete orthogonalization (reference
    solvers/kiops_nest.py): the windowed-estimate structure (= icwy_neiop's
    inner loop) under the same adaptive controller."""
    return lowsync_phi(tau_out, A, u, scheme="icwy", mode="neiop",
                       tol=tol, m_init=m_init, mmin=mmin, mmax=mmax, task1=task1)
