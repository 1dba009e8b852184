"""Device-resident KIOPS: the whole adaptive Krylov phi-function evaluation
as ONE XLA program (`lax.while_loop`), for the single-output-time case the
EPI/SRERK/Ros2 hot paths use.

The host-orchestrated variant (kiops.py) pays one device dispatch and one
host round trip per Krylov iteration. Here the Arnoldi loop, the
incomplete orthogonalization, the small-matrix exponential (solve-free
scaling-squaring Taylor on the masked fixed-size H — see _expm_taylor) and
the tau/m adaptivity controller all run on device with fixed (mmax+1)-sized
V/H buffers and masking, so one EPI step is one program.

Krylov vectors keep their NATURAL (possibly multi-axis, mesh-sharded) state
shape: the basis is ``(mmax+1,) + shape`` and the reference's p augmented
rows (kiops.py:181-183 there) live as a separate tiny ``(mmax+1, p)``
REPLICATED buffer, so under GSPMD every dot is one fused all-reduce and no
ravel forces a relayout (a 1D view of a mesh-sharded state has no
representable sharding — the partitioner would all-to-all every iteration).

Algorithm and controller semantics replicate kiops.py line for line
(Gaudreault, Rainwater & Tokman 2018; reference solvers/kiops.py:152-338),
including the reference's quirks (the persistent H across substeps, the
`i = p - k + 1` restart weights), so results agree with the host version to
roundoff on the same trajectory. Reductions are plain jnp contractions —
under GSPMD they lower to mesh collectives, 2 per iteration like the
reference (1 with ``one_sync``).
"""

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax


def _expm_taylor(A: jnp.ndarray, order: int = 20, max_squarings: int = 48) -> jnp.ndarray:
    """Matrix exponential via scaling-and-squaring + Taylor/Horner.

    Solve-free on purpose: jax.scipy.linalg.expm's Pade form needs an LU
    solve; this runs in any dtype with matmuls only. With the norm scaled below 1/2, a
    20-term Taylor series is accurate to ~1e-16; squarings restore scale."""
    dtype = A.dtype
    norm = jnp.max(jnp.sum(jnp.abs(A), axis=1))
    k = jnp.clip(
        jnp.ceil(jnp.log2(jnp.maximum(norm, 1e-300)) + 1.0), 0, max_squarings
    ).astype(jnp.int32)
    B = A / (2.0 ** k.astype(dtype))
    eye = jnp.eye(A.shape[0], dtype=dtype)
    E = eye
    for i in range(order, 0, -1):
        E = eye + (B @ E) / jnp.asarray(float(i), dtype)
    return lax.fori_loop(0, max_squarings, lambda i, M: jnp.where(i < k, M @ M, M), E)


class KiopsJitStats(NamedTuple):
    krylov_steps: jnp.ndarray
    substeps: jnp.ndarray
    rejected: jnp.ndarray
    num_expm: jnp.ndarray
    error_estimate: jnp.ndarray
    last_krylov_size: jnp.ndarray


def kiops_jit(
    A: Callable,
    u: jnp.ndarray,
    tau_end: float = 1.0,
    tol: float = 1e-7,
    m_init=10,  # may be a traced int (Krylov-size warm start)
    mmin: int = 10,
    mmax: int = 64,
    iop: int = 2,
    task1: bool = False,
    full_ortho: bool = False,
    basis_dtype=None,
    one_sync: bool = False,
):
    """Evaluate w = phi_0(tau A) u[0] + phi_1(tau A) u[1] + ... at tau_end.

    `A` must be traceable on arrays of u's row shape (any rank — typically
    the RHS jvp on the natural state shape); `u` has shape (p+1,) + shape.
    Returns (w, KiopsJitStats) with w of that row shape.

    Pure/traceable — callers wrap it (plus their vec construction and state
    update) in ONE jax.jit so a fresh `A` closure per call does not retrace:
    ``step = jax.jit(lambda v: kiops_jit(lambda v: jvp(q, v), vec))``.

    ``full_ortho`` replaces the incomplete (iop-window) orthogonalization
    with full reorthogonalized classical Gram-Schmidt (CGS2). REQUIRED for
    inexact operators (mixed-precision f32 matvecs): the IOP recurrence
    relies on the exact Krylov identity A V = V H + r e^T, and an operator
    noise of eps gets amplified by the (unboundedly ill-conditioned)
    oblique IOP basis — measured 58x result error at iop=2 with a 2e-7
    matvec on dcmip31, vs ~1e-6 with CGS2. Costs 4 fixed-size (mmax+1, ...)
    contractions per iteration, negligible next to the RHS jvp.

    ``basis_dtype`` (default: u's dtype) stores the Krylov basis V and runs
    the state-sized vector algebra (matvec input, CGS2 projections, axpys,
    result combination) in that dtype, while H, beta, the controller, and
    the small-matrix exponential stay in u's dtype. With f64 phi-vectors
    and basis_dtype=float32 this is the full mixed-precision operating
    point for an f32 matvec: the subspace accuracy is f32-limited by the
    operator anyway, and the basis algebra moves half the bytes. `A` is
    called with (and must return) basis_dtype arrays.

    ``one_sync`` fuses the new vector's own norm into the SAME batched Gram
    product ([rows; v] @ v) and takes the orthogonalized norm from the
    Pythagorean identity ||v - h@rows||^2 = ||v||^2 - ||h||^2 — ONE
    collective per Arnoldi iteration under GSPMD instead of two, the
    device-resident twin of the reference's norm-estimate family
    (kiops_nest.py / icwy_neiop.py there; clamped at zero => treated as
    happy breakdown, the same cancellation trade those solvers make). With
    ``full_ortho`` it applies the estimate after the second CGS pass
    (skipping that pass would forfeit the reorthogonalization the f32
    operators need) — 2 collectives instead of 3."""
    u = jnp.asarray(u)
    dtype = u.dtype
    bd = dtype if basis_dtype is None else basis_dtype
    ppo = u.shape[0]
    shape = u.shape[1:]
    nax = tuple(range(len(shape)))
    p = ppo - 1
    if p == 0:
        p = 1
        u = jnp.concatenate([u, jnp.zeros((1,) + shape, dtype)], axis=0)

    def dot_full(xb, xa, yb, ya):
        """Augmented inner product: state part (one fused all-reduce under
        GSPMD) + tiny replicated augmented part."""
        return jnp.sum(xb * yb) + xa @ ya

    def rows_dot(Vb, Va, vb, va):
        """(k,)+shape Gram product against one augmented vector -> (k,)."""
        return jnp.tensordot(Vb, vb, axes=(tuple(a + 1 for a in nax), nax)) + Va @ va

    def combine(coeffs, Vb):
        return jnp.tensordot(coeffs, Vb, axes=(0, 0))

    f = lambda v: jnp.asarray(v, dtype)
    sgn = f(1.0) if tau_end >= 0 else f(-1.0)
    tau_end_a = abs(f(tau_end))
    if abs(tau_end) > 1:
        gamma, gamma_mmax = f(0.2), f(0.1)
    else:
        gamma, gamma_mmax = f(0.9), f(0.6)
    delta = f(1.4)

    # Scale the phi-coefficient rows to unit order of magnitude.
    norm_u = jnp.max(jnp.sum(jnp.abs(u[1:]), axis=tuple(a + 1 for a in nax)))
    ex = jnp.ceil(jnp.log2(norm_u))
    use_scale = (ppo > 1) & (norm_u > 0)
    nu = jnp.where(use_scale, 2.0**-ex, 1.0).astype(dtype)
    mu = jnp.where(use_scale, 2.0**ex, 1.0).astype(dtype)
    u_flip = (nu * jnp.flipud(u[1:])).astype(bd)  # (p,) + shape

    ridx = jnp.arange(mmax + 1)
    # Restart weights for the augmented rows (reference kiops.py:160-163,
    # including its `i = p - k + 1` exponent choice).
    aug_i = jnp.asarray([p - k + 1 for k in range(p - 1)] + [0], dtype=dtype)
    aug_fact = jnp.asarray(
        [float(_factorial(p - k + 1)) for k in range(p - 1)] + [1.0], dtype=dtype
    )

    class S(NamedTuple):
        w: jnp.ndarray  # shape, full precision accumulant
        Vb: jnp.ndarray  # (mmax+1,) + shape basis (state part)
        Va: jnp.ndarray  # (mmax+1, p) basis (augmented part, replicated)
        H: jnp.ndarray
        j: jnp.ndarray
        m: jnp.ndarray
        beta: jnp.ndarray
        tau_now: jnp.ndarray
        tau: jnp.ndarray
        happy: jnp.ndarray
        omega: jnp.ndarray
        oldm: jnp.ndarray
        oldtau: jnp.ndarray
        order: jnp.ndarray
        kest: jnp.ndarray
        order_old: jnp.ndarray
        kest_old: jnp.ndarray
        ireject: jnp.ndarray
        ksteps: jnp.ndarray
        substeps: jnp.ndarray
        rejected: jnp.ndarray
        nexpm: jnp.ndarray
        err_sum: jnp.ndarray

    def restart(s: S) -> S:
        aug = mu * (s.tau_now**aug_i) / aug_fact
        aug = aug.at[p - 1].set(mu)  # V[0, n+p-1] = mu (overrides the k-loop)
        beta = jnp.sqrt(dot_full(s.w, aug, s.w, aug))
        Vb = lax.dynamic_update_index_in_dim(s.Vb, (s.w / beta).astype(bd), 0, axis=0)
        Va = lax.dynamic_update_index_in_dim(s.Va, (aug / beta).astype(bd), 0, axis=0)
        return s._replace(Vb=Vb, Va=Va, beta=beta)

    def arnoldi_cond(s: S):
        return (s.j < s.m) & (~s.happy)

    def arnoldi_body(s: S) -> S:
        j = s.j + 1  # the row being built (host loop increments first)
        vprev_b = lax.dynamic_index_in_dim(s.Vb, j - 1, axis=0, keepdims=False)
        vprev_a = lax.dynamic_index_in_dim(s.Va, j - 1, axis=0, keepdims=False)
        vjb = A(vprev_b) + combine(vprev_a, u_flip)
        vja = jnp.concatenate([vprev_a[1:], jnp.zeros((1,), bd)])

        oldcol = lax.dynamic_slice(s.H, (jnp.int32(0), j - 1), (mmax + 1, 1))[:, 0]
        nrm_est = None
        if full_ortho:
            # Full CGS2: project on ALL previous basis rows, twice.
            rmask = ridx < j
            h1 = jnp.where(rmask, rows_dot(s.Vb, s.Va, vjb, vja), jnp.asarray(0.0, bd))
            vjb = vjb - combine(h1, s.Vb)
            vja = vja - h1 @ s.Va
            if one_sync:
                # Second pass with the norm fused into the same batched
                # product — 2 collectives/iter instead of 3.
                G = rows_dot(
                    jnp.concatenate([s.Vb, vjb[None]]),
                    jnp.concatenate([s.Va, vja[None]]),
                    vjb, vja,
                )  # (mmax+2,)
                h2 = jnp.where(rmask, G[: mmax + 1], jnp.asarray(0.0, bd))
                vjb = vjb - combine(h2, s.Vb)
                vja = vja - h2 @ s.Va
                nrm_est = jnp.sqrt(jnp.maximum(G[mmax + 1] - h2 @ h2, jnp.asarray(0.0, bd)))
            else:
                h2 = jnp.where(rmask, rows_dot(s.Vb, s.Va, vjb, vja), jnp.asarray(0.0, bd))
                vjb = vjb - combine(h2, s.Vb)
                vja = vja - h2 @ s.Va
            newcol = jnp.where(rmask, (h1 + h2).astype(dtype), oldcol)
        else:
            # Incomplete orthogonalization: the last `iop` basis rows only.
            ilow = jnp.maximum(0, j - iop)
            rows_b = lax.dynamic_slice_in_dim(s.Vb, ilow, iop, axis=0)
            rows_a = lax.dynamic_slice_in_dim(s.Va, ilow, iop, axis=0)
            rmask = (ilow + jnp.arange(iop)) < j
            if one_sync:
                # Norm fused into the Gram product: [rows; v] @ v — ONE
                # collective/iter (the kiops_nest/icwy_neiop structure).
                G = rows_dot(
                    jnp.concatenate([rows_b, vjb[None]]),
                    jnp.concatenate([rows_a, vja[None]]),
                    vjb, vja,
                )  # (iop+1,)
                hvals = jnp.where(rmask, G[:iop], jnp.asarray(0.0, bd))
                vjb = vjb - combine(hvals, rows_b)
                vja = vja - hvals @ rows_a
                nrm_est = jnp.sqrt(jnp.maximum(G[iop] - hvals @ hvals, jnp.asarray(0.0, bd)))
            else:
                hvals = jnp.where(rmask, rows_dot(rows_b, rows_a, vjb, vja), jnp.asarray(0.0, bd))
                vjb = vjb - combine(hvals, rows_b)
                vja = vja - hvals @ rows_a

            # H[ilow:j, j-1] = hvals (other rows of the column keep their —
            # possibly stale — values, exactly like the reference).
            colmask = (ridx >= ilow) & (ridx < j)
            scatter = jnp.zeros((mmax + 1,), dtype)
            scatter = lax.dynamic_update_slice(scatter, hvals.astype(dtype), (ilow,))
            newcol = jnp.where(colmask, scatter, oldcol)
        H = lax.dynamic_update_slice(s.H, newcol[:, None], (jnp.int32(0), j - 1))

        nrm = jnp.sqrt(dot_full(vjb, vja, vjb, vja)) if nrm_est is None else nrm_est
        happy = nrm < tol
        # On the happy break the host leaves V[j] unnormalized and H[j, j-1]
        # untouched, and does not count the iteration.
        H = lax.cond(
            happy,
            lambda H: H,
            lambda H: lax.dynamic_update_slice(H, nrm.astype(dtype).reshape(1, 1), (j, j - 1)),
            H,
        )
        inv = jnp.where(happy, jnp.asarray(1.0, bd), 1.0 / jnp.where(happy, 1.0, nrm))
        Vb = lax.dynamic_update_index_in_dim(s.Vb, vjb * inv, j, axis=0)
        Va = lax.dynamic_update_index_in_dim(s.Va, vja * inv, j, axis=0)
        return s._replace(
            Vb=Vb, Va=Va, H=H, j=j, happy=happy, ksteps=s.ksteps + jnp.where(happy, 0, 1)
        )

    def control(s: S) -> S:
        j = s.j
        jf = j.astype(dtype)
        # Masked (j+1)x(j+1) block with the phi_1 coupling H[0, j] = 1 set on
        # the PERSISTENT H (kept on accept, undone on reject — reference
        # kiops.py:214,332) and H[j, j-1] zeroed for the exponential only.
        H = lax.dynamic_update_slice(s.H, jnp.ones((1, 1), dtype), (jnp.int32(0), j))
        nrm_keep = lax.dynamic_slice(H, (j, j - 1), (1, 1))[0, 0]
        Hexp = jnp.where((ridx[:, None] <= j) & (ridx[None, :] <= j), H, 0.0)
        Hexp = lax.dynamic_update_slice(Hexp, jnp.zeros((1, 1), dtype), (j, j - 1))
        F = _expm_taylor(sgn * s.tau * Hexp)
        nexpm = s.nexpm + 1

        fj = lax.dynamic_slice(F, (j - 1, j), (1, 1))[0, 0]
        err_raw = jnp.abs(s.beta * nrm_keep * fj)

        # --- omega controller (reference kiops.py:237-288) ---
        oldomega = s.omega
        omega_raw = tau_end_a * err_raw / (s.tau * tol)
        omega = jnp.where(jnp.isfinite(omega_raw), omega_raw, 1e300)

        old_ok = (oldomega > 0) & jnp.isfinite(oldomega) & (s.ireject >= 1)
        # Order estimate.
        order_branch = (s.m == s.oldm) & (s.tau != s.oldtau) & old_ok
        cand_o = jnp.log(omega / oldomega) / jnp.log(s.tau / s.oldtau)
        cand_o = jnp.where(jnp.isfinite(cand_o), jnp.maximum(1.0, cand_o), jnp.maximum(1.0, jf / 4))
        default_o = (s.order_old) | (s.ireject == 0)
        order = jnp.where(order_branch, cand_o, jnp.where(default_o, jf / 4, s.order))
        order_old = ~order_branch
        order = jnp.where(jnp.isfinite(order) & (order > 0), order, jnp.maximum(1.0, jf / 4))

        # Krylov-size convergence-rate estimate.
        kest_branch = (s.m != s.oldm) & (s.tau == s.oldtau) & old_ok
        cand_k = (omega / oldomega) ** (1.0 / (s.oldm - s.m).astype(dtype))
        cand_k = jnp.where(jnp.isfinite(cand_k), jnp.maximum(1.1, cand_k), 2.0)
        default_k = (s.kest_old) | (s.ireject == 0)
        kest = jnp.where(kest_branch, cand_k, jnp.where(default_k, 2.0, s.kest))
        kest_old = ~kest_branch
        kest = jnp.where(jnp.isfinite(kest) & (kest > 1.0), kest, 2.0)

        remaining = jnp.where(
            omega > delta, tau_end_a - s.tau_now, tau_end_a - (s.tau_now + s.tau)
        )
        same_tau = jnp.minimum(remaining, s.tau)
        tau_opt = s.tau * (gamma / omega) ** (1.0 / order)
        tau_opt = jnp.minimum(remaining, jnp.maximum(s.tau / 5, jnp.minimum(5 * s.tau, tau_opt)))
        m_opt_raw = jf + jnp.log(omega / gamma) / jnp.log(kest)
        m_opt_raw = jnp.where(jnp.isfinite(m_opt_raw), jnp.ceil(m_opt_raw), jf)
        m_opt = jnp.clip(
            jnp.maximum(
                jnp.floor(3 / 4 * s.m.astype(dtype)),
                jnp.minimum(m_opt_raw, jnp.ceil(4 / 3 * s.m.astype(dtype))),
            ),
            mmin,
            mmax,
        ).astype(s.m.dtype)

        at_mmax = j == mmax
        tau_red = s.tau * (gamma_mmax / omega) ** (1.0 / order)
        tau_red = jnp.minimum(tau_end_a - s.tau_now, jnp.maximum(s.tau / 5, tau_red))
        m_new_nh = jnp.where(at_mmax, jnp.where(omega > delta, j, s.m), m_opt)
        tau_new_nh = jnp.where(
            at_mmax, jnp.where(omega > delta, tau_red, tau_opt), same_tau
        )

        # Happy path overrides (omega = err = 0, keep m, cap tau).
        happy = s.happy
        omega = jnp.where(happy, 0.0, omega)
        err = jnp.where(happy, 0.0, err_raw)
        m_new = jnp.where(happy, s.m, m_new_nh)
        tau_new = jnp.where(
            happy, jnp.minimum(tau_end_a - (s.tau_now + s.tau), s.tau), tau_new_nh
        )

        # --- accept / reject ---
        accept = omega <= delta
        fcol = jnp.where(ridx < j, F[:, 0], 0.0)
        # The result combination runs in the basis dtype (fcol is
        # (mmax+1,)-small; the contraction's cost is the basis itself).
        w_acc = s.beta * combine(fcol.astype(bd), s.Vb).astype(dtype)
        w = jnp.where(accept, w_acc, s.w)
        # Reject undoes the phi_1 coupling entry (H[0, j] = 0).
        H = lax.cond(
            accept,
            lambda H: H,
            lambda H: lax.dynamic_update_slice(H, jnp.zeros((1, 1), dtype), (jnp.int32(0), j)),
            H,
        )
        tau_now = jnp.where(accept, s.tau_now + s.tau, s.tau_now)
        jn = jnp.where(accept, 0, j)
        substeps = s.substeps + jnp.where(accept, 1, 0)
        rejected = s.rejected + jnp.where(accept, s.ireject, 0)
        err_sum = s.err_sum + jnp.where(accept, err, 0.0)
        ireject = jnp.where(accept, 0, s.ireject + 1)

        tau_next = jnp.where(
            (tau_new <= 0.0) & (tau_now < tau_end_a), tau_end_a - tau_now, tau_new
        )
        return s._replace(
            w=w, H=H, j=jn, m=m_new, tau_now=tau_now, tau=tau_next, happy=jnp.asarray(False),
            omega=omega, oldm=s.m, oldtau=s.tau, order=order, kest=kest,
            order_old=order_old, kest_old=kest_old, ireject=ireject,
            substeps=substeps, rejected=rejected, nexpm=nexpm, err_sum=err_sum,
        )

    def outer_body(s: S) -> S:
        s = lax.cond(s.j == 0, restart, lambda s: s, s)
        s = lax.while_loop(arnoldi_cond, arnoldi_body, s)
        return control(s)

    i32 = lambda v: jnp.asarray(v, jnp.int32)
    init = S(
        w=u[0], Vb=jnp.zeros((mmax + 1,) + shape, bd), Va=jnp.zeros((mmax + 1, p), bd),
        H=jnp.zeros((mmax + 1, mmax + 1), dtype),
        j=i32(0), m=jnp.clip(i32(m_init), mmin, mmax), beta=f(0.0),
        tau_now=f(0.0), tau=tau_end_a, happy=jnp.asarray(False),
        omega=f(jnp.nan), oldm=i32(-1), oldtau=f(jnp.nan), order=f(0.0), kest=f(2.0),
        order_old=jnp.asarray(True), kest_old=jnp.asarray(True), ireject=i32(0),
        ksteps=i32(0), substeps=i32(0), rejected=i32(0), nexpm=i32(0), err_sum=f(0.0),
    )
    out = lax.while_loop(lambda s: s.tau_now < tau_end_a, outer_body, init)
    w = out.w / f(tau_end) if task1 else out.w
    stats = KiopsJitStats(out.ksteps, out.substeps, out.rejected, out.nexpm, out.err_sum, out.m)
    return w, stats


def _factorial(k: int) -> int:
    out = 1
    for i in range(2, k + 1):
        out *= i
    return out
