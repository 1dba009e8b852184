"""Device-resident FGMRES: restarted flexible GMRES as ONE XLA program.

Same role as the host fgmres.py (reference solvers/fgmres.py:97) but built
from `lax.while_loop`s over fixed (restart+1)-sized V/Z/H buffers so one
implicit solve (e.g. a Ros2 step) is a single device program — the host
variant pays one dispatch per Krylov iteration.

Vectors keep their NATURAL (possibly multi-axis) shape end to end — the
Krylov basis is ``(restart+1,) + b.shape`` and every dot is a full-tensor
contraction. Under GSPMD with `b` sharded over the mesh this is the
scalable distributed form: dots lower to ONE fused all-reduce, axpys and
the basis stay sharded, and no ravel/reshape forces a relayout (a 1D view
of a mesh-sharded state has no representable sharding, so the partitioner
would otherwise all-to-all every iteration — measured on the 8-device CPU
mesh, tests/test_solvers_sharded.py).

Orthogonalization is classical Gram-Schmidt as one batched masked product
(one fused reduction) plus the explicit new-vector norm (a second) —
2 collectives per iteration under GSPMD. With ``one_sync=True`` the norm
rides the SAME batched product ([V; w] @ w) and the orthogonalized norm
comes from the Pythagorean identity ||w - Vh||^2 = ||w||^2 - ||h||^2 —
ONE collective per iteration, the device-resident twin of the reference's
norm-estimate low-sync family (solvers/icwy_ne.py / dcgs2.py there) and of
the host fgmres.py 1-sync scheme. The estimate can lose accuracy under
severe cancellation (guarded: clamped at zero => treated as happy
breakdown), which is the same trade the reference's *_ne solvers make.
Givens rotations run as device scalars.
"""

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax


class FgmresJitInfo(NamedTuple):
    norm_r: jnp.ndarray
    norm_b: jnp.ndarray
    num_iter: jnp.ndarray
    converged: jnp.ndarray  # bool


def fgmres_jit(
    A: Callable,
    b: jnp.ndarray,
    x0: Optional[jnp.ndarray] = None,
    tol: float = 1e-5,
    restart: int = 20,
    max_outer: int = 20,
    preconditioner: Optional[Callable] = None,
    one_sync: bool = False,
    A32: Optional[Callable] = None,
    basis_dtype=None,
):
    """Solve A x = b. `A` is traceable on arrays of b's shape (any rank).
    Returns (x, FgmresJitInfo) with x of b's shape.

    Pure/traceable — wrap the call (with the operator closure) in one
    jax.jit, e.g. ``jax.jit(lambda q, b: fgmres_jit(lambda v: op(q, v), b))``.

    ``A32`` + ``basis_dtype=jnp.float32`` switch the restart cycles to
    mixed precision (restarted-GMRES iterative refinement, Carson & Higham
    style): the INNER Arnoldi runs the cheaper ``A32`` operator on a
    basis_dtype Krylov basis, while every OUTER residual ``r = b - A(x)`` and the solution update
    stay in full precision with the exact operator — each restart contracts
    the true f64 residual, so the final ``norm_r`` is an honest f64 measure
    and tolerances ~1e-7 remain reachable. The Hessenberg column/Givens/
    triangular algebra is (mmax+1)-small and stays in b's dtype."""
    b = jnp.asarray(b)
    dtype = b.dtype
    if basis_dtype is None:
        # An A32 operator without an explicit basis dtype would silently run
        # a half-mixed configuration (f32 matvec promoted into an f64 basis:
        # f64 basis cost, f32 operator accuracy) — default the basis to the
        # reduced precision the operator provides.
        basis_dtype = jnp.float32 if A32 is not None else dtype
    bd = basis_dtype
    A_in = A if A32 is None else A32
    shape = b.shape
    nax = tuple(range(len(shape)))  # the vector axes (contracted in dots)
    R = restart
    M = preconditioner if preconditioner is not None else (lambda v: v)
    x = jnp.zeros_like(b) if x0 is None else jnp.asarray(x0).reshape(shape)

    def dot(u, v):
        return jnp.sum(u * v)

    def rows_dot(Vs, v):
        """(k,)+shape  x  shape -> (k,): the batched Gram product (one fused
        reduction under GSPMD)."""
        return jnp.tensordot(Vs, v, axes=(tuple(a + 1 for a in nax), nax))

    def combine(coeffs, Vs):
        """(k,) x (k,)+shape -> shape."""
        return jnp.tensordot(coeffs, Vs, axes=(0, 0))

    norm_b = jnp.sqrt(dot(b, b))
    tol_rel = tol * norm_b
    kidx = jnp.arange(R + 1)

    class Inner(NamedTuple):
        V: jnp.ndarray  # (R+1,) + shape Krylov basis
        Z: jnp.ndarray  # (R,) + shape preconditioned vectors
        Hcol: jnp.ndarray  # (R+1, R) rotated Hessenberg columns (upper tri)
        cs: jnp.ndarray  # (R,) Givens cosines
        sn: jnp.ndarray  # (R,) Givens sines
        g: jnp.ndarray  # (R+1,) rotated residual vector
        j: jnp.ndarray
        done: jnp.ndarray

    def inner_body(st: Inner) -> Inner:
        j = st.j
        vj = lax.dynamic_index_in_dim(st.V, j, axis=0, keepdims=False)
        z = M(vj)
        w = A_in(z)
        # Classical Gram-Schmidt against rows 0..j (one batched product).
        mask = kidx <= j
        if one_sync:
            # The new vector's own norm rides the same batched reduction;
            # the orthogonalized norm is the Pythagorean estimate
            # ||w - Vh||^2 = ||w||^2 - ||h||^2 (V orthonormal) — one
            # collective per iteration under GSPMD.
            G = rows_dot(jnp.concatenate([st.V, w[None]]), w)  # (R+2,)
            hb = jnp.where(mask, G[: R + 1], jnp.asarray(0.0, bd))
            w = w - combine(hb, st.V)
            nrm = jnp.sqrt(jnp.maximum(G[R + 1] - hb @ hb, jnp.asarray(0.0, bd)))
        else:
            hb = jnp.where(mask, rows_dot(st.V, w), jnp.asarray(0.0, bd))  # (R+1,)
            w = w - combine(hb, st.V)
            nrm = jnp.sqrt(dot(w, w))
        h = hb.astype(dtype)
        nrm = nrm.astype(dtype)

        # Apply the accumulated Givens rotations to the new column.
        def rot_body(i, hv):
            c, s = st.cs[i], st.sn[i]
            hi, hi1 = hv[i], hv[i + 1]
            hv = hv.at[i].set(c * hi + s * hi1)
            return hv.at[i + 1].set(-s * hi + c * hi1)

        hfull = h.at[jnp.minimum(j + 1, R)].set(nrm)
        hfull = lax.fori_loop(0, j, rot_body, hfull)

        # New rotation zeroing the subdiagonal entry (j < R in the loop, so
        # j+1 is always a valid row of the (R+1)-sized buffers).
        a_, b_ = hfull[j], hfull[j + 1]
        r_ = jnp.sqrt(a_ * a_ + b_ * b_)
        safe = r_ > 0
        c = jnp.where(safe, a_ / jnp.where(safe, r_, 1.0), 1.0)
        s = jnp.where(safe, b_ / jnp.where(safe, r_, 1.0), 0.0)
        hfull = hfull.at[j].set(r_)
        hfull = hfull.at[j + 1].set(0.0)

        gj = st.g[j]
        g = st.g.at[j].set(c * gj)
        g = g.at[j + 1].set(-s * gj)

        nrm_b = nrm.astype(bd)
        vnew = jnp.where(nrm_b > 0, w / jnp.where(nrm_b > 0, nrm_b, 1.0), w)
        V = lax.dynamic_update_index_in_dim(st.V, vnew, j + 1, axis=0)
        Z = lax.dynamic_update_index_in_dim(st.Z, z, j, axis=0)
        Hcol = lax.dynamic_update_slice(st.Hcol, hfull[:, None], (jnp.int32(0), j))
        cs = st.cs.at[j].set(c)
        sn = st.sn.at[j].set(s)

        res = jnp.abs(g[j + 1])
        done = (res < tol_rel) | (nrm == 0.0)
        return Inner(V, Z, Hcol, cs, sn, g, j + 1, done)

    class Outer(NamedTuple):
        x: jnp.ndarray
        r: jnp.ndarray
        norm_r: jnp.ndarray
        niter: jnp.ndarray
        outer: jnp.ndarray

    def outer_body(st: Outer) -> Outer:
        V0 = jnp.zeros((R + 1,) + shape, bd)
        V0 = V0.at[0].set((st.r / st.norm_r).astype(bd))
        inner0 = Inner(
            V=V0, Z=jnp.zeros((R,) + shape, bd), Hcol=jnp.zeros((R + 1, R), dtype),
            cs=jnp.zeros((R,), dtype), sn=jnp.zeros((R,), dtype),
            g=jnp.zeros((R + 1,), dtype).at[0].set(st.norm_r),
            j=jnp.int32(0), done=jnp.asarray(False),
        )
        fin = lax.while_loop(lambda s_: (s_.j < R) & (~s_.done), inner_body, inner0)

        # Back-substitution on the rotated (upper-triangular) H, masked to
        # the j completed columns (identity padding elsewhere -> y = 0).
        jdone = fin.j
        cmask = jnp.arange(R) < jdone
        Ht = jnp.where(cmask[None, :] & cmask[:, None], fin.Hcol[:R, :], 0.0)
        Ht = Ht + jnp.diag(jnp.where(cmask, 0.0, 1.0))
        y = jax.scipy.linalg.solve_triangular(Ht, jnp.where(cmask, fin.g[:R], 0.0))
        # The state-sized update runs in the basis dtype; the solution, the
        # residual and its norm stay full-precision with the exact A.
        x = st.x + combine(y.astype(bd), fin.Z).astype(dtype)
        r = b - A(x)
        norm_r = jnp.sqrt(dot(r, r))
        return Outer(x, r, norm_r, st.niter + jdone, st.outer + 1)

    r0 = b - A(x)
    init = Outer(x, r0, jnp.sqrt(dot(r0, r0)), jnp.int32(0), jnp.int32(0))
    out = lax.while_loop(
        lambda s_: (s_.norm_r >= tol_rel) & (s_.outer < max_outer) & (norm_b > 0),
        outer_body,
        init,
    )
    info = FgmresJitInfo(out.norm_r, norm_b, out.niter, (out.norm_r < tol_rel) | (norm_b == 0))
    return out.x, info
