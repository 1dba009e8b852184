"""3D compressible Euler equations on the cubed sphere (DFR discretization).

Capability parity with the reference's pde/pde_euler_cubesphere.py +
rhs/rhs_dfr.py (RHSDirecFluxReconstruction_mpi) + pde/fluxes.py
(rusanov_3d_*_new): log-space extrapolation of rho and rho*theta, sqrt(g)-
weighted advective + pressure fluxes, Rusanov interface fluxes with the
rho*w advection/pressure split (the pressure-gradient term of the w
equation is computed in the p * d(log p) form), rigid-lid vertical BC via
odd symmetry of w, Christoffel/Coriolis forcing contraction and the
high-mode-filtered gravity term.

Design: state is global ``Q[nvar, 6, nk, ny, nx, s^3]`` (nvar = 5 +
tracers), the whole RHS is one pure jittable function built from batched
GEMMs over the trailing axis; interface fluxes are computed per interface;
panel-edge halos come from parallel/topology.py (pure gathers + rotations ->
collectives under sharding). All tracer rows
are exchanged like scalars (the reference leaves tracer halos at panel
edges unexchanged — rhs_dfr.py:148-172 sends only the 5 dynamical rows).
"""

from typing import Callable, Optional

import jax.numpy as jnp
import numpy as np
from jax.tree_util import Partial

from ..common.constants import CPD, CVD, GRAVITY, P0, RD
from ..geometry.cubed_sphere_3d import CubedSphere3D
from ..geometry.metric3d import Metric3D
from ..ops.dfr import DFROperators
from ..parallel.topology import EAST, NORTH, SOUTH, WEST, CubedSphereTopology

IDX_RHO = 0
IDX_RHO_U1 = 1
IDX_RHO_U2 = 2
IDX_RHO_W = 3
IDX_RHO_THETA = 4

HEAT_CAPACITY_RATIO = CPD / CVD


def _pressure_of(rho_theta):
    return P0 * jnp.exp(HEAT_CAPACITY_RATIO * jnp.log((RD / P0) * rho_theta))


def build_euler3d_constants(ops: DFROperators, metric: Metric3D, dtype=jnp.float64) -> dict:
    """Global constant arrays of the 3D Euler spatial operator, keyed for
    `_euler3d_rhs_core`. Grid fields keep their full (6, nk, ny, nx, ...)
    shape; the shard_map path slices them per tile and passes the slices as
    operands to the same core."""
    c = lambda a: jnp.asarray(a, dtype=dtype)
    npE = lambda a: np.asarray(a, dtype=np.float64)
    s = ops.num_solpts
    ss = s * s
    s3 = s**3

    ccb = np.zeros((6 * ss, 3 * s3))
    for k, cm in enumerate((ops.correction_WE3, ops.correction_SN3, ops.correction_DU3)):
        ccb[2 * ss * k : 2 * ss * (k + 1), s3 * k : s3 * (k + 1)] = npE(cm)

    _np_wpres = (
        npE(metric.sqrtG) * npE(metric.h_contra[0, 2]) @ npE(ops.derivative_x3)
        + npE(metric.sqrtG) * npE(metric.h_contra[1, 2]) @ npE(ops.derivative_y3)
        + npE(metric.sqrtG) * npE(metric.h_contra[2, 2]) @ npE(ops.derivative_z3)
    )

    return {
        "EE": c(np.concatenate([npE(ops.extrap_x3), npE(ops.extrap_y3), npE(ops.extrap_z3)], axis=1)),
        "DD": c(np.concatenate([npE(ops.derivative_x3), npE(ops.derivative_y3), npE(ops.derivative_z3)], axis=0)),
        "DD3": c(np.concatenate([npE(ops.derivative_x3), npE(ops.derivative_y3), npE(ops.derivative_z3)], axis=1)),
        "CC": c(np.concatenate([npE(ops.correction_WE3), npE(ops.correction_SN3), npE(ops.correction_DU3)], axis=0)),
        "CCb": c(ccb),
        "hfk": c(ops.highfilter_k),
        "sqrtG": c(metric.sqrtG),
        "inv_sqrtG": c(metric.inv_sqrtG),
        "inv_dzdeta": c(metric.inv_dzdeta),
        "hc": c(metric.h_contra),  # (3, 3) + grid
        "chr": c(metric.christoffel),  # (3, 9) + grid
        "wpres_int": c(_np_wpres),
        "sg_i": c(metric.sqrtG_itf_i),
        "sg_j": c(metric.sqrtG_itf_j),
        "sg_k": c(metric.sqrtG_itf_k),
        "hr_i": c(metric.h_contra_itf_i[0]),  # (3,) + itf grid: h^{1,k}
        "hr_j": c(metric.h_contra_itf_j[1]),
        "hr_k": c(metric.h_contra_itf_k[2]),
    }


def _euler3d_rhs_core(q, cst: dict, halo_fn, ss: int, advection_only: bool = False,
                      extra_forcing=None):
    """The whole 3D Euler spatial operator on arrays of ANY grid shape
    (global (nv, 6, nk, ny, nx, s^3) or one shard_map tile
    (nv, nk, nyt, nxt, s^3)); `halo_fn(q_itf_i, q_itf_j)` supplies the four
    horizontal halo traces (S, N, W, E) in local orientation. All metric
    constants come from `cst` (build_euler3d_constants or per-tile slices
    of it)."""
    nv = q.shape[0]
    sqrtG, inv_sqrtG = cst["sqrtG"], cst["inv_sqrtG"]
    h = {(a, b): cst["hc"][a, b] for a in range(3) for b in range(3)}
    rho = q[IDX_RHO]
    u1 = q[IDX_RHO_U1] / rho
    u2 = q[IDX_RHO_U2] / rho
    w = q[IDX_RHO_W] / rho

    # --- 1. Extrapolation to all six faces in ONE GEMM; rho and rho*theta
    # travel in log space (reference rhs_dfr.py:62-71).
    log_rho = jnp.log(rho)
    log_rt = jnp.log(q[IDX_RHO_THETA])
    q_ext = jnp.concatenate(
        [log_rho[None], q[IDX_RHO_U1:IDX_RHO_THETA], log_rt[None], q[IDX_RHO_THETA + 1 :]]
    )
    itf = q_ext @ cst["EE"]
    itf = jnp.concatenate(
        [
            jnp.exp(itf[IDX_RHO : IDX_RHO + 1]),
            itf[IDX_RHO_U1:IDX_RHO_THETA],
            jnp.exp(itf[IDX_RHO_THETA : IDX_RHO_THETA + 1]),
            itf[IDX_RHO_THETA + 1 :],
        ]
    )
    q_itf_i = itf[..., : 2 * ss]
    q_itf_j = itf[..., 2 * ss : 4 * ss]
    q_itf_k = itf[..., 4 * ss :]

    # --- 2. Panel-edge halos (pooled exchange or tile ppermutes).
    halo_s_, halo_n_, halo_w_, halo_e_ = halo_fn(q_itf_i, q_itf_j)

    # --- 3+4. Pointwise fluxes + interior derivatives (see the factory
    # docstring and reference pde_euler_cubesphere.py:72-124).
    pressure = _pressure_of(q[IDX_RHO_THETA])
    logp = jnp.log(pressure)
    sgp = sqrtG * pressure
    mom = slice(IDX_RHO_U1, IDX_RHO_W + 1)

    bund = []
    for un, d in ((u1, 0), (u2, 1), (w, 2)):
        flux = sqrtG * un * q
        wadv = flux[IDX_RHO_W]
        flux = flux.at[mom].add(jnp.stack([sgp * h[(d, 0)], sgp * h[(d, 1)], sgp * h[(d, 2)]]))
        bund.append(jnp.concatenate([flux, wadv[None]], axis=0))
    interior = jnp.concatenate(bund, axis=-1) @ cst["DD"]
    df_sum = interior[:nv]
    w_adv_sum = interior[nv]
    dlogp = logp @ cst["DD3"]

    # --- 5. Per-interface left/right states.
    east = q_itf_i[..., ss:]
    west = q_itf_i[..., :ss]
    qL_x = jnp.concatenate([halo_w_[..., None, :], east], axis=-2)
    qR_x = jnp.concatenate([west, halo_e_[..., None, :]], axis=-2)

    north = q_itf_j[..., ss:]
    south = q_itf_j[..., :ss]
    qL_y = jnp.concatenate([halo_s_[..., None, :, :], north], axis=-3)
    qR_y = jnp.concatenate([south, halo_n_[..., None, :, :]], axis=-3)

    top = q_itf_k[..., ss:]
    bot = q_itf_k[..., :ss]
    qL_z = jnp.concatenate([bot[..., 0:1, :, :, :], top], axis=-4)  # ground mirror
    qR_z = jnp.concatenate([bot, top[..., -1:, :, :, :]], axis=-4)

    vL_x = qL_x[IDX_RHO_U1] / qL_x[IDX_RHO]
    vR_x = qR_x[IDX_RHO_U1] / qR_x[IDX_RHO]
    vL_y = qL_y[IDX_RHO_U2] / qL_y[IDX_RHO]
    vR_y = qR_y[IDX_RHO_U2] / qR_y[IDX_RHO]
    w_bot = bot[IDX_RHO_W] / bot[IDX_RHO]
    w_top = top[IDX_RHO_W] / top[IDX_RHO]
    vL_z = jnp.concatenate([-w_bot[..., 0:1, :, :, :], w_top], axis=-4)
    vR_z = jnp.concatenate([w_bot, -w_top[..., -1:, :, :, :]], axis=-4)

    # One merged Rusanov pass over all three interface families.
    _flat = lambda a: a.reshape(-1, ss)
    sg_cat = jnp.concatenate([_flat(cst["sg_i"]), _flat(cst["sg_j"]), _flat(cst["sg_k"])])
    h_row_cat = tuple(
        jnp.concatenate([_flat(cst["hr_i"][k]), _flat(cst["hr_j"][k]), _flat(cst["hr_k"][k])])
        for k in range(3)
    )
    h_diag_cat = jnp.concatenate(
        [_flat(cst["hr_i"][0]), _flat(cst["hr_j"][1]), _flat(cst["hr_k"][2])]
    )

    xsh, ysh, zsh = qL_x.shape[1:], qL_y.shape[1:], qL_z.shape[1:]
    NX = int(np.prod(xsh[:-1]))
    NY = int(np.prod(ysh[:-1]))
    fl = lambda a: a.reshape(a.shape[: a.ndim - len(xsh)] + (-1, ss))
    qL = jnp.concatenate([fl(qL_x), fl(qL_y), fl(qL_z)], axis=-2)
    qR = jnp.concatenate([fl(qR_x), fl(qR_y), fl(qR_z)], axis=-2)
    vL = jnp.concatenate([fl(vL_x), fl(vL_y), fl(vL_z)], axis=-2)
    vR = jnp.concatenate([fl(vR_x), fl(vR_y), fl(vR_z)], axis=-2)

    pL_c = _pressure_of(qL[IDX_RHO_THETA])
    pR_c = _pressure_of(qR[IDX_RHO_THETA])
    if advection_only:
        eig = jnp.maximum(jnp.abs(vL), jnp.abs(vR))
    else:
        eig_l = jnp.abs(vL) + jnp.sqrt(h_diag_cat * HEAT_CAPACITY_RATIO * pL_c / qL[IDX_RHO])
        eig_r = jnp.abs(vR) + jnp.sqrt(h_diag_cat * HEAT_CAPACITY_RATIO * pR_c / qR[IDX_RHO])
        eig = jnp.maximum(eig_l, eig_r)
    flux_l = sg_cat * vL * qL
    flux_r = sg_cat * vR * qR
    wadv_c = 0.5 * (flux_l[IDX_RHO_W] + flux_r[IDX_RHO_W]
                    - eig * sg_cat * (qR[IDX_RHO_W] - qL[IDX_RHO_W]))
    h0, h1, h2 = h_row_cat
    flux_l = flux_l.at[IDX_RHO_U1 : IDX_RHO_W + 1].add(
        jnp.stack([sg_cat * h0 * pL_c, sg_cat * h1 * pL_c, sg_cat * h2 * pL_c])
    )
    flux_r = flux_r.at[IDX_RHO_U1 : IDX_RHO_W + 1].add(
        jnp.stack([sg_cat * h0 * pR_c, sg_cat * h1 * pR_c, sg_cat * h2 * pR_c])
    )
    f_c = 0.5 * (flux_l + flux_r - eig * sg_cat * (qR - qL))
    wpres_c = 0.5 * (sg_cat * h2 * pL_c + sg_cat * h2 * pR_c)

    sx = lambda a: a[..., :NX, :].reshape(a.shape[: a.ndim - 2] + xsh)
    sy = lambda a: a[..., NX : NX + NY, :].reshape(a.shape[: a.ndim - 2] + ysh)
    sz = lambda a: a[..., NX + NY :, :].reshape(a.shape[: a.ndim - 2] + zsh)
    f_x, f_y, f_z = sx(f_c), sy(f_c), sz(f_c)
    wadv_x, wadv_y, wadv_z = sx(wadv_c), sy(wadv_c), sz(wadv_c)
    wpres_x, wpres_y, wpres_z = sx(wpres_c), sy(wpres_c), sz(wpres_c)
    pLx, pLy, pLz = sx(pL_c), sy(pL_c), sz(pL_c)
    pRx, pRy, pRz = sx(pR_c), sy(pR_c), sz(pR_c)

    # --- 6. Boundary corrections (factory docstring).
    faces_x = lambda a: jnp.concatenate([a[..., :-1, :], a[..., 1:, :]], axis=-1)
    faces_y = lambda a: jnp.concatenate([a[..., :-1, :, :], a[..., 1:, :, :]], axis=-1)
    faces_z = lambda a: jnp.concatenate([a[..., :-1, :, :, :], a[..., 1:, :, :, :]], axis=-1)

    def face_parts(f_itf, wadv, wpres, p_w, p_e, sl_w, sl_e, faces):
        wpres_faces = jnp.concatenate([sl_w(wpres) / p_w, sl_e(wpres) / p_e], axis=-1)
        logp_faces = jnp.concatenate([jnp.log(p_w), jnp.log(p_e)], axis=-1)
        bundle = jnp.concatenate([faces(f_itf), faces(wadv[None]), wpres_faces[None]], axis=0)
        return bundle, logp_faces

    sxw = lambda a: a[..., :-1, :]
    sxe = lambda a: a[..., 1:, :]
    syw = lambda a: a[..., :-1, :, :]
    sye = lambda a: a[..., 1:, :, :]
    szw = lambda a: a[..., :-1, :, :, :]
    sze = lambda a: a[..., 1:, :, :, :]
    fb_x, lpf_x = face_parts(f_x, wadv_x, wpres_x, sxw(pRx), sxe(pLx), sxw, sxe, faces_x)
    fb_y, lpf_y = face_parts(f_y, wadv_y, wpres_y, syw(pRy), sye(pLy), syw, sye, faces_y)
    fb_z, lpf_z = face_parts(f_z, wadv_z, wpres_z, szw(pRz), sze(pLz), szw, sze, faces_z)

    corr = jnp.concatenate([fb_x, fb_y, fb_z], axis=-1) @ cst["CC"]
    dlp = dlogp + jnp.concatenate([lpf_x, lpf_y, lpf_z], axis=-1) @ cst["CCb"]

    df = df_sum + corr[:nv]
    s3_ = dlp.shape[-1] // 3
    w_df = (
        w_adv_sum
        + corr[nv]
        + (cst["wpres_int"] + corr[nv + 1]) * pressure
        + pressure
        * (
            sqrtG * h[(0, 2)] * dlp[..., :s3_]
            + sqrtG * h[(1, 2)] * dlp[..., s3_ : 2 * s3_]
            + sqrtG * h[(2, 2)] * dlp[..., 2 * s3_ :]
        )
    )

    out = -inv_sqrtG * df
    out = out.at[IDX_RHO_W].set(-inv_sqrtG * w_df)

    # --- 7. Forcing (pde_euler_cubesphere.py:12-53, :279-281).
    chr_ = cst["chr"]

    def forcing_row(a):
        ch = chr_[a]
        return (
            2.0 * rho * (ch[0] * u1 + ch[1] * u2 + ch[2] * w)
            + ch[3] * (rho * u1 * u1 + h[(0, 0)] * pressure)
            + 2.0 * ch[4] * (rho * u1 * u2 + h[(0, 1)] * pressure)
            + 2.0 * ch[5] * (rho * u1 * w + h[(0, 2)] * pressure)
            + ch[6] * (rho * u2 * u2 + h[(1, 1)] * pressure)
            + 2.0 * ch[7] * (rho * u2 * w + h[(1, 2)] * pressure)
            + ch[8] * (rho * w * w + h[(2, 2)] * pressure)
        )

    f1, f2 = forcing_row(0), forcing_row(1)
    gravity_term = cst["inv_dzdeta"] * GRAVITY * inv_sqrtG * ((sqrtG * rho) @ cst["hfk"])
    f3 = forcing_row(2) + gravity_term
    if extra_forcing is not None:
        e1, e2, e3 = extra_forcing(rho, u1, u2, w)
        f1, f2, f3 = f1 + e1, f2 + e2, f3 + e3
    out = out.at[IDX_RHO_U1].add(-f1)
    out = out.at[IDX_RHO_U2].add(-f2)
    out = out.at[IDX_RHO_W].add(-f3)

    if advection_only:
        out = out.at[:5].set(0.0)
    return out


def _euler3d_base_intermediates(q0, cst: dict, halo_fn, ss: int) -> dict:
    """Base-state intermediates for the perturbation-form RHS, computed once
    (in float64 at factory time) and closed over as constants."""
    rho0 = q0[IDX_RHO]
    log_rho = jnp.log(rho0)
    log_rt = jnp.log(q0[IDX_RHO_THETA])
    q_ext = jnp.concatenate([log_rho[None], q0[1:4], log_rt[None]])
    itf = q_ext @ cst["EE"]
    itf = jnp.concatenate(
        [jnp.exp(itf[0:1]), itf[1:4], jnp.exp(itf[4:5])]
    )
    itf_i, itf_j, itf_k = itf[..., : 2 * ss], itf[..., 2 * ss : 4 * ss], itf[..., 4 * ss :]
    hs0, hn0, hw0, he0 = halo_fn(itf_i, itf_j)
    p0 = _pressure_of(q0[IDX_RHO_THETA])
    logp0 = jnp.log(p0)
    dlogp0 = logp0 @ cst["DD3"]

    # Base face pressures / w-split pieces (mirror the absolute core's
    # stage 5-6 plumbing) for dlp0 and the base wpres/p face correction.
    east, west = itf_i[..., ss:], itf_i[..., :ss]
    qL_x = jnp.concatenate([hw0[..., None, :], east], axis=-2)
    qR_x = jnp.concatenate([west, he0[..., None, :]], axis=-2)
    north, south = itf_j[..., ss:], itf_j[..., :ss]
    qL_y = jnp.concatenate([hs0[..., None, :, :], north], axis=-3)
    qR_y = jnp.concatenate([south, hn0[..., None, :, :]], axis=-3)
    top, bot = itf_k[..., ss:], itf_k[..., :ss]
    qL_z = jnp.concatenate([bot[..., 0:1, :, :, :], top], axis=-4)
    qR_z = jnp.concatenate([bot, top[..., -1:, :, :, :]], axis=-4)

    pf = _pressure_of
    pLx, pRx = pf(qL_x[IDX_RHO_THETA]), pf(qR_x[IDX_RHO_THETA])
    pLy, pRy = pf(qL_y[IDX_RHO_THETA]), pf(qR_y[IDX_RHO_THETA])
    pLz, pRz = pf(qL_z[IDX_RHO_THETA]), pf(qR_z[IDX_RHO_THETA])
    sxw = lambda a: a[..., :-1, :]
    sxe = lambda a: a[..., 1:, :]
    syw = lambda a: a[..., :-1, :, :]
    sye = lambda a: a[..., 1:, :, :]
    szw = lambda a: a[..., :-1, :, :, :]
    sze = lambda a: a[..., 1:, :, :, :]
    lpf_x = jnp.concatenate([jnp.log(sxw(pRx)), jnp.log(sxe(pLx))], axis=-1)
    lpf_y = jnp.concatenate([jnp.log(syw(pRy)), jnp.log(sye(pLy))], axis=-1)
    lpf_z = jnp.concatenate([jnp.log(szw(pRz)), jnp.log(sze(pLz))], axis=-1)
    dlp0 = dlogp0 + jnp.concatenate([lpf_x, lpf_y, lpf_z], axis=-1) @ cst["CCb"]

    # wpres0/p0 face correction: sum over the three families through CC
    # (rows laid out [x faces | y faces | z faces], like the core's bundle).
    def wp0(sg, h2, pLf, pRf, sw, se):
        wp = 0.5 * sg * h2 * (pLf + pRf)
        return jnp.concatenate([sw(wp) / sw(pRf), se(wp) / se(pLf)], axis=-1)

    wpf_x = wp0(cst["sg_i"], cst["hr_i"][2], pLx, pRx, sxw, sxe)
    wpf_y = wp0(cst["sg_j"], cst["hr_j"][2], pLy, pRy, syw, sye)
    wpf_z = wp0(cst["sg_k"], cst["hr_k"][2], pLz, pRz, szw, sze)
    wcorr0 = jnp.concatenate([wpf_x, wpf_y, wpf_z], axis=-1) @ cst["CC"]

    return {
        "q0": q0, "u0": q0[1:4] / rho0, "p0": p0, "dlogp0": dlogp0,
        "itf_i0": itf_i, "itf_j0": itf_j, "itf_k0": itf_k,
        "halo0": (hs0, hn0, hw0, he0),
        "dlp0": dlp0, "wcorr0": wcorr0,
    }


def _euler3d_rhs_core_pert(q, cst: dict, base: dict, halo_fn, ss: int,
                           delta_input: bool = False):
    """Perturbation-form (base-state-split) RHS: returns
    ``RHS(q) = rhs0 + [RHS(q) - RHS(q0)]`` with the bracket computed by
    TERM-LEVEL expansion around the balanced base state q0 — every linear
    stage (GEMMs) acts on differences directly and every nonlinear site
    (log-space extrapolation, pressure, Riemann, w split, forcing) is
    expanded exactly via expm1/log1p and product rules, so the hydrostatic
    cancellation (pressure gradient vs gravity, ~1e-9 relative in absolute
    form) never has to survive float32 rounding. ``rhs0`` (the f64 base
    RHS, cast) rides in ``base["rhs0"]``. Five dynamical variables only.

    This is the standard NWP perturbation formulation (the reference keeps
    absolute variables in float64 instead; pde_euler_cubesphere.py:72-124).
    """
    nv = 5
    sqrtG, inv_sqrtG = cst["sqrtG"], cst["inv_sqrtG"]
    h = {(a, b): cst["hc"][a, b] for a in range(3) for b in range(3)}
    q0 = base["q0"]
    if delta_input:
        dq = q  # the caller carries the perturbation itself (full f32 resolution)
        q = q0 + dq
    else:
        dq = q - q0
    rho = q[IDX_RHO]
    rho0 = q0[IDX_RHO]
    u0 = base["u0"]  # (3, grid)
    # du = (d(rho u) - u0 * d(rho)) / rho  — exact algebra, small result.
    du = (dq[1:4] - u0 * dq[IDX_RHO]) / rho
    u = u0 + du

    # --- 1. extrapolation: d(tr) for momenta is linear; for the log-space
    # rows d(tr) = tr0 * expm1(E . log1p(d/base)).
    dlog_rho = jnp.log1p(dq[IDX_RHO] / rho0)
    dlog_rt = jnp.log1p(dq[IDX_RHO_THETA] / q0[IDX_RHO_THETA])
    d_ext = jnp.concatenate([dlog_rho[None], dq[1:4], dlog_rt[None]])
    ditf = d_ext @ cst["EE"]
    itf_cat0 = jnp.concatenate(
        [base["itf_i0"], base["itf_j0"], base["itf_k0"]], axis=-1
    )
    expand = lambda d_log, t0: t0 * jnp.expm1(d_log)
    ditf = jnp.concatenate(
        [
            expand(ditf[0:1], itf_cat0[0:1]),
            ditf[1:4],
            expand(ditf[4:5], itf_cat0[4:5]),
        ]
    )
    d_itf_i = ditf[..., : 2 * ss]
    d_itf_j = ditf[..., 2 * ss : 4 * ss]
    d_itf_k = ditf[..., 4 * ss :]

    # --- 2. halos of the perturbation traces (exchange is linear).
    dhs, dhn, dhw, dhe = halo_fn(d_itf_i, d_itf_j)
    hs0, hn0, hw0, he0 = base["halo0"]

    # --- 3+4. pointwise flux differences + interior GEMMs on deltas.
    p0 = base["p0"]
    dp = p0 * jnp.expm1(HEAT_CAPACITY_RATIO * dlog_rt)
    pressure = p0 + dp
    dlogp = jnp.log1p(dp / p0)
    mom = slice(IDX_RHO_U1, IDX_RHO_W + 1)

    bund = []
    for d in range(3):
        # d(u_d q_v) = u0_d dq_v + du_d q_v  (q absolute — exact product rule)
        dflux = sqrtG * (u0[d] * dq + du[d] * q)
        dwadv = dflux[IDX_RHO_W]
        dflux = dflux.at[mom].add(
            jnp.stack([sqrtG * dp * h[(d, 0)], sqrtG * dp * h[(d, 1)], sqrtG * dp * h[(d, 2)]])
        )
        bund.append(jnp.concatenate([dflux, dwadv[None]], axis=0))
    interior = jnp.concatenate(bund, axis=-1) @ cst["DD"]
    ddf_sum = interior[:nv]
    dw_adv_sum = interior[nv]
    ddlogp = dlogp @ cst["DD3"]

    # --- 5. interface L/R deltas + base values.
    def lr(i0, j0, k0, hw_, he_, hs_, hn_):
        east, west = i0[..., ss:], i0[..., :ss]
        qlx = jnp.concatenate([hw_[..., None, :], east], axis=-2)
        qrx = jnp.concatenate([west, he_[..., None, :]], axis=-2)
        north, south = j0[..., ss:], j0[..., :ss]
        qly = jnp.concatenate([hs_[..., None, :, :], north], axis=-3)
        qry = jnp.concatenate([south, hn_[..., None, :, :]], axis=-3)
        top, bot = k0[..., ss:], k0[..., :ss]
        qlz = jnp.concatenate([bot[..., 0:1, :, :, :], top], axis=-4)
        qrz = jnp.concatenate([bot, top[..., -1:, :, :, :]], axis=-4)
        return (qlx, qrx, qly, qry, qlz, qrz)

    L0x, R0x, L0y, R0y, L0z, R0z = lr(base["itf_i0"], base["itf_j0"], base["itf_k0"],
                                      hw0, he0, hs0, hn0)
    dLx, dRx, dLy, dRy, dLz, dRz = lr(d_itf_i, d_itf_j, d_itf_k, dhw, dhe, dhs, dhn)

    _flat = lambda a: a.reshape(-1, ss)
    sg_cat = jnp.concatenate([_flat(cst["sg_i"]), _flat(cst["sg_j"]), _flat(cst["sg_k"])])
    h_row_cat = tuple(
        jnp.concatenate([_flat(cst["hr_i"][k]), _flat(cst["hr_j"][k]), _flat(cst["hr_k"][k])])
        for k in range(3)
    )
    h_diag_cat = jnp.concatenate(
        [_flat(cst["hr_i"][0]), _flat(cst["hr_j"][1]), _flat(cst["hr_k"][2])]
    )

    xsh, ysh, zsh = L0x.shape[1:], L0y.shape[1:], L0z.shape[1:]
    NX = int(np.prod(xsh[:-1]))
    NY = int(np.prod(ysh[:-1]))
    fl = lambda a: a.reshape(a.shape[: a.ndim - len(xsh)] + (-1, ss))
    cat3 = lambda x, y, z: jnp.concatenate([fl(x), fl(y), fl(z)], axis=-2)
    qL0, qR0 = cat3(L0x, L0y, L0z), cat3(R0x, R0y, R0z)
    dqL, dqR = cat3(dLx, dLy, dLz), cat3(dRx, dRy, dRz)
    qL, qR = qL0 + dqL, qR0 + dqR

    # normal speeds: base + full, delta by subtraction (v is a smooth ratio
    # of states, so its difference carries no large-term cancellation).
    def vfam(Lx, Ly, Lz, left: bool):
        vx = Lx[IDX_RHO_U1] / Lx[IDX_RHO]
        vy = Ly[IDX_RHO_U2] / Ly[IDX_RHO]
        wz = Lz[IDX_RHO_W] / Lz[IDX_RHO]
        if left:
            sign = jnp.concatenate(
                [-jnp.ones_like(wz[..., 0:1, :, :, :]), jnp.ones_like(wz[..., 1:, :, :, :])],
                axis=-4,
            )
        else:
            sign = jnp.concatenate(
                [jnp.ones_like(wz[..., :-1, :, :, :]), -jnp.ones_like(wz[..., -1:, :, :, :])],
                axis=-4,
            )
        return jnp.concatenate([fl(vx), fl(vy), fl(sign * wz)], axis=-2)

    vL0 = vfam(L0x, L0y, L0z, True)
    vR0 = vfam(R0x, R0y, R0z, False)
    vL = vfam(L0x + dLx, L0y + dLy, L0z + dLz, True)
    vR = vfam(R0x + dRx, R0y + dRy, R0z + dRz, False)
    dvL, dvR = vL - vL0, vR - vR0  # small: v is a smooth ratio of states

    pL0 = _pressure_of(qL0[IDX_RHO_THETA])
    pR0 = _pressure_of(qR0[IDX_RHO_THETA])
    dpL = pL0 * jnp.expm1(
        HEAT_CAPACITY_RATIO * jnp.log1p(dqL[IDX_RHO_THETA] / qL0[IDX_RHO_THETA])
    )
    dpR = pR0 * jnp.expm1(
        HEAT_CAPACITY_RATIO * jnp.log1p(dqR[IDX_RHO_THETA] / qR0[IDX_RHO_THETA])
    )
    pL, pR = pL0 + dpL, pR0 + dpR

    eig = jnp.maximum(
        jnp.abs(vL) + jnp.sqrt(h_diag_cat * HEAT_CAPACITY_RATIO * pL / qL[IDX_RHO]),
        jnp.abs(vR) + jnp.sqrt(h_diag_cat * HEAT_CAPACITY_RATIO * pR / qR[IDX_RHO]),
    )
    eig0 = jnp.maximum(
        jnp.abs(vL0) + jnp.sqrt(h_diag_cat * HEAT_CAPACITY_RATIO * pL0 / qL0[IDX_RHO]),
        jnp.abs(vR0) + jnp.sqrt(h_diag_cat * HEAT_CAPACITY_RATIO * pR0 / qR0[IDX_RHO]),
    )
    deig = eig - eig0

    # d[flux] expansions (the dissipation term multiplies jumps, which are
    # small for the smooth base, so deig may be formed by subtraction).
    dflux_l = sg_cat * (vL0 * dqL + dvL * qL)
    dflux_r = sg_cat * (vR0 * dqR + dvR * qR)
    dwadv_c = 0.5 * (
        dflux_l[IDX_RHO_W] + dflux_r[IDX_RHO_W]
        - sg_cat * (eig * (dqR[IDX_RHO_W] - dqL[IDX_RHO_W])
                    + deig * (qR0[IDX_RHO_W] - qL0[IDX_RHO_W]))
    )
    h0c, h1c, h2c = h_row_cat
    dflux_l = dflux_l.at[IDX_RHO_U1 : IDX_RHO_W + 1].add(
        jnp.stack([sg_cat * h0c * dpL, sg_cat * h1c * dpL, sg_cat * h2c * dpL])
    )
    dflux_r = dflux_r.at[IDX_RHO_U1 : IDX_RHO_W + 1].add(
        jnp.stack([sg_cat * h0c * dpR, sg_cat * h1c * dpR, sg_cat * h2c * dpR])
    )
    df_c = 0.5 * (dflux_l + dflux_r - sg_cat * (eig * (dqR - dqL) + deig * (qR0 - qL0)))
    wpres_c0 = 0.5 * sg_cat * h2c * (pL0 + pR0)
    dwpres_c = 0.5 * sg_cat * h2c * (dpL + dpR)

    sx = lambda a: a[..., :NX, :].reshape(a.shape[: a.ndim - 2] + xsh)
    sy = lambda a: a[..., NX : NX + NY, :].reshape(a.shape[: a.ndim - 2] + ysh)
    sz = lambda a: a[..., NX + NY :, :].reshape(a.shape[: a.ndim - 2] + zsh)

    # --- 6. corrections on deltas; the w pressure split expands as
    # d[(W + c) p] = (W + c0) dp + dc p  and  d[p sgh dlp] = p0 ddlp + dp dlp.
    faces_x = lambda a: jnp.concatenate([a[..., :-1, :], a[..., 1:, :]], axis=-1)
    faces_y = lambda a: jnp.concatenate([a[..., :-1, :, :], a[..., 1:, :, :]], axis=-1)
    faces_z = lambda a: jnp.concatenate([a[..., :-1, :, :, :], a[..., 1:, :, :, :]], axis=-1)
    sxw = lambda a: a[..., :-1, :]
    sxe = lambda a: a[..., 1:, :]
    syw = lambda a: a[..., :-1, :, :]
    sye = lambda a: a[..., 1:, :, :]
    szw = lambda a: a[..., :-1, :, :, :]
    sze = lambda a: a[..., 1:, :, :, :]

    def face_parts_pert(df_f, dwadv_f, wpres0_f, dwpres_f, p0w, p0e, dpw, dpe, sw, se, faces):
        pw, pe = p0w + dpw, p0e + dpe
        # d[wpres/p] = dwpres/p - (wpres0/p0)(dp/p)  (denominator absolute)
        dwp_w = sw(dwpres_f) / pw - (sw(wpres0_f) / p0w) * (dpw / pw)
        dwp_e = se(dwpres_f) / pe - (se(wpres0_f) / p0e) * (dpe / pe)
        dwp = jnp.concatenate([dwp_w, dwp_e], axis=-1)
        dlogp_faces = jnp.concatenate([jnp.log1p(dpw / p0w), jnp.log1p(dpe / p0e)], axis=-1)
        bundle = jnp.concatenate([faces(df_f), faces(dwadv_f[None]), dwp[None]], axis=0)
        return bundle, dlogp_faces

    fb_x, dlpf_x = face_parts_pert(
        sx(df_c), sx(dwadv_c), sx(wpres_c0), sx(dwpres_c),
        sxw(sx(pR0)), sxe(sx(pL0)), sxw(sx(dpR)), sxe(sx(dpL)), sxw, sxe, faces_x,
    )
    fb_y, dlpf_y = face_parts_pert(
        sy(df_c), sy(dwadv_c), sy(wpres_c0), sy(dwpres_c),
        syw(sy(pR0)), sye(sy(pL0)), syw(sy(dpR)), sye(sy(dpL)), syw, sye, faces_y,
    )
    fb_z, dlpf_z = face_parts_pert(
        sz(df_c), sz(dwadv_c), sz(wpres_c0), sz(dwpres_c),
        szw(sz(pR0)), sze(sz(pL0)), szw(sz(dpR)), sze(sz(dpL)), szw, sze, faces_z,
    )

    corr = jnp.concatenate([fb_x, fb_y, fb_z], axis=-1) @ cst["CC"]
    ddlp = ddlogp + jnp.concatenate([dlpf_x, dlpf_y, dlpf_z], axis=-1) @ cst["CCb"]
    dlp_abs = base["dlp0"] + ddlp

    ddf = ddf_sum + corr[:nv]
    s3_ = ddlp.shape[-1] // 3
    dw_df = (
        dw_adv_sum
        + corr[nv]
        + (cst["wpres_int"] + base["wcorr0"]) * dp
        + corr[nv + 1] * pressure
        + sqrtG * h[(0, 2)] * (p0 * ddlp[..., :s3_] + dp * dlp_abs[..., :s3_])
        + sqrtG * h[(1, 2)] * (p0 * ddlp[..., s3_ : 2 * s3_] + dp * dlp_abs[..., s3_ : 2 * s3_])
        + sqrtG * h[(2, 2)] * (p0 * ddlp[..., 2 * s3_ :] + dp * dlp_abs[..., 2 * s3_ :])
    )

    out = -inv_sqrtG * ddf
    out = out.at[IDX_RHO_W].set(-inv_sqrtG * dw_df)

    # --- 7. forcing deltas: linear Coriolis part directly; quadratics by
    # the product rule with absolute second factors; gravity is linear.
    chr_ = cst["chr"]

    def dforcing_row(a):
        ch = chr_[a]
        lin = 2.0 * (ch[0] * dq[IDX_RHO_U1] + ch[1] * dq[IDX_RHO_U2] + ch[2] * dq[IDX_RHO_W])

        def dprod(i, j):
            # d[q_i q_j / rho]
            return (dq[i] * q0[j] + q[i] * dq[j]) / rho - (q0[i] * q0[j] / rho0) * (
                dq[IDX_RHO] / rho
            )

        return (
            lin
            + ch[3] * (dprod(1, 1) + h[(0, 0)] * dp)
            + 2.0 * ch[4] * (dprod(1, 2) + h[(0, 1)] * dp)
            + 2.0 * ch[5] * (dprod(1, 3) + h[(0, 2)] * dp)
            + ch[6] * (dprod(2, 2) + h[(1, 1)] * dp)
            + 2.0 * ch[7] * (dprod(2, 3) + h[(1, 2)] * dp)
            + ch[8] * (dprod(3, 3) + h[(2, 2)] * dp)
        )

    df1, df2 = dforcing_row(0), dforcing_row(1)
    dgrav = cst["inv_dzdeta"] * GRAVITY * inv_sqrtG * ((sqrtG * dq[IDX_RHO]) @ cst["hfk"])
    df3 = dforcing_row(2) + dgrav
    out = out.at[IDX_RHO_U1].add(-df1)
    out = out.at[IDX_RHO_U2].add(-df2)
    out = out.at[IDX_RHO_W].add(-df3)

    return base["rhs0"] + out


def make_rhs_euler_cubesphere(
    geom: CubedSphere3D,
    ops: DFROperators,
    metric: Metric3D,
    topology: Optional[CubedSphereTopology] = None,
    advection_only: bool = False,
    extra_forcing: Optional[Callable] = None,
    dtype=jnp.float64,
    perturbation_base: Optional[jnp.ndarray] = None,
) -> Callable[[jnp.ndarray], jnp.ndarray]:
    """Build the jittable 3D Euler RHS ``Q -> dQ/dt``.

    `extra_forcing(rho, u1, u2, w)` may return momentum-forcing additions
    (f1, f2, f3) — used for the DCMIP 21/22 Rayleigh damping
    (reference pde_euler_cubesphere.py:283-288).

    ``perturbation_base``: a balanced state (usually the initial condition)
    that turns the operator into the perturbation (base-state-split) form
    (see ``_euler3d_rhs_core_pert``): the f64 base RHS is folded in and only
    the term-level delta runs in ``dtype``, so the hydrostatic cancellation
    never has to survive float32 rounding. The returned callable takes the
    ABSOLUTE state and exposes ``.delta`` (perturbation in, tendency out),
    ``.base_state`` and ``.xla`` (the absolute-form operator).

    The operators are ``jax.tree_util.Partial`` objects whose leaves are the
    metric/operator constants (hundreds of MB at benchmark sizes). A jitted
    program that takes one as an ARGUMENT receives the constants as
    parameters (the integrators do); one that closes over it embeds them as
    literals, which at 1.3M grid points made the EPI2 step a 64 s GPU compile
    with ~1 GB of generated code."""
    if topology is None:
        topology = CubedSphereTopology(geom)
    ss = ops.num_solpts ** 2

    cst = build_euler3d_constants(ops, metric, dtype=dtype)

    def halo_fn(q_itf_i, q_itf_j):
        halo = topology.halo_state_3d(q_itf_i, q_itf_j, (IDX_RHO_U1, IDX_RHO_U2))
        return halo[:, SOUTH], halo[:, NORTH], halo[:, WEST], halo[:, EAST]

    def rhs_fn(cst_, q):
        return _euler3d_rhs_core(
            q, cst_, halo_fn, ss, advection_only=advection_only, extra_forcing=extra_forcing
        )

    rhs = Partial(rhs_fn, cst)
    if perturbation_base is None:
        return rhs

    # Perturbation-form (base-state-split) operator: term-level expansion
    # around the balanced base state with the f64 base RHS folded in (see
    # _euler3d_rhs_core_pert). Callers still pass the ABSOLUTE state.
    # Requires the 5 dynamical variables.
    if advection_only or extra_forcing is not None:
        raise ValueError("perturbation_base supports the plain 5-variable system")
    q0_64 = jnp.asarray(perturbation_base, jnp.float64)
    cst64 = build_euler3d_constants(ops, metric, dtype=jnp.float64)
    base64 = _euler3d_base_intermediates(q0_64, cst64, halo_fn, ss)
    base64["rhs0"] = _euler3d_rhs_core(q0_64, cst64, halo_fn, ss)
    cast = lambda a: jnp.asarray(a, dtype=dtype)
    base = {
        k: (tuple(cast(x) for x in v) if isinstance(v, tuple) else cast(v))
        for k, v in base64.items()
    }

    def pert_fn(cst_, base_, q):
        return _euler3d_rhs_core_pert(q, cst_, base_, halo_fn, ss)

    def delta_fn(cst_, base_, qprime):
        """RHS evaluated at q0 + qprime with qprime passed DIRECTLY, for
        integrations that carry the perturbation as the state (the full
        f32-accuracy mode: no absolute-state quantization)."""
        return _euler3d_rhs_core_pert(qprime, cst_, base_, halo_fn, ss, delta_input=True)

    rhs_pert = Partial(pert_fn, cst, base)
    rhs_pert.xla = rhs
    rhs_pert.delta = Partial(delta_fn, cst, base)
    rhs_pert.base_state = base["q0"]
    return rhs_pert
