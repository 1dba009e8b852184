"""Shallow-water equations on the rotated cubed sphere (DFR discretization).

Capability parity with the reference's rhs/rhs_sw.py (RhsShallowWater):
sqrt(g)-weighted fluxes with the 0.5*g*H^ij*h^2 pressure term, AUSM-type
Mach-splitting interface fluxes, Coriolis + Christoffel + topography-gradient
forcing, and optional bottom topography (Williamson case 5).

Design: the state is global, ``Q[3, 6, ny, nx, s^2]`` (h, h*u1, h*u2), and
the whole RHS is one pure jittable function. The halo exchange at panel
edges is the derived-table exchange of parallel/topology.py (pure gathers +
2x2 rotations; GSPMD turns them into collectives when sharded). Interface fluxes are computed per *interface*
(nx+1 per row) instead of per element-face pair, which halves the AUSM math
and feeds a single boundary-correction GEMM per direction.
"""

from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import jax.numpy as jnp
import numpy as np
from jax.tree_util import Partial

from ..common.constants import GRAVITY
from ..geometry.cubed_sphere import CubedSphere2D
from ..geometry.metric import Metric2D
from ..ops.dfr import DFROperators
from ..parallel.topology import EAST, NORTH, SOUTH, WEST, CubedSphereTopology

IDX_H = 0
IDX_HU1 = 1
IDX_HU2 = 2


@dataclass(frozen=True)
class Topography:
    """Bottom topography fields (reference init/initialize.py Topo)."""

    hsurf: np.ndarray  # (6, ny, nx, s^2)
    hsurf_itf_x1: np.ndarray  # (6, ny, nx+1, s) at x1 interfaces
    hsurf_itf_x2: np.ndarray  # (6, ny+1, nx, s) at x2 interfaces
    dzdx1: np.ndarray  # (6, ny, nx, s^2)
    dzdx2: np.ndarray


class SWConstants(NamedTuple):
    """The RHS's operator, metric and topography arrays: the leaves of its
    ``Partial``. The topography fields are None without topography."""

    EE: jnp.ndarray  # (s^2, 4s) extrapolation, x then y faces
    DD: jnp.ndarray  # (2 s^2, s^2) x+y derivative
    CC: jnp.ndarray  # (4s, s^2) x+y boundary correction
    sqrtG: jnp.ndarray
    inv_sqrtG: jnp.ndarray
    h11: jnp.ndarray
    h12: jnp.ndarray
    h21: jnp.ndarray
    h22: jnp.ndarray
    sqrtG_ix: jnp.ndarray
    h11_ix: jnp.ndarray
    h21_ix: jnp.ndarray
    sqrtG_jx: jnp.ndarray
    h12_jx: jnp.ndarray
    h22_jx: jnp.ndarray
    chr_1_01: jnp.ndarray
    chr_1_02: jnp.ndarray
    chr_2_01: jnp.ndarray
    chr_2_02: jnp.ndarray
    chr_1_11: jnp.ndarray
    chr_1_12: jnp.ndarray
    chr_2_12: jnp.ndarray
    chr_2_22: jnp.ndarray
    hsurf: Optional[jnp.ndarray] = None
    hsurf_ix: Optional[jnp.ndarray] = None
    hsurf_jx: Optional[jnp.ndarray] = None
    dzdx1: Optional[jnp.ndarray] = None
    dzdx2: Optional[jnp.ndarray] = None


class SWBase(NamedTuple):
    """Base-state intermediates of the perturbation form, in the working
    dtype: the f64 base RHS, the base state, its velocities and its
    left/right interface states."""

    rhs0: jnp.ndarray
    q0: jnp.ndarray
    u10: jnp.ndarray
    u20: jnp.ndarray
    Lx0: jnp.ndarray
    Rx0: jnp.ndarray
    Ly0: jnp.ndarray
    Ry0: jnp.ndarray


def make_rhs_shallow_water(
    geom: CubedSphere2D,
    ops: DFROperators,
    metric: Metric2D,
    topo: Optional[Topography] = None,
    dtype=jnp.float64,
    perturbation_base: Optional[jnp.ndarray] = None,
) -> Callable[[jnp.ndarray], jnp.ndarray]:
    """Build the jittable shallow-water RHS ``Q -> dQ/dt``.

    Mirrors the stage structure of the reference rhs_sw.py:38-240:
    extrapolate (with topography added to h) -> exchange boundary traces ->
    sqrt(g)-weighted pointwise fluxes -> interior derivative -> AUSM interface
    fluxes -> boundary correction -> metric/Coriolis/topography forcing.

    ``perturbation_base``: a balanced state (usually the initial condition)
    that turns the operator into the perturbation (base-state-split) form
    ``RHS(q) = RHS_f64(q0) + [RHS(q) - RHS(q0)]`` with the bracket expanded
    term by term (see ``_sw_rhs_delta``), so the geostrophic-balance
    cancellation (pressure-gradient flux divergence vs Christoffel/Coriolis
    forcing, ~7-8 orders below the flux scale at Williamson case 6) never
    has to survive float32 rounding. The reference sidesteps this by
    computing absolute variables in float64 (rhs/rhs_sw.py:81-238); the
    perturbation form is the standard NWP alternative and is what makes a
    float32 operating point numerically meaningful. The returned callable
    takes the ABSOLUTE state and exposes ``.delta`` (perturbation in,
    tendency out — full f32 resolution), ``.base_state`` and ``.xla`` (the
    absolute-form operator).

    The operators are ``jax.tree_util.Partial`` objects whose leaves are
    the constants (``SWConstants``, ``SWBase``), as in the 3D model: a
    jitted program that takes one as an argument receives them as
    parameters instead of embedding them as literals.
    """
    s = ops.num_solpts
    nel = geom.num_elements
    topology = CubedSphereTopology(geom)

    s = ops.num_solpts
    nel = geom.num_elements
    topology = CubedSphereTopology(geom)
    c = lambda a: jnp.asarray(a, dtype=dtype)

    # Fused operator blocks: both directions of each stage in ONE batched
    # GEMM (x2 is the slow element axis, so the reference's "z" 1D lifts are
    # this model's y operators). DD contracts the direction-concatenated
    # fluxes straight into the x+y divergence sum; CC does the same for the
    # boundary corrections. Per-interface metric values: interface m
    # (0..nel) is the west face of halo-layout element m+1.
    cst = SWConstants(
        EE=c(np.concatenate([ops.extrap_x, ops.extrap_z], axis=1)),
        DD=c(np.concatenate([ops.derivative_x, ops.derivative_z], axis=0)),
        CC=c(np.concatenate([ops.correction_WE, ops.correction_DU], axis=0)),
        sqrtG=c(metric.sqrtG), inv_sqrtG=c(metric.inv_sqrtG),
        h11=c(metric.H_contra_11), h12=c(metric.H_contra_12),
        h21=c(metric.H_contra_21), h22=c(metric.H_contra_22),
        sqrtG_ix=c(metric.sqrtG_itf_i[:, :, 1:, :s]),  # (6, ny, nx+1, s)
        h11_ix=c(metric.H_contra_11_itf_i[:, :, 1:, :s]),
        h21_ix=c(metric.H_contra_21_itf_i[:, :, 1:, :s]),
        sqrtG_jx=c(metric.sqrtG_itf_j[:, 1:, :, :s]),  # (6, ny+1, nx, s)
        h12_jx=c(metric.H_contra_12_itf_j[:, 1:, :, :s]),
        h22_jx=c(metric.H_contra_22_itf_j[:, 1:, :, :s]),
        chr_1_01=c(metric.christoffel_1_01), chr_1_02=c(metric.christoffel_1_02),
        chr_2_01=c(metric.christoffel_2_01), chr_2_02=c(metric.christoffel_2_02),
        chr_1_11=c(metric.christoffel_1_11), chr_1_12=c(metric.christoffel_1_12),
        chr_2_12=c(metric.christoffel_2_12), chr_2_22=c(metric.christoffel_2_22),
    )
    if topo is not None:
        cst = cst._replace(
            hsurf=c(topo.hsurf), hsurf_ix=c(topo.hsurf_itf_x1), hsurf_jx=c(topo.hsurf_itf_x2),
            dzdx1=c(topo.dzdx1), dzdx2=c(topo.dzdx2),
        )

    def ausm_interface_flux(qL, qR, sqrtG_itf, h_diag_itf, h_off_itf, normal: int):
        """AUSM Mach-splitting common flux at a set of interfaces.

        qL/qR: (3, ..., s) face states on either side (after topography
        removal). `normal` = IDX_HU1 or IDX_HU2 selects the momentum normal
        to the interface; h_diag/h_off are the corresponding metric rows.
        Reference: rhs_sw.py:170-207.
        """
        hL, hR = qL[IDX_H], qR[IDX_H]
        aL = jnp.sqrt(GRAVITY * hL * h_diag_itf)
        aR = jnp.sqrt(GRAVITY * hR * h_diag_itf)
        tmpL = hL * aL
        tmpR = hR * aR
        mL = jnp.where(tmpL != 0.0, qL[normal] / tmpL, 0.0)
        mR = jnp.where(tmpR != 0.0, qR[normal] / tmpR, 0.0)
        big_m = 0.25 * ((mL + 1.0) ** 2 - (mR - 1.0) ** 2)

        flux = sqrtG_itf * (jnp.maximum(0.0, big_m) * aL * qL + jnp.minimum(0.0, big_m) * aR * qR)

        # Pressure part, split between the two momentum components.
        if normal == IDX_HU1:
            p_diag_L, p_diag_R = h_diag_itf * hL**2, h_diag_itf * hR**2  # -> hu1
            p_off_L, p_off_R = h_off_itf * hL**2, h_off_itf * hR**2  # -> hu2
            rows = (IDX_HU1, IDX_HU2)
        else:
            p_diag_L, p_diag_R = h_diag_itf * hL**2, h_diag_itf * hR**2  # -> hu2
            p_off_L, p_off_R = h_off_itf * hL**2, h_off_itf * hR**2  # -> hu1
            rows = (IDX_HU2, IDX_HU1)

        half_g = 0.5 * GRAVITY
        pres_diag = 0.5 * ((1.0 + mL) * sqrtG_itf * half_g * p_diag_L + (1.0 - mR) * sqrtG_itf * half_g * p_diag_R)
        pres_off = 0.5 * ((1.0 + mL) * sqrtG_itf * half_g * p_off_L + (1.0 - mR) * sqrtG_itf * half_g * p_off_R)
        flux = flux.at[rows[0]].add(pres_diag)
        flux = flux.at[rows[1]].add(pres_off)
        return flux

    def rhs_fn(k: SWConstants, q: jnp.ndarray) -> jnp.ndarray:
        h = q[IDX_H]
        hu1 = q[IDX_HU1]
        hu2 = q[IDX_HU2]
        u1 = hu1 / h
        u2 = hu2 / h

        # 1. Extrapolate to element faces; h carries the surface height so
        # that the exchanged/jump quantity is continuous over topography.
        h_total = h + k.hsurf if k.hsurf is not None else h
        q_ext = jnp.stack([h_total, hu1, hu2])
        itf = q_ext @ k.EE  # (3, 6, ny, nx, 4s)
        itf_x = itf[..., : 2 * s]
        itf_y = itf[..., 2 * s :]

        # 2. Halo exchange of the boundary traces (scalar h, vector momentum).
        h_halo = topology.halo_scalars(itf_x[IDX_H], itf_y[IDX_H])
        u_halo = topology.halo_vectors(itf_x[IDX_HU1], itf_y[IDX_HU1], itf_x[IDX_HU2], itf_y[IDX_HU2])

        def halo_q(side, shape):
            return jnp.stack([h_halo[side], u_halo[side][0], u_halo[side][1]]).reshape((3,) + shape)

        ny = nx = nel
        halo_w = halo_q(WEST, (6, ny, 1, s))
        halo_e = halo_q(EAST, (6, ny, 1, s))
        halo_s = halo_q(SOUTH, (6, 1, nx, s))
        halo_n = halo_q(NORTH, (6, 1, nx, s))

        # 3. Pointwise sqrt(g)-weighted fluxes + interior derivatives.
        hsq = h**2
        fx = jnp.stack(
            [
                k.sqrtG * hu1,
                k.sqrtG * (hu1 * u1 + 0.5 * GRAVITY * k.h11 * hsq),
                k.sqrtG * (hu2 * u1 + 0.5 * GRAVITY * k.h21 * hsq),
            ]
        )
        fy = jnp.stack(
            [
                k.sqrtG * hu2,
                k.sqrtG * (hu1 * u2 + 0.5 * GRAVITY * k.h12 * hsq),
                k.sqrtG * (hu2 * u2 + 0.5 * GRAVITY * k.h22 * hsq),
            ]
        )
        df = jnp.concatenate([fx, fy], axis=-1) @ k.DD  # x+y divergence sum

        # 4. Left/right states at every x1 interface (nx+1 per element row).
        qL_x = jnp.concatenate([halo_w, itf_x[..., s:].reshape(3, 6, ny, nx, s)], axis=-2)
        qR_x = jnp.concatenate([itf_x[..., :s].reshape(3, 6, ny, nx, s), halo_e], axis=-2)
        qL_y = jnp.concatenate([halo_s, itf_y[..., s:].reshape(3, 6, ny, nx, s)], axis=-3)
        qR_y = jnp.concatenate([itf_y[..., :s].reshape(3, 6, ny, nx, s), halo_n], axis=-3)

        if k.hsurf is not None:
            qL_x = qL_x.at[IDX_H].add(-k.hsurf_ix)
            qR_x = qR_x.at[IDX_H].add(-k.hsurf_ix)
            qL_y = qL_y.at[IDX_H].add(-k.hsurf_jx)
            qR_y = qR_y.at[IDX_H].add(-k.hsurf_jx)

        f_itf_x = ausm_interface_flux(qL_x, qR_x, k.sqrtG_ix, k.h11_ix, k.h21_ix, IDX_HU1)
        f_itf_y = ausm_interface_flux(qL_y, qR_y, k.sqrtG_jx, k.h22_jx, k.h12_jx, IDX_HU2)

        # 5. Boundary-correction GEMM: element faces [west | east] from the
        # per-interface fluxes, then the 2-column correction operator.
        faces_x = jnp.concatenate([f_itf_x[..., :-1, :], f_itf_x[..., 1:, :]], axis=-1)  # (3,6,ny,nx,2s)
        faces_y = jnp.concatenate([f_itf_y[..., :-1, :, :], f_itf_y[..., 1:, :, :]], axis=-1)

        df = df + jnp.concatenate([faces_x, faces_y], axis=-1) @ k.CC

        # 6. Coriolis / Christoffel / topography-gradient forcing
        # (christoffel_1_22 and christoffel_2_11 vanish identically).
        tz1 = k.dzdx1 if k.hsurf is not None else 0.0
        tz2 = k.dzdx2 if k.hsurf is not None else 0.0
        forcing_1 = (
            2.0 * (k.chr_1_01 * hu1 + k.chr_1_02 * hu2)
            + k.chr_1_11 * hu1 * u1
            + 2.0 * k.chr_1_12 * hu1 * u2
            + GRAVITY * h * (k.h11 * tz1 + k.h12 * tz2)
        )
        forcing_2 = (
            2.0 * (k.chr_2_01 * hu1 + k.chr_2_02 * hu2)
            + 2.0 * k.chr_2_12 * hu1 * u2
            + k.chr_2_22 * hu2 * u2
            + GRAVITY * h * (k.h21 * tz1 + k.h22 * tz2)
        )
        forcing = jnp.stack([jnp.zeros_like(forcing_1), forcing_1, forcing_2])

        return k.inv_sqrtG * (-df) - forcing


    rhs = Partial(rhs_fn, cst)
    if perturbation_base is None:
        return rhs

    # --- Perturbation-form (base-state-split) operator -----------------
    # Base intermediates in float64 (one-time factory cost), cast to the
    # working dtype; the runtime path evaluates only the TERM-LEVEL delta
    # expansion below (see module docstring of the absolute form and the
    # 3D twin models/euler_cubesphere.py _euler3d_rhs_core_pert).
    f64 = jnp.float64
    q0_64 = jnp.asarray(perturbation_base, f64)
    EE64 = jnp.asarray(np.concatenate([ops.extrap_x, ops.extrap_z], axis=1), f64)
    ny = nx = nel
    h0_tot = q0_64[IDX_H] + jnp.asarray(topo.hsurf, f64) if topo is not None else q0_64[IDX_H]
    itf0 = jnp.stack([h0_tot, q0_64[IDX_HU1], q0_64[IDX_HU2]]) @ EE64
    itf_x0, itf_y0 = itf0[..., : 2 * s], itf0[..., 2 * s :]
    hh0 = topology.halo_scalars(itf_x0[IDX_H], itf_y0[IDX_H])
    uh0 = topology.halo_vectors(
        itf_x0[IDX_HU1], itf_y0[IDX_HU1], itf_x0[IDX_HU2], itf_y0[IDX_HU2]
    )

    def halo_q0(side, shape):
        return jnp.stack([hh0[side], uh0[side][0], uh0[side][1]]).reshape((3,) + shape)

    qL_x0 = jnp.concatenate(
        [halo_q0(WEST, (6, ny, 1, s)), itf_x0[..., s:].reshape(3, 6, ny, nx, s)], axis=-2
    )
    qR_x0 = jnp.concatenate(
        [itf_x0[..., :s].reshape(3, 6, ny, nx, s), halo_q0(EAST, (6, ny, 1, s))], axis=-2
    )
    qL_y0 = jnp.concatenate(
        [halo_q0(SOUTH, (6, 1, nx, s)), itf_y0[..., s:].reshape(3, 6, ny, nx, s)], axis=-3
    )
    qR_y0 = jnp.concatenate(
        [itf_y0[..., :s].reshape(3, 6, ny, nx, s), halo_q0(NORTH, (6, 1, nx, s))], axis=-3
    )
    if topo is not None:
        hs_ix = jnp.asarray(topo.hsurf_itf_x1, f64)
        hs_jx = jnp.asarray(topo.hsurf_itf_x2, f64)
        qL_x0 = qL_x0.at[IDX_H].add(-hs_ix)
        qR_x0 = qR_x0.at[IDX_H].add(-hs_ix)
        qL_y0 = qL_y0.at[IDX_H].add(-hs_jx)
        qR_y0 = qR_y0.at[IDX_H].add(-hs_jx)

    # f64 base RHS through the absolute operator (this factory, f64, XLA).
    rhs64 = (
        rhs
        if dtype == f64
        else make_rhs_shallow_water(geom, ops, metric, topo=topo, dtype=f64)
    )
    base = SWBase(
        rhs0=c(rhs64(q0_64)), q0=c(q0_64),
        u10=c(q0_64[IDX_HU1] / q0_64[IDX_H]), u20=c(q0_64[IDX_HU2] / q0_64[IDX_H]),
        Lx0=c(qL_x0), Rx0=c(qR_x0), Ly0=c(qL_y0), Ry0=c(qR_y0),
    )

    def ausm_delta(qL0, qR0, dqL, dqR, sg, hd, ho, normal):
        """Term-level delta of ``ausm_interface_flux`` around (qL0, qR0):
        every product is expanded via d(ab) = da*b + a0*db (exact), the
        sound speed via d(sqrt) = hd*g*dh/(a+a0), and the Mach ratios by
        direct subtraction (smooth state ratios — no large-term
        cancellation). Returns the interface-flux delta."""
        hL0, hR0 = qL0[IDX_H], qR0[IDX_H]
        dhL, dhR = dqL[IDX_H], dqR[IDX_H]
        hL, hR = hL0 + dhL, hR0 + dhR
        aL0 = jnp.sqrt(GRAVITY * hL0 * hd)
        aR0 = jnp.sqrt(GRAVITY * hR0 * hd)
        aL = jnp.sqrt(GRAVITY * hL * hd)
        aR = jnp.sqrt(GRAVITY * hR * hd)
        daL = jnp.where(aL + aL0 > 0.0, GRAVITY * hd * dhL / (aL + aL0), 0.0)
        daR = jnp.where(aR + aR0 > 0.0, GRAVITY * hd * dhR / (aR + aR0), 0.0)
        qn0L, qn0R = qL0[normal], qR0[normal]
        tmpL0, tmpL = hL0 * aL0, hL * aL
        tmpR0, tmpR = hR0 * aR0, hR * aR
        mL0 = jnp.where(tmpL0 != 0.0, qn0L / tmpL0, 0.0)
        mR0 = jnp.where(tmpR0 != 0.0, qn0R / tmpR0, 0.0)
        mL = jnp.where(tmpL != 0.0, (qn0L + dqL[normal]) / tmpL, 0.0)
        mR = jnp.where(tmpR != 0.0, (qn0R + dqR[normal]) / tmpR, 0.0)
        dmL, dmR = mL - mL0, mR - mR0
        M0 = 0.25 * ((mL0 + 1.0) ** 2 - (mR0 - 1.0) ** 2)
        dM = 0.25 * ((mL + mL0 + 2.0) * dmL - (mR + mR0 - 2.0) * dmR)
        M = M0 + dM
        P0 = jnp.maximum(0.0, M0)
        dP = jnp.maximum(0.0, M) - P0
        N0 = jnp.minimum(0.0, M0)
        dN = jnp.minimum(0.0, M) - N0
        qL, qR = qL0 + dqL, qR0 + dqR
        dflux = sg * (
            dP * aL * qL + P0 * (daL * qL + aL0 * dqL)
            + dN * aR * qR + N0 * (daR * qR + aR0 * dqR)
        )
        rows = (IDX_HU1, IDX_HU2) if normal == IDX_HU1 else (IDX_HU2, IDX_HU1)
        dterm = (
            dmL * hL**2 + (1.0 + mL0) * (hL + hL0) * dhL
            - dmR * hR**2 + (1.0 - mR0) * (hR + hR0) * dhR
        )
        dpres = (0.25 * GRAVITY) * sg * dterm
        dflux = dflux.at[rows[0]].add(hd * dpres)
        dflux = dflux.at[rows[1]].add(ho * dpres)
        return dflux

    def delta_core(k: SWConstants, b: SWBase, dq: jnp.ndarray) -> jnp.ndarray:
        h0, hu10, hu20 = b.q0[IDX_H], b.q0[IDX_HU1], b.q0[IDX_HU2]
        tz1 = k.dzdx1 if k.hsurf is not None else 0.0
        tz2 = k.dzdx2 if k.hsurf is not None else 0.0
        dh, dhu1, dhu2 = dq[IDX_H], dq[IDX_HU1], dq[IDX_HU2]
        h = h0 + dh
        du1 = (dhu1 - b.u10 * dh) / h
        du2 = (dhu2 - b.u20 * dh) / h
        u1, u2 = b.u10 + du1, b.u20 + du2

        d_itf = dq @ k.EE  # extrapolation is linear; topography rides the base
        d_itf_x, d_itf_y = d_itf[..., : 2 * s], d_itf[..., 2 * s :]
        dhh = topology.halo_scalars(d_itf_x[IDX_H], d_itf_y[IDX_H])
        duh = topology.halo_vectors(
            d_itf_x[IDX_HU1], d_itf_y[IDX_HU1], d_itf_x[IDX_HU2], d_itf_y[IDX_HU2]
        )

        def dhalo(side, shape):
            return jnp.stack([dhh[side], duh[side][0], duh[side][1]]).reshape((3,) + shape)

        half_g = 0.5 * GRAVITY
        hph0 = h + h0
        dfx = jnp.stack(
            [
                k.sqrtG * dhu1,
                k.sqrtG * (dhu1 * u1 + hu10 * du1 + half_g * k.h11 * hph0 * dh),
                k.sqrtG * (dhu2 * u1 + hu20 * du1 + half_g * k.h21 * hph0 * dh),
            ]
        )
        dfy = jnp.stack(
            [
                k.sqrtG * dhu2,
                k.sqrtG * (dhu1 * u2 + hu10 * du2 + half_g * k.h12 * hph0 * dh),
                k.sqrtG * (dhu2 * u2 + hu20 * du2 + half_g * k.h22 * hph0 * dh),
            ]
        )
        ddf = jnp.concatenate([dfx, dfy], axis=-1) @ k.DD

        dqL_x = jnp.concatenate(
            [dhalo(WEST, (6, ny, 1, s)), d_itf_x[..., s:].reshape(3, 6, ny, nx, s)], axis=-2
        )
        dqR_x = jnp.concatenate(
            [d_itf_x[..., :s].reshape(3, 6, ny, nx, s), dhalo(EAST, (6, ny, 1, s))], axis=-2
        )
        dqL_y = jnp.concatenate(
            [dhalo(SOUTH, (6, 1, nx, s)), d_itf_y[..., s:].reshape(3, 6, ny, nx, s)], axis=-3
        )
        dqR_y = jnp.concatenate(
            [d_itf_y[..., :s].reshape(3, 6, ny, nx, s), dhalo(NORTH, (6, 1, nx, s))], axis=-3
        )

        df_itf_x = ausm_delta(b.Lx0, b.Rx0, dqL_x, dqR_x, k.sqrtG_ix, k.h11_ix, k.h21_ix, IDX_HU1)
        df_itf_y = ausm_delta(b.Ly0, b.Ry0, dqL_y, dqR_y, k.sqrtG_jx, k.h22_jx, k.h12_jx, IDX_HU2)
        faces_x = jnp.concatenate([df_itf_x[..., :-1, :], df_itf_x[..., 1:, :]], axis=-1)
        faces_y = jnp.concatenate([df_itf_y[..., :-1, :, :], df_itf_y[..., 1:, :, :]], axis=-1)
        ddf = ddf + jnp.concatenate([faces_x, faces_y], axis=-1) @ k.CC

        dforcing_1 = (
            2.0 * (k.chr_1_01 * dhu1 + k.chr_1_02 * dhu2)
            + k.chr_1_11 * (dhu1 * u1 + hu10 * du1)
            + 2.0 * k.chr_1_12 * (dhu1 * u2 + hu10 * du2)
            + GRAVITY * dh * (k.h11 * tz1 + k.h12 * tz2)
        )
        dforcing_2 = (
            2.0 * (k.chr_2_01 * dhu1 + k.chr_2_02 * dhu2)
            + 2.0 * k.chr_2_12 * (dhu1 * u2 + hu10 * du2)
            + k.chr_2_22 * (dhu2 * u2 + hu20 * du2)
            + GRAVITY * dh * (k.h21 * tz1 + k.h22 * tz2)
        )
        dforcing = jnp.stack([jnp.zeros_like(dforcing_1), dforcing_1, dforcing_2])
        return k.inv_sqrtG * (-ddf) - dforcing

    def pert_fn(k: SWConstants, b: SWBase, q: jnp.ndarray) -> jnp.ndarray:
        return b.rhs0 + delta_core(k, b, q - b.q0)

    def delta_fn(k: SWConstants, b: SWBase, qprime: jnp.ndarray) -> jnp.ndarray:
        """RHS at ``q0 + qprime`` with the perturbation passed directly
        (full working-dtype resolution — no absolute-state quantization)."""
        return b.rhs0 + delta_core(k, b, qprime)

    rhs_pert = Partial(pert_fn, cst, base)
    rhs_pert.xla = rhs
    rhs_pert.delta = Partial(delta_fn, cst, base)
    rhs_pert.base_state = base.q0
    return rhs_pert
