"""2D Cartesian compressible Euler equations (x-z slice, rising-bubble lab).

Capability parity with the reference's pde/pde_euler_cartesian.py plus its
compiled kernels (pde/kernels/pointwise_flux.hpp, riemann_flux.hpp [AUSM],
boundary_flux.hpp [rigid wall]) and the DFR assembly of rhs/rhs_dfr.py:8-46.

Design: no per-point kernels — the pointwise flux and the AUSM
Riemann solve are vectorized elementwise jnp expressions that XLA fuses into
the surrounding extrapolation / derivative / correction GEMMs. The whole RHS
is one pure jittable function ``q -> dq/dt``.

State: ``Q[4, nel_z, nel_x, s^2]`` = [rho, rho*u, rho*w, rho*theta];
in-element node index = kz * s + kx. Interface arrays pack both faces last:
``[..., :s]`` = west/bottom face, ``[..., s:]`` = east/top face.
"""

from typing import Callable, Tuple

import jax.numpy as jnp
import numpy as np
from jax.tree_util import Partial

from ..common.constants import (
    GRAVITY,
    HEAT_CAPACITY_RATIO,
    IDX_2D_RHO,
    IDX_2D_RHO_THETA,
    IDX_2D_RHO_U,
    IDX_2D_RHO_W,
    P0,
    RD,
)
from ..geometry.cartesian import Cartesian2D
from ..ops.dfr import DFROperators


def pressure(rho_theta: jnp.ndarray) -> jnp.ndarray:
    """Equation of state: p = p0 * (Rd * rho*theta / p0)^gamma.

    Written in exp/log form exactly like the reference kernels
    (pointwise_flux.hpp:19) for bit-level-comparable results.
    """
    return P0 * jnp.exp(HEAT_CAPACITY_RATIO * jnp.log((RD / P0) * rho_theta))


def pointwise_fluxes(q: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Elementwise Euler fluxes F_x, F_z at every solution point."""
    rho = q[IDX_2D_RHO]
    rho_u = q[IDX_2D_RHO_U]
    rho_w = q[IDX_2D_RHO_W]
    rho_theta = q[IDX_2D_RHO_THETA]

    inv_rho = 1.0 / rho
    u = rho_u * inv_rho
    w = rho_w * inv_rho
    p = pressure(rho_theta)

    flux_x = jnp.stack([rho_u, rho_u * u + p, rho_u * w, rho_theta * u])
    flux_z = jnp.stack([rho_w, rho_w * u, rho_w * w + p, rho_theta * w])
    return flux_x, flux_z


def ausm_flux(ql: jnp.ndarray, qr: jnp.ndarray, direction: int) -> jnp.ndarray:
    """AUSM interface flux between left/right Euler states.

    `ql`, `qr`: (4, ...) face states. `direction`: 0 = x, 1 = z.
    Same Mach-splitting scheme as the reference's riemann_flux.hpp:6-80.
    """
    rho_l, rho_r = ql[IDX_2D_RHO], qr[IDX_2D_RHO]
    rho_u_l, rho_u_r = ql[IDX_2D_RHO_U], qr[IDX_2D_RHO_U]
    rho_w_l, rho_w_r = ql[IDX_2D_RHO_W], qr[IDX_2D_RHO_W]
    rho_t_l, rho_t_r = ql[IDX_2D_RHO_THETA], qr[IDX_2D_RHO_THETA]

    inv_rho_l = 1.0 / rho_l
    inv_rho_r = 1.0 / rho_r
    p_l = pressure(rho_t_l)
    p_r = pressure(rho_t_r)
    a_l = jnp.sqrt(HEAT_CAPACITY_RATIO * p_l * inv_rho_l)
    a_r = jnp.sqrt(HEAT_CAPACITY_RATIO * p_r * inv_rho_r)

    if direction == 0:
        vn_l = rho_u_l * inv_rho_l
        vn_r = rho_u_r * inv_rho_r
    else:
        vn_l = rho_w_l * inv_rho_l
        vn_r = rho_w_r * inv_rho_r

    m_l = vn_l / a_l + 1.0
    m_r = vn_r / a_r - 1.0
    m = 0.25 * (m_l * m_l - m_r * m_r)
    m_max = jnp.maximum(0.0, m) * a_l
    m_min = jnp.minimum(0.0, m) * a_r

    f_rho = rho_l * m_max + rho_r * m_min
    f_theta = rho_t_l * m_max + rho_t_r * m_min
    p_half = 0.5 * (m_l * p_l - m_r * p_r)
    if direction == 0:
        f_rho_u = p_half
        f_rho_w = rho_w_l * m_max + rho_w_r * m_min
    else:
        f_rho_u = rho_u_l * m_max + rho_u_r * m_min
        f_rho_w = p_half
    return jnp.stack([f_rho, f_rho_u, f_rho_w, f_theta])


def wall_flux(q_face: jnp.ndarray, direction: int) -> jnp.ndarray:
    """Rigid-wall boundary flux: only the pressure term in the normal momentum
    equation survives (reference boundary_flux.hpp:4-24)."""
    p = pressure(q_face[IDX_2D_RHO_THETA])
    zero = jnp.zeros_like(p)
    if direction == 0:
        return jnp.stack([zero, p, zero, zero])
    return jnp.stack([zero, zero, p, zero])


def make_rhs_euler_cartesian(
    geom: Cartesian2D, ops: DFROperators, dtype=jnp.float64
) -> Callable[[jnp.ndarray], jnp.ndarray]:
    """Build the jittable DFR right-hand side for the 2D Cartesian Euler system.

    Stage structure mirrors the reference's 9-stage RHS template
    (rhs/rhs.py:75-122) minus communication (this grid is single-shard):
    extrapolate -> pointwise flux -> interior derivative -> Riemann (AUSM)
    + wall BCs -> boundary correction -> gravity forcing.

    The RHS is a ``jax.tree_util.Partial`` whose leaves are its operator
    blocks, as in the cubed-sphere models.
    """
    s = ops.num_solpts

    scale_x = -2.0 / geom.delta_x1
    scale_z = -2.0 / geom.delta_x3

    # Fused operator blocks (one GEMM per stage instead of one per
    # direction); the reference-element scales -2/dx fold into the stacked
    # derivative/correction operators so the x+z divergence comes out of the
    # contraction already summed.
    EE = jnp.asarray(np.concatenate([ops.extrap_x, ops.extrap_z], axis=1), dtype=dtype)
    DD = jnp.asarray(
        np.concatenate([scale_x * ops.derivative_x, scale_z * ops.derivative_z], axis=0), dtype=dtype
    )
    CC = jnp.asarray(
        np.concatenate([scale_x * ops.correction_WE, scale_z * ops.correction_DU], axis=0), dtype=dtype
    )

    def rhs_fn(blocks, q: jnp.ndarray) -> jnp.ndarray:
        EE, DD, CC = blocks
        # 1. Extrapolate the solution to all four element faces (one GEMM).
        itf = q @ EE  # (4, nz, nx, 4s)
        q_itf_x = itf[..., : 2 * s]
        q_itf_z = itf[..., 2 * s :]

        # 2+3. Pointwise fluxes, then the scaled x+z interior divergence in
        # one direction-concatenated GEMM.
        f_x, f_z = pointwise_fluxes(q)
        df = jnp.concatenate([f_x, f_z], axis=-1) @ DD

        # 4. Riemann solve at the element interfaces + rigid-wall boundaries.
        # x-direction: left state = east face of element j, right state = west
        # face of element j+1.
        f_interior_x = ausm_flux(q_itf_x[..., :-1, s:], q_itf_x[..., 1:, :s], 0)
        f_wall_w = wall_flux(q_itf_x[..., 0:1, :s], 0)
        f_wall_e = wall_flux(q_itf_x[..., -1:, s:], 0)
        f_itf_x = jnp.concatenate(
            [
                jnp.concatenate([f_wall_w, f_interior_x], axis=-2),  # west faces
                jnp.concatenate([f_interior_x, f_wall_e], axis=-2),  # east faces
            ],
            axis=-1,
        )

        # z-direction: bottom/top faces.
        f_interior_z = ausm_flux(q_itf_z[..., :-1, :, s:], q_itf_z[..., 1:, :, :s], 1)
        f_wall_b = wall_flux(q_itf_z[..., 0:1, :, :s], 1)
        f_wall_t = wall_flux(q_itf_z[..., -1:, :, s:], 1)
        f_itf_z = jnp.concatenate(
            [
                jnp.concatenate([f_wall_b, f_interior_z], axis=-3),
                jnp.concatenate([f_interior_z, f_wall_t], axis=-3),
            ],
            axis=-1,
        )

        # 5. Boundary correction completes the flux divergence (one GEMM for
        # both directions, scales already folded in).
        out = df + jnp.concatenate([f_itf_x, f_itf_z], axis=-1) @ CC

        # 6. Gravity source on vertical momentum.
        return out.at[IDX_2D_RHO_W].add(-q[IDX_2D_RHO] * GRAVITY)

    return Partial(rhs_fn, (EE, DD, CC))
