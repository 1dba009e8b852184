"""p-Multigrid preconditioner for the implicit/rational system.

Capability parity with the reference's precondition/multigrid.py +
smoother.py + common/interpolation.py: a V-cycle over polynomial orders
p -> p-1 -> ... -> 1, each level with its own geometry/operators/RHS,
modal-projection transfers (ops.dfr.remesh_operator), and pseudo-time
Runge-Kutta / Chebyshev / exponential smoothers. The reference keeps this
component gated off at run time (simulation.py:274-275 there raises); here
it is functional for the 2D Cartesian Euler system, the cubed-sphere
shallow-water system, and the cubed-sphere 3D Euler system, exposed
through the same config fields (num_mg_levels, num_pre/post_smoothe,
pseudo_cfl, mg_smoother, mg_solve_coarsest).

Each level's RHS comes from a model-specific factory (reference
multigrid.py:38-165 builds per-level geometry/metric/RHS the same way);
the preconditioned operator is the rational system A = I - dt/2 J with
J the exact jvp of the level RHS around the restricted state.
"""

from typing import Callable, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.dfr import make_dfr_operators, remesh_operator
from ..ops.quadrature import gauss_legendre


def _remesh_nd(src_pts, dst_pts, dim: int) -> np.ndarray:
    """Tensor-product modal transfer acting on the trailing s^dim axis."""
    r1 = remesh_operator(src_pts, dst_pts)
    out = r1
    for _ in range(dim - 1):
        out = np.kron(out, r1)
    return out.T  # applied as q @ op


def dg_fv_interpolators(num_solpts: int):
    """1D DG<->FV transfer pair for one element (reference Interpolator,
    common/interpolation.py:154-289, 'modal'/'lagrange' flavor): M maps the
    s Lagrange nodal values to the s cell MEANS of the interpolant on an
    equal subdivision of [-1, 1]; its inverse reconstructs the nodal values
    exactly (both square, so the round trip is exact)."""
    s = num_solpts
    _, pts, _ = gauss_legendre(s)
    qx, qw = np.polynomial.legendre.leggauss(s + 2)

    def lagrange(j, x):
        out = np.ones_like(x)
        for m in range(s):
            if m != j:
                out *= (x - pts[m]) / (pts[j] - pts[m])
        return out

    h = 2.0 / s
    M = np.zeros((s, s))
    for i in range(s):
        a = -1.0 + i * h
        xq = a + 0.5 * h * (qx + 1.0)
        for j in range(s):
            M[i, j] = 0.5 * np.sum(qw * lagrange(j, xq))  # (1/h)*integral
    return M, np.linalg.inv(M)


def cartesian_euler_levels(geom) -> tuple:
    """(factory, transfer_dim, min_order) for the 2D Cartesian Euler model;
    order 1 runs the finite-volume RHS (the reference's FV-MG bottom)."""
    from ..geometry.cartesian import make_cartesian_2d
    from ..models.euler_cartesian import make_rhs_euler_cartesian
    from ..models.euler_cartesian_fv import make_rhs_euler_cartesian_fv

    def make(p: int):
        g = make_cartesian_2d(
            geom.domain_x, geom.domain_z, geom.num_elements_x, geom.num_elements_z, max(p, 1)
        )
        if p >= 2:
            return make_rhs_euler_cartesian(g, make_dfr_operators(p))
        base = make_rhs_euler_cartesian_fv(g)
        return lambda q: base(q[..., 0])[..., None]

    return make, 2, 1


def cubed_sphere_sw_levels(geom) -> tuple:
    """(factory, transfer_dim, min_order) for cubed-sphere shallow water.
    Coarse levels rebuild geometry + metric + RHS at lower order over the
    same element grid (topography is not carried to coarse levels — the
    preconditioner only needs an approximate inverse)."""
    from ..geometry import make_cubed_sphere_2d, make_metric_2d
    from ..models import make_rhs_shallow_water

    def make(p: int):
        g = make_cubed_sphere_2d(geom.num_elements, p, geom.lambda0, geom.phi0, geom.alpha0)
        ops = make_dfr_operators(p)
        metric = make_metric_2d(g)
        return make_rhs_shallow_water(g, ops, metric)

    return make, 2, 2


def cubed_sphere_euler3d_levels(geom) -> tuple:
    """(factory, transfer_dim, min_order) for cubed-sphere 3D Euler."""
    from ..geometry import make_cubed_sphere_3d, make_metric_3d
    from ..models import make_rhs_euler_cubesphere
    from ..parallel.topology import CubedSphereTopology

    def make(p: int):
        g = make_cubed_sphere_3d(
            geom.nel_h, geom.nel_v, p, geom.ztop, geom.lambda0, geom.phi0, geom.alpha0,
            deep=geom.deep,
        )
        ops = make_dfr_operators(p, three_d=True)
        topo = CubedSphereTopology(g)
        metric = make_metric_3d(g, ops, topo)
        return make_rhs_euler_cubesphere(g, ops, metric, topo)

    return make, 3, 2


def dg_fv_transfer(num_solpts: int, n_cells: int):
    """Rectangular 1D DG->FV transfer pair (reference Interpolator with
    order change, common/interpolation.py:154-289): R (n_cells, s) takes the
    s Lagrange nodal values to the n_cells cell MEANS of the interpolant on
    an equal subdivision of [-1, 1] (exact for polynomials of degree < s);
    P (s, n_cells) is its Moore-Penrose reconstruction (least-squares nodal
    values; exact round trip when n_cells == s)."""
    s = num_solpts
    _, pts, _ = gauss_legendre(s)
    qx, qw = np.polynomial.legendre.leggauss(s + 2)

    def lagrange(j, x):
        out = np.ones_like(x)
        for m in range(s):
            if m != j:
                out *= (x - pts[m]) / (pts[j] - pts[m])
        return out

    h = 2.0 / n_cells
    R = np.zeros((n_cells, s))
    for i in range(n_cells):
        a = -1.0 + i * h
        xq = a + 0.5 * h * (qx + 1.0)
        for j in range(s):
            R[i, j] = 0.5 * np.sum(qw * lagrange(j, xq))
    return R, np.linalg.pinv(R)


def cubed_sphere_sw_fv_mg_levels(geom, num_solpts: int, max_levels: int = 8):
    """FV-agglomeration multigrid family for cubed-sphere shallow water
    (reference precondition/multigrid.py:297-339, discretization='fv'):

    * level 0: the DG(s) operator on the nel-element grid;
    * level 1: the SAME RHS machinery at num_solpts=1 (pure FV: zero
      derivative matrix, interface fluxes only — exactly the reference's
      `param.num_elements_horizontal *= num_solpts; num_solpts = 1`) on an
      (nel * sp)-element grid, sp = 2^floor(log2 s), reached through the
      per-element DG->FV cell-mean transfer;
    * level k>=2: FV with 2x horizontal agglomeration per level (cell means
      down, constant injection up) while sp/2^k >= 1.

    Returns (levels, restricts, prolongs) for Multigrid(level_spec=...)."""
    from ..geometry import make_cubed_sphere_2d, make_metric_2d
    from ..models import make_rhs_shallow_water

    s = num_solpts
    nel = geom.num_elements
    sp = 2 ** int(np.log2(s))

    def fv_rhs(c):
        g = make_cubed_sphere_2d(nel * c, 1, geom.lambda0, geom.phi0, geom.alpha0)
        ops1 = make_dfr_operators(1)
        metric1 = make_metric_2d(g)
        return make_rhs_shallow_water(g, ops1, metric1)

    levels: List[MultigridLevel] = []
    restricts = []
    prolongs = []
    if s >= 2:
        from ..ops.dfr import make_dfr_operators as _mk  # level-0 DG operator

        g0 = make_cubed_sphere_2d(nel, s, geom.lambda0, geom.phi0, geom.alpha0)
        m0 = make_metric_2d(g0)
        levels.append(
            MultigridLevel(make_rhs_shallow_water(g0, _mk(s), m0), s)
        )
        r1, p1 = dg_fv_transfer(s, sp)
        # Trailing s^2 point/cell order is (y-major, x-minor), as in the
        # cartesian family.
        dg2fv = jnp.asarray(np.kron(r1, r1).T)
        fv2dg = jnp.asarray(np.kron(p1, p1).T)

        def to_cells(a, dg2fv=dg2fv):
            # (nv, 6, nel, nel, s^2) -> (nv, 6, nel*sp, nel*sp, 1)
            c = (a @ dg2fv).reshape(a.shape[:-1] + (sp, sp))
            c = jnp.moveaxis(c, -2, -3)  # (nv, 6, nel, sp, nel, sp)
            return c.reshape(a.shape[0], 6, nel * sp, nel * sp, 1)

        def to_nodes(a, fv2dg=fv2dg):
            c = a.reshape(a.shape[0], 6, nel, sp, nel, sp)
            c = jnp.moveaxis(c, 3, 4).reshape(a.shape[0], 6, nel, nel, sp * sp)
            return c @ fv2dg

        restricts.append(to_cells)
        prolongs.append(to_nodes)

    c = sp
    levels.append(MultigridLevel(fv_rhs(c), 1, tau_scale=4.0 * nel * c))
    while len(levels) < max_levels and c % 2 == 0 and nel * c >= 4:
        c //= 2
        levels.append(MultigridLevel(fv_rhs(c), 1, tau_scale=4.0 * nel * c))

        def agg(a):
            nv, _, ny, nx, _ = a.shape
            return a.reshape(nv, 6, ny // 2, 2, nx // 2, 2, 1).mean(axis=(3, 5))

        def inj(a):
            return jnp.repeat(jnp.repeat(a, 2, axis=2), 2, axis=3)

        restricts.append(agg)
        prolongs.append(inj)
    return levels, restricts, prolongs


def cartesian_fv_mg_levels(geom, num_solpts: int, max_levels: int = 8):
    """FV-agglomeration multigrid family for the 2D Cartesian Euler system
    (reference precondition/multigrid.py:38-165, discretization 'fv'):

    * level 0: the DG(p) operator on the element grid;
    * level 1: an FV operator on the (nel*p) sub-cell grid, reached through
      the per-element DG->FV cell-mean transfer (dg_fv_interpolators —
      the reference's Interpolator role);
    * level k>=2: FV with 2x element agglomeration per level (cell means
      down, constant injection up) while the cell counts stay even.

    Returns (levels, restricts, prolongs) for Multigrid(level_spec=...).
    """
    from ..geometry.cartesian import make_cartesian_2d
    from ..models.euler_cartesian import make_rhs_euler_cartesian
    from ..models.euler_cartesian_fv import make_rhs_euler_cartesian_fv

    s = num_solpts
    nelx, nelz = geom.num_elements_x, geom.num_elements_z

    def fv_rhs(ncx, ncz):
        g = make_cartesian_2d(geom.domain_x, geom.domain_z, ncx, ncz, 1)
        base = make_rhs_euler_cartesian_fv(g)
        return lambda q: base(q[..., 0])[..., None]

    levels = []
    restricts = []
    prolongs = []
    if s >= 2:
        levels.append(MultigridLevel(make_rhs_euler_cartesian(geom, make_dfr_operators(s)), s))
        m1, m1inv = dg_fv_interpolators(s)
        dg2fv = jnp.asarray(np.kron(m1, m1).T)  # trailing (z, x) point order
        fv2dg = jnp.asarray(np.kron(m1inv, m1inv).T)

        def to_cells(a, dg2fv=dg2fv):
            # (nv, nelz, nelx, s^2) -> (nv, nelz*s, nelx*s, 1)
            c = (a @ dg2fv).reshape(a.shape[:-1] + (s, s))
            c = jnp.moveaxis(c, -2, -3)  # (nv, nelz, s, nelx, s)
            return c.reshape(a.shape[0], nelz * s, nelx * s, 1)

        def to_nodes(a, fv2dg=fv2dg):
            c = a.reshape(a.shape[0], nelz, s, nelx, s)
            c = jnp.moveaxis(c, 2, 3).reshape(a.shape[0], nelz, nelx, s * s)
            return c @ fv2dg

        restricts.append(to_cells)
        prolongs.append(to_nodes)

    ncx, ncz = nelx * s, nelz * s
    levels.append(MultigridLevel(fv_rhs(ncx, ncz), 1, tau_scale=4.0 * max(ncx, ncz)))
    while len(levels) < max_levels and ncx % 2 == 0 and ncz % 2 == 0 and min(ncx, ncz) >= 4:
        ncx //= 2
        ncz //= 2
        levels.append(MultigridLevel(fv_rhs(ncx, ncz), 1, tau_scale=4.0 * max(ncx, ncz)))

        def agg(a):
            nv, nz, nx, _ = a.shape
            return a.reshape(nv, nz // 2, 2, nx // 2, 2, 1).mean(axis=(2, 4))

        def inj(a, nz=ncz, nx=ncx):
            return jnp.repeat(jnp.repeat(a, 2, axis=1), 2, axis=2)

        restricts.append(agg)
        prolongs.append(inj)
    return levels, restricts, prolongs


class MultigridLevel:
    def __init__(self, rhs: Callable, num_solpts: int, tau_scale: Optional[float] = None):
        self.num_solpts = num_solpts
        # Pseudo-time-step scale override: 4*nel*p^2 equivalent. FV levels
        # set it to 4*(cell count) — their resolution is nel*p cells, which
        # the (element count, order) formula under-counts.
        self.tau_scale = tau_scale
        self.rhs = rhs

        @jax.jit
        def rat(q, v, half_dt):
            return v - half_dt * jax.jvp(self.rhs, (q,), (v,))[1]

        self._rat = rat
        self.state = None
        self.half_dt = 0.0

    def apply_A(self, v):
        return self._rat(self.state, v, self.half_dt)


class Multigrid:
    """V-cycle preconditioner; callable on flat vectors (FGMRES contract).

    `level_spec` is (factory, transfer_dim, min_order) — see the
    *_levels builders above; `Multigrid.for_geometry` picks one by type.
    """

    def __init__(
        self,
        level_spec,
        num_solpts: int,
        num_levels: int = 2,
        num_pre_smoothe: int = 1,
        num_post_smoothe: int = 1,
        pseudo_cfl: float = 5.0,
        smoother: str = "erk3",
        solve_coarsest: bool = False,
        spectral_radii=None,
        num_elements_pseudo: Optional[int] = None,
    ):
        self.num_pre = num_pre_smoothe
        self.num_post = num_post_smoothe
        self.pseudo_cfl = pseudo_cfl
        self.smoother = smoother
        self.solve_coarsest = solve_coarsest
        self.spectral_radii = list(spectral_radii or [2.0])
        # Element count entering the pseudo-time-step CFL estimate.
        self.num_elements_pseudo = num_elements_pseudo or 16

        if isinstance(level_spec, tuple) and len(level_spec) == 3 and callable(level_spec[0]):
            # p-MG family: (factory, transfer_dim, min_order); transfers are
            # modal remesh matrices on the trailing s^dim axis.
            factory, dim, min_order = level_spec
            orders = []
            for i in range(num_levels):
                p = num_solpts - i
                if p < min_order:
                    break
                orders.append(p)
            self.levels: List[MultigridLevel] = [MultigridLevel(factory(p), p) for p in orders]
            self.restricts = []
            self.prolongs = []
            for fine, coarse in zip(self.levels[:-1], self.levels[1:]):
                _, fine_pts, _ = gauss_legendre(fine.num_solpts)
                _, coarse_pts, _ = gauss_legendre(coarse.num_solpts)
                r = jnp.asarray(_remesh_nd(fine_pts, coarse_pts, dim))
                p_ = jnp.asarray(_remesh_nd(coarse_pts, fine_pts, dim))
                self.restricts.append(lambda a, r=r: a @ r)
                self.prolongs.append(lambda a, p_=p_: a @ p_)
        else:
            # Prebuilt family (FV agglomeration): (levels, restricts, prolongs).
            self.levels, self.restricts, self.prolongs = level_spec
            self.levels = list(self.levels[:num_levels])
            self.restricts = list(self.restricts[: len(self.levels) - 1])
            self.prolongs = list(self.prolongs[: len(self.levels) - 1])

        self.shape = None

    @classmethod
    def for_geometry(cls, geom, kind: str = "p-mg", **kwargs):
        """Pick the level family from the geometry type. ``kind``: "p-mg"
        (order coarsening) or "fv-mg" (DG->FV + 2x element agglomeration —
        Cartesian Euler and cubed-sphere shallow water, the reference's
        discretization='fv' gate, multigrid.py:297-339 there)."""
        from ..geometry.cartesian import Cartesian2D
        from ..geometry.cubed_sphere import CubedSphere2D
        from ..geometry.cubed_sphere_3d import CubedSphere3D

        if isinstance(geom, Cartesian2D):
            if kind == "fv-mg":
                nlev = kwargs.get("num_levels", 2)
                spec = cartesian_fv_mg_levels(geom, geom.num_solpts, max_levels=max(nlev, 2))
            else:
                spec = cartesian_euler_levels(geom)
            nel = max(geom.num_elements_x, geom.num_elements_z)
        elif isinstance(geom, CubedSphere2D):
            if kind == "fv-mg":
                nlev = kwargs.get("num_levels", 2)
                spec = cubed_sphere_sw_fv_mg_levels(geom, geom.num_solpts, max_levels=max(nlev, 2))
            else:
                spec = cubed_sphere_sw_levels(geom)
            nel = geom.num_elements
        elif isinstance(geom, CubedSphere3D):
            spec = cubed_sphere_euler3d_levels(geom)
            nel = max(geom.nel_h, geom.nel_v)
        else:
            raise ValueError(f"No multigrid level family for geometry {type(geom).__name__}")
        return cls(spec, geom.num_solpts, num_elements_pseudo=nel, **kwargs)

    # ------------------------------------------------------------------
    def prepare(self, dt: float, q) -> None:
        """Freeze the linearization point on every level."""
        q = jnp.asarray(q)
        self.shape = q.shape
        state = q
        for i, level in enumerate(self.levels):
            level.state = state
            level.half_dt = 0.5 * dt
            if i < len(self.restricts):
                state = self.restricts[i](state)

    def _smooth(self, level: MultigridLevel, x, b, iterations: int):
        """Smoothing of A x = b. Schemes mirror the reference smoother family
        (smoother.py:25-340): erk1/erk3 pseudo-time RK, 'exp' Chebyshev
        iteration over an estimated spectral interval, 'kiops' exponential
        pseudo-time step; 'ark3' runs as erk3 (the additive splitting the
        reference uses there has no separate stiff part in this operator)."""
        scale = level.tau_scale or (4.0 * self.num_elements_pseudo * max(level.num_solpts, 1) ** 2)
        tau = self.pseudo_cfl / scale

        if self.smoother == "exp":
            # Chebyshev smoothing on [lmin, lmax] of A (A = I - dt/2 J is
            # positive-real for dissipative J); radii from the config list.
            idx = min(self.levels.index(level), len(self.spectral_radii) - 1)
            lmax = self.spectral_radii[idx]
            lmin = lmax / 30.0
            theta = 0.5 * (lmax + lmin)
            delta = 0.5 * (lmax - lmin)
            sigma = theta / delta
            rho_prev = 1.0 / sigma
            r = b - level.apply_A(x)
            d = r / theta
            for _ in range(max(iterations, 1) * 3):
                x = x + d
                r = b - level.apply_A(x)
                rho = 1.0 / (2.0 * sigma - rho_prev)
                d = rho * rho_prev * d + 2.0 * rho / delta * r
                rho_prev = rho
            return x + d

        if self.smoother == "kiops":
            # Exponential pseudo-time smoothing: x += tau*phi1(-tau A) r
            # (reference smoother.py KiopsSmoother), at loose tolerance with
            # a tiny Krylov space.
            from ..solvers import kiops as kiops_solver

            shape = x.shape

            def neg_tau_A(v):
                return -tau * np.asarray(level.apply_A(jnp.asarray(v.reshape(shape)))).ravel()

            for _ in range(iterations):
                r = np.asarray(b - level.apply_A(x)).ravel()
                vec = np.zeros((2, r.size))
                vec[1] = tau * r
                w, _stats = kiops_solver([1.0], neg_tau_A, vec, tol=1e-2, m_init=4, mmin=4, mmax=16)
                x = x + jnp.asarray(w[0]).reshape(shape)
            return x

        for _ in range(iterations):
            if self.smoother == "erk1":
                x = x + tau * (b - level.apply_A(x))
            else:  # erk3 / ark3: 3-stage pseudo-time RK (smoother.py RK3)
                r = b - level.apply_A(x)
                x1 = x + tau / 3.0 * r
                r1 = b - level.apply_A(x1)
                x2 = x + 0.5 * tau * r1
                r2 = b - level.apply_A(x2)
                x = x + tau * r2
        return x

    def _cycle(self, idx: int, b):
        level = self.levels[idx]
        x = jnp.zeros_like(b)
        x = self._smooth(level, x, b, self.num_pre)

        if idx + 1 < len(self.levels):
            residual = b - level.apply_A(x)
            b_coarse = self.restricts[idx](residual)
            x_coarse = self._cycle(idx + 1, b_coarse)
            x = x + self.prolongs[idx](x_coarse)
        elif self.solve_coarsest:
            x = self._smooth(level, x, b, 10 * max(self.num_pre, 1))

        return self._smooth(level, x, b, self.num_post)

    def __call__(self, v):
        b = jnp.asarray(v).reshape(self.shape)
        return np.asarray(self._cycle(0, b)).ravel()
