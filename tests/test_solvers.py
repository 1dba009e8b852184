"""Solver unit tests vs scipy, modeled on the reference's
tests/unit/solvers/* (fgmres vs scipy gmres, kiops vs exact phi functions,
kiops/pmex cross-agreement at tolerance)."""

import numpy as np
import pytest
import scipy.linalg
import scipy.sparse.linalg

from wxfactory_tpu.solvers import fgmres, kiops, pmex


def _random_system(n=200, seed=0, density=0.5, diag_shift=None):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)) / np.sqrt(n)
    if diag_shift is None:
        diag_shift = 2.0
    a += diag_shift * np.eye(n)
    b = rng.standard_normal(n)
    return a, b


def _phi_exact(a, tau, u):
    """Exact phi combination via the augmented-matrix identity:
    w = sum_k phi_k(tau*A) u_k computed with one big expm."""
    ppo, n = u.shape
    p = ppo - 1
    if p == 0:
        p = 1
        u = np.vstack((u, np.zeros(n)))
    aug = np.zeros((n + p, n + p))
    aug[:n, :n] = tau * a
    aug[:n, n] = tau * u[-1]
    for k in range(1, p):
        aug[:n, n + k] = tau * u[p - k]
        aug[n + k - 1, n + k] = tau
    big = scipy.linalg.expm(aug)
    e = np.zeros(n + p)
    e[n + p - 1] = 1.0
    return big[:n, :] @ e + big[:n, :n] @ u[0]


class TestKiops:
    @pytest.mark.parametrize("p", [0, 1, 3])
    def test_matches_exact_phi(self, p):
        n = 120
        rng = np.random.default_rng(7)
        a = -np.diag(np.linspace(0.5, 30.0, n)) + 0.1 * rng.standard_normal((n, n))
        u = rng.standard_normal((p + 1, n))
        w, stats = kiops([1.0], lambda v: a @ v, u, tol=1e-10, mmin=10, mmax=64)
        exact = _phi_exact(a, 1.0, u.copy())
        err = np.linalg.norm(w[0] - exact) / np.linalg.norm(exact)
        assert err < 1e-8, (err, stats)

    def test_multiple_tau_out(self):
        n = 80
        rng = np.random.default_rng(3)
        a = -np.diag(np.linspace(0.5, 10.0, n))
        u = rng.standard_normal((2, n))
        taus = [0.25, 0.5, 1.0]
        w, _ = kiops(taus, lambda v: a @ v, u, tol=1e-10)
        for i, t in enumerate(taus):
            exact = _phi_exact(a, t, u.copy())
            assert np.linalg.norm(w[i] - exact) / np.linalg.norm(exact) < 1e-7

    def test_stiff_substepping(self):
        # Very stiff operator forces tau-substepping; result must stay accurate
        n = 100
        a = -np.diag(np.logspace(0, 3.2, n))
        u = np.ones((2, n))
        w, stats = kiops([1.0], lambda v: a @ v, u, tol=1e-9, mmax=32)
        exact = _phi_exact(a, 1.0, u.copy())
        assert np.linalg.norm(w[0] - exact) / np.linalg.norm(exact) < 1e-7
        assert stats.substeps >= 1


class TestPmex:
    @pytest.mark.parametrize("p", [1, 2])
    def test_matches_exact_phi(self, p):
        n = 120
        rng = np.random.default_rng(11)
        a = -np.diag(np.linspace(0.5, 30.0, n)) + 0.1 * rng.standard_normal((n, n))
        u = rng.standard_normal((p + 1, n))
        w, stats = pmex([1.0], lambda v: a @ v, u, tol=1e-10, mmin=10, mmax=64)
        exact = _phi_exact(a, 1.0, u.copy())
        err = np.linalg.norm(w[0] - exact) / np.linalg.norm(exact)
        assert err < 1e-8, (err, stats)

    def test_agrees_with_kiops(self):
        # Same cross-check as the reference's test_kiops_pmex_tolerance
        n = 150
        rng = np.random.default_rng(5)
        a = rng.standard_normal((n, n)) / np.sqrt(n) - 2.0 * np.eye(n)
        u = rng.standard_normal((3, n))
        wk, _ = kiops([1.0], lambda v: a @ v, u, tol=1e-10)
        wp, _ = pmex([1.0], lambda v: a @ v, u, tol=1e-10)
        assert np.linalg.norm(wk - wp) / np.linalg.norm(wk) < 1e-8


class TestFgmres:
    def test_matches_scipy_gmres(self):
        a, b = _random_system(n=200, seed=1)
        x, norm_r, norm_b, niter, flag, _ = fgmres(lambda v: a @ v, b, tol=1e-10, restart=30)
        assert flag == 0
        x_ref = np.linalg.solve(a, b)
        assert np.linalg.norm(x - x_ref) / np.linalg.norm(x_ref) < 1e-8

    def test_with_initial_guess_and_hegedus(self):
        a, b = _random_system(n=150, seed=2)
        x_ref = np.linalg.solve(a, b)
        x0 = x_ref + 0.01 * np.random.default_rng(0).standard_normal(150)
        x, norm_r, _, niter, flag, _ = fgmres(lambda v: a @ v, b, x0=x0, tol=1e-10, hegedus=True)
        assert flag == 0
        assert np.linalg.norm(x - x_ref) / np.linalg.norm(x_ref) < 1e-8

    def test_restart_path(self):
        # Force several restarts with a small restart window
        a, b = _random_system(n=120, seed=3)
        x, norm_r, norm_b, niter, flag, res = fgmres(lambda v: a @ v, b, tol=1e-8, restart=8)
        assert flag == 0
        assert niter > 8  # actually restarted
        assert norm_r / norm_b < 1e-8

    def test_preconditioned(self):
        a, b = _random_system(n=160, seed=4)
        m_inv = np.diag(1.0 / np.diag(a))
        x, _, _, niter_pc, flag, _ = fgmres(lambda v: a @ v, b, tol=1e-10, preconditioner=lambda v: m_inv @ v)
        assert flag == 0
        x_ref = np.linalg.solve(a, b)
        assert np.linalg.norm(x - x_ref) / np.linalg.norm(x_ref) < 1e-8

    def test_zero_rhs(self):
        a, _ = _random_system(n=64, seed=5)
        x, norm_r, norm_b, niter, flag, _ = fgmres(lambda v: a @ v, np.zeros(64))
        assert flag == 0 and np.all(x == 0.0)


class TestLowSyncVariants:
    """Every low-sync orthogonalization variant must reproduce the exact
    phi combination (reference's lowsync zoo: cwy/icwy/dcgs2/pmex/kiops_nest)."""

    @pytest.mark.parametrize(
        "name",
        ["pmex_1s", "pmex_ne1s", "cwy_1s", "cwy_ne", "cwy_ne1s",
         "icwy_1s", "icwy_ne", "icwy_ne1s", "icwy_neiop", "dcgs2", "kiops_nest"],
    )
    def test_matches_exact_phi(self, name):
        import wxfactory_tpu.solvers as S

        solver = getattr(S, name)
        n = 120
        rng = np.random.default_rng(11)
        a = -np.diag(np.linspace(0.5, 25.0, n)) + 0.1 * rng.standard_normal((n, n))
        u = rng.standard_normal((3, n))
        w, stats = solver([1.0], lambda v: a @ v, u, tol=1e-10, mmin=10, mmax=64)
        exact = _phi_exact(a, 1.0, u.copy())
        err = np.linalg.norm(w[0] - exact) / np.linalg.norm(exact)
        assert err < 1e-8, (name, err)

    @pytest.mark.parametrize(
        "name,per_iter_budget",
        [("cwy_1s", 1), ("cwy_ne", 1), ("cwy_ne1s", 1),
         ("icwy_1s", 1), ("icwy_ne", 1), ("icwy_ne1s", 1),
         ("icwy_neiop", 1), ("dcgs2", 2), ("kiops_nest", 1)],
    )
    def test_reduction_budget(self, name, per_iter_budget):
        """The whole point of the family on a mesh: global reductions per
        Krylov iteration (the engine counts every allreduce-equivalent
        site, solvers/lowsync.py NUM_REDUCTIONS). The 1-sync/norm-estimate
        variants must stay at ONE fused reduction per iteration (plus
        bounded per-substep overheads: restart beta, lagged final
        normalization, estimate fallbacks); dcgs2 here uses an exact norm
        (2/iter)."""
        import wxfactory_tpu.solvers.lowsync as L
        import wxfactory_tpu.solvers as S

        solver = getattr(S, name)
        n = 120
        rng = np.random.default_rng(11)
        a = -np.diag(np.linspace(0.5, 25.0, n)) + 0.1 * rng.standard_normal((n, n))
        u = rng.standard_normal((3, n))
        before = L.NUM_REDUCTIONS
        w, stats = solver([1.0], lambda v: a @ v, u, tol=1e-10, mmin=10, mmax=64)
        used = L.NUM_REDUCTIONS - before
        # per-substep overhead: restart beta (non-lagged) or final
        # normalization (lagged) + rare exact-norm fallbacks.
        overhead = 2 * stats.num_expm + 2
        assert stats.krylov_steps > 0
        assert used <= per_iter_budget * stats.krylov_steps + overhead, (
            name, used, stats.krylov_steps, stats.num_expm)

    def test_lagged_variants_are_distinct(self):
        """The *_1s (lagged-normalization) variants must
        have a genuinely different synchronization structure, not alias
        *_ne. With a single Arnoldi sweep the lagged scheme normalizes with
        TRUE norms (exact arithmetic path) while ne uses the Pythagorean
        estimate — on an ill-conditioned system the H matrices and
        reduction counts differ."""
        import wxfactory_tpu.solvers.lowsync as L

        n = 90
        rng = np.random.default_rng(4)
        a = -np.diag(np.linspace(0.5, 40.0, n)) + 0.05 * rng.standard_normal((n, n))
        u = rng.standard_normal((2, n))

        counts = {}
        for mode in ("ne", "1s", "ne1s"):
            before = L.NUM_REDUCTIONS
            w, stats = L.lowsync_phi([1.0], lambda v: a @ v, u, scheme="icwy",
                                     mode=mode, tol=1e-10, mmin=10, mmax=64)
            counts[mode] = (L.NUM_REDUCTIONS - before, stats.krylov_steps)
            exact = _phi_exact(a, 1.0, u.copy())
            assert np.linalg.norm(w[0] - exact) / np.linalg.norm(exact) < 1e-8, mode
        # Lagged schemes pay one extra reduction per substep (final-vector
        # normalization) but none at restart; ne pays restart beta. All
        # stay ~1/iteration; the *code paths* differ — spot-check by
        # construction: the lagged runs did NOT count a restart-beta
        # reduction before the first iteration.
        assert counts["1s"][1] > 0 and counts["ne1s"][1] > 0


class TestKiopsJit:
    """The device-resident KIOPS (ONE XLA program, solvers/kiops_jit.py)
    must reproduce the host orchestration exactly: same controller
    decisions (identical stats) and results to roundoff."""

    @pytest.mark.parametrize("p", [0, 1, 3])
    def test_matches_host_kiops_and_exact_phi(self, p):
        import jax
        import jax.numpy as jnp

        from wxfactory_tpu.solvers import kiops_jit

        n = 120
        rng = np.random.default_rng(7)
        a = -np.diag(np.linspace(0.5, 30.0, n)) + 0.1 * rng.standard_normal((n, n))
        u = rng.standard_normal((p + 1, n))
        w_host, st_host = kiops([1.0], lambda v: a @ v, u.copy(), tol=1e-10, mmin=10, mmax=64)

        aj = jnp.asarray(a)
        fn = jax.jit(lambda uu: kiops_jit(lambda v: aj @ v, uu, tol=1e-10, mmin=10, mmax=64))
        w_jit, st_jit = fn(jnp.asarray(u))
        w_jit = np.asarray(w_jit)

        scale = np.abs(w_host[0]).max()
        assert np.abs(w_jit - w_host[0]).max() / scale < 1e-12
        # Identical trajectory through the adaptivity controller.
        assert int(st_jit.krylov_steps) == st_host.krylov_steps
        assert int(st_jit.substeps) == st_host.substeps
        assert int(st_jit.rejected) == st_host.rejected
        assert int(st_jit.last_krylov_size) == st_host.last_krylov_size

        exact = _phi_exact(a, 1.0, u.copy())
        assert np.linalg.norm(w_jit - exact) / np.linalg.norm(exact) < 1e-8

    @pytest.mark.parametrize("full_ortho", [False, True])
    def test_one_sync_matches_exact_phi(self, full_ortho):
        """one_sync=True fuses the new-vector norm into the batched Gram
        product (Pythagorean estimate — the reference kiops_nest/icwy_neiop
        structure on device): ONE collective per IOP iteration, and must
        still reproduce the exact phi combination."""
        import jax
        import jax.numpy as jnp

        from wxfactory_tpu.solvers import kiops_jit

        n = 120
        rng = np.random.default_rng(7)
        a = -np.diag(np.linspace(0.5, 30.0, n)) + 0.1 * rng.standard_normal((n, n))
        u = rng.standard_normal((3, n))
        aj = jnp.asarray(a)
        fn = jax.jit(lambda uu: kiops_jit(lambda v: aj @ v, uu, tol=1e-10, mmin=10,
                                          mmax=64, one_sync=True, full_ortho=full_ortho))
        w, st = fn(jnp.asarray(u))
        exact = _phi_exact(a, 1.0, u.copy())
        assert np.linalg.norm(np.asarray(w) - exact) / np.linalg.norm(exact) < 1e-8

    def test_stiff_substepping_matches_host(self):
        import jax
        import jax.numpy as jnp

        from wxfactory_tpu.solvers import kiops_jit

        # Large tau_end forces tau-substepping + rejections on the device.
        n = 100
        rng = np.random.default_rng(11)
        a = -np.diag(np.linspace(1.0, 400.0, n)) + 0.5 * rng.standard_normal((n, n))
        u = rng.standard_normal((2, n))
        w_host, st_host = kiops([1.0], lambda v: a @ v, u.copy(), tol=1e-9, mmin=10, mmax=32)
        aj = jnp.asarray(a)
        fn = jax.jit(lambda uu: kiops_jit(lambda v: aj @ v, uu, tol=1e-9, mmin=10, mmax=32))
        w_jit, st_jit = fn(jnp.asarray(u))
        assert st_host.substeps > 1  # the adaptive path is actually exercised
        assert int(st_jit.substeps) == st_host.substeps
        assert int(st_jit.krylov_steps) == st_host.krylov_steps
        scale = np.abs(w_host[0]).max()
        assert np.abs(np.asarray(w_jit) - w_host[0]).max() / scale < 1e-12


class TestFgmresJit:
    def test_matches_host_and_exact(self):
        import jax
        import jax.numpy as jnp

        from wxfactory_tpu.solvers import fgmres, fgmres_jit

        n = 120
        rng = np.random.default_rng(7)
        a = np.eye(n) + 0.5 / np.sqrt(n) * rng.standard_normal((n, n))
        b = rng.standard_normal(n)
        aj = jnp.asarray(a)
        x, info = jax.jit(lambda bb: fgmres_jit(lambda v: aj @ v, bb, tol=1e-10, restart=30))(
            jnp.asarray(b)
        )
        x = np.asarray(x)
        assert bool(info.converged)
        assert np.linalg.norm(b - a @ x) / np.linalg.norm(b) < 1e-10

        x_host, _, _, it_host, flag, _ = fgmres(lambda v: a @ v, b, tol=1e-10, restart=30)
        assert flag == 0
        assert int(info.num_iter) == it_host
        assert np.abs(x - x_host).max() / np.abs(x_host).max() < 1e-10

    def test_one_sync_matches_two_sync(self):
        """one_sync=True (batched [V; w] @ w Gram product + Pythagorean
        orthogonalized-norm estimate — ONE collective per iteration under
        GSPMD, the device-resident twin of the reference's norm-estimate
        low-sync family, solvers/icwy_ne.py / dcgs2.py there) must converge
        to the same solution in the same iterations (+-1: the estimated
        norm differs from the exact one in the last bits, which can move
        the convergence check by one iteration) as the 2-sync CGS on a
        well-conditioned system, and still converge through restarts."""
        import jax
        import jax.numpy as jnp

        from wxfactory_tpu.solvers import fgmres_jit

        n = 120
        rng = np.random.default_rng(11)
        a = np.eye(n) + 0.5 / np.sqrt(n) * rng.standard_normal((n, n))
        b = rng.standard_normal(n)
        aj, bj = jnp.asarray(a), jnp.asarray(b)
        x2, info2 = jax.jit(lambda bb: fgmres_jit(lambda v: aj @ v, bb, tol=1e-10, restart=30))(bj)
        x1, info1 = jax.jit(
            lambda bb: fgmres_jit(lambda v: aj @ v, bb, tol=1e-10, restart=30, one_sync=True)
        )(bj)
        assert bool(info1.converged)
        assert abs(int(info1.num_iter) - int(info2.num_iter)) <= 1
        assert np.linalg.norm(b - a @ np.asarray(x1)) / np.linalg.norm(b) < 1e-10
        assert np.abs(np.asarray(x1) - np.asarray(x2)).max() / np.abs(np.asarray(x2)).max() < 1e-9

        # Restarted + poorly scaled: the norm estimate must survive the
        # rescaling cancellation and still reach the tolerance.
        d = np.linspace(1.0, 50.0, n)
        a2 = np.diag(d) + 0.5 * rng.standard_normal((n, n)) / np.sqrt(n)
        a2j = jnp.asarray(a2)
        x, info = jax.jit(
            lambda bb: fgmres_jit(lambda v: a2j @ v, bb, tol=1e-9, restart=10,
                                  max_outer=50, one_sync=True)
        )(bj)
        assert bool(info.converged)
        assert np.linalg.norm(b - a2 @ np.asarray(x)) / np.linalg.norm(b) < 1e-9

    def test_mixed_precision_inner_reaches_f64_tolerance(self):
        """A32 + basis_dtype=float32 (restarted iterative refinement: f32
        inner Arnoldi, f64 outer residuals with the exact operator — see
        fgmres_jit docstring) must reach an f64 relative residual of 1e-9,
        far below single-precision resolution of a single cycle, because
        each restart contracts the TRUE residual."""
        import jax
        import jax.numpy as jnp

        from wxfactory_tpu.solvers import fgmres_jit

        n = 120
        rng = np.random.default_rng(5)
        a = np.eye(n) + 0.5 / np.sqrt(n) * rng.standard_normal((n, n))
        b = rng.standard_normal(n)
        aj = jnp.asarray(a)
        a32 = jnp.asarray(a, jnp.float32)
        x, info = jax.jit(
            lambda bb: fgmres_jit(lambda v: aj @ v, bb, tol=1e-9, restart=20,
                                  max_outer=50, A32=lambda v: a32 @ v,
                                  basis_dtype=jnp.float32)
        )(jnp.asarray(b))
        assert bool(info.converged)
        assert np.linalg.norm(b - a @ np.asarray(x)) / np.linalg.norm(b) < 1e-9

    def test_restart_and_preconditioner(self):
        import jax
        import jax.numpy as jnp

        from wxfactory_tpu.solvers import fgmres_jit

        n = 90
        rng = np.random.default_rng(3)
        d = np.linspace(1.0, 50.0, n)
        a = np.diag(d) + 0.5 * rng.standard_normal((n, n)) / np.sqrt(n)
        b = rng.standard_normal(n)
        aj, dj = jnp.asarray(a), jnp.asarray(d)
        x, info = jax.jit(
            lambda bb: fgmres_jit(
                lambda v: aj @ v, bb, x0=jnp.ones(n), tol=1e-9, restart=10,
                max_outer=50, preconditioner=lambda v: v / dj,
            )
        )(jnp.asarray(b))
        assert bool(info.converged)
        assert np.linalg.norm(b - a @ np.asarray(x)) / np.linalg.norm(b) < 1e-9


class TestExode:
    @pytest.mark.parametrize("method", ["BS3(2)", "DP5(4)", "DP8(7)"])
    def test_matches_exact_phi(self, method):
        from wxfactory_tpu.solvers import exode

        n = 80
        rng = np.random.default_rng(5)
        a = -np.diag(np.linspace(0.2, 5.0, n))
        u = rng.standard_normal((3, n))
        w, stats = exode(1.0, lambda v: a @ v, u, method=method, rtol=1e-10, atol=1e-12)
        exact = _phi_exact(a, 1.0, u.copy())
        err = np.linalg.norm(w[0] - exact) / np.linalg.norm(exact)
        assert err < 1e-7, (method, err)


class TestErkEngine:
    """The embedded-RK engine behind EXODE (solvers/erk.py): real tableaus
    + the reference's controller family (explicit_runge_kutta.py:246-434)."""

    ALL_METHODS = [
        "BS3(2)", "DP5(4)", "M4(3)", "KC3(2)",
        "EXLRK3(2)", "EXLRK4(3)", "DP8(7)", "F10(8)", "F14(12)",
    ]

    @pytest.mark.parametrize("method", ALL_METHODS)
    def test_tableau_order_conditions(self, method):
        from wxfactory_tpu.solvers.erk import get_tableau

        tab = get_tableau(method)
        # Quadrature order conditions B @ C^(k-1) = 1/k (necessary for
        # order k) up to the full advertised order — catches any wrong
        # coefficient payload, incl. the 17/35-stage Feagin tables.
        for k in range(1, tab.order + 1):
            assert abs(tab.B @ tab.C ** (k - 1) - 1.0 / k) < 1e-12, (method, k)
        if method in ("F10(8)", "F14(12)"):
            # E = b_hat - B for the Feagin pairs: the embedded method's own
            # quadrature conditions must hold to its order too.
            bh = tab.E[: len(tab.B)] + tab.B
            for k in range(1, tab.error_estimator_order + 1):
                assert abs(bh @ tab.C ** (k - 1) - 1.0 / k) < 1e-12, (method, k)
            assert tab.n_stages == {10: 17, 14: 35}[tab.order]

    @pytest.mark.parametrize("method", ALL_METHODS)
    def test_nonlinear_ode_accuracy(self, method):
        # Scalar logistic ODE y' = y(1-y), exact y(t) = 1/(1+(1/y0-1)e^-t).
        from wxfactory_tpu.solvers.erk import erk_integrate

        y0 = np.array([0.1])
        res = erk_integrate(
            lambda t, y: y * (1 - y), 0.0, y0, 4.0,
            method=method, rtol=1e-9, atol=1e-11, first_step=0.1,
        )
        assert res.status == "finished"
        exact = 1.0 / (1.0 + (1 / 0.1 - 1) * np.exp(-4.0))
        assert abs(res.y[0] - exact) < 1e-7, (method, res.y[0], exact)
        assert res.nfev > res.num_steps  # >1 eval per attempted step
        assert res.failed_steps < res.num_steps

    @pytest.mark.parametrize("controller", ["deadbeat", "PI3040", "PI4020", "H211PI", "H110", "H211D", "H211B"])
    def test_controllers(self, controller):
        from wxfactory_tpu.solvers.erk import erk_integrate

        # Mildly stiff linear system; every controller must converge.
        a = -np.diag(np.linspace(0.5, 30.0, 40))
        y0 = np.ones(40)
        res = erk_integrate(
            lambda t, y: a @ y, 0.0, y0, 1.0,
            method="DP5(4)", controller=controller, rtol=1e-8, atol=1e-10, first_step=0.05,
        )
        assert res.status == "finished"
        exact = np.exp(np.diag(a))
        assert np.abs(res.y - exact).max() < 1e-6, controller

    def test_step_rejection_path(self):
        from wxfactory_tpu.solvers.erk import erk_integrate

        # A deliberately huge first step must be rejected and recovered from.
        res = erk_integrate(
            lambda t, y: -50.0 * y, 0.0, np.ones(4), 1.0,
            method="BS3(2)", rtol=1e-8, atol=1e-10, first_step=1.0,
        )
        assert res.status == "finished"
        assert res.failed_steps > 0
        assert np.abs(res.y - np.exp(-50.0)).max() < 1e-6

    def test_unknown_method_raises(self):
        from wxfactory_tpu.solvers.erk import erk_integrate

        with pytest.raises(ValueError):
            erk_integrate(lambda t, y: -y, 0.0, np.ones(2), 1.0, method="RK99")


class TestGcrot:
    """Native GCROT(m,k) (solvers/gcrot.py — no scipy delegate): recycled
    subspace + flexible right preconditioning, reference solvers/gcrot.py:129."""

    def test_matches_direct_solve(self):
        from wxfactory_tpu.solvers import gcrot

        a, b = _random_system(n=150, seed=3)
        x, norm_r, norm_b, niter, flag, hist = gcrot(lambda v: a @ v, b, tol=1e-10)
        assert flag == 0
        assert norm_r <= 1e-10 * norm_b
        np.testing.assert_allclose(x, np.linalg.solve(a, b), rtol=1e-7, atol=1e-8)
        assert niter > 0 and len(hist) >= 1
        # History entries are (relative residual, seconds, work), decreasing.
        rels = [h[0] for h in hist]
        assert rels[-1] <= rels[0]

    def test_recycling_beats_cold_restart(self):
        """With a small restart m, the recycle space must reduce the matvec
        count vs m-restarted GMRES on the same system (the point of GCROT —
        a strict acceleration assertion, not <=)."""
        from wxfactory_tpu.solvers import gcrot

        a, b = _random_system(n=300, seed=5, diag_shift=1.2)
        count = [0]

        def mv(v):
            count[0] += 1
            return a @ v

        x, norm_r, norm_b, niter, flag, _ = gcrot(mv, b, tol=1e-8, restart=10)
        assert flag == 0
        gcrot_mv = count[0]

        # m-restarted GMRES with the same inner size, no recycling.
        count[0] = 0
        op = scipy.sparse.linalg.LinearOperator((b.size, b.size), matvec=mv)
        _x, info = scipy.sparse.linalg.gmres(op, b, rtol=1e-8, atol=0.0,
                                             restart=10, maxiter=2000)
        assert info == 0
        assert gcrot_mv < count[0], (gcrot_mv, count[0])

    def test_preconditioned(self):
        from wxfactory_tpu.solvers import gcrot

        a, b = _random_system(n=120, seed=7)
        dinv = 1.0 / np.diag(a)
        x, norm_r, norm_b, niter_pc, flag, _ = gcrot(
            lambda v: a @ v, b, tol=1e-9, preconditioner=lambda v: dinv * v
        )
        assert flag == 0
        np.testing.assert_allclose(a @ x, b, rtol=0, atol=1e-8 * norm_b)

    def test_zero_rhs(self):
        from wxfactory_tpu.solvers import gcrot

        a, _ = _random_system(n=30, seed=1)
        x, norm_r, norm_b, niter, flag, hist = gcrot(lambda v: a @ v, np.zeros(30))
        assert flag == 0 and norm_b == 0.0 and np.all(x == 0.0)

    def test_initial_guess(self):
        from wxfactory_tpu.solvers import gcrot

        a, b = _random_system(n=80, seed=11)
        xtrue = np.linalg.solve(a, b)
        x, norm_r, _, niter, flag, _ = gcrot(
            lambda v: a @ v, b, x0=xtrue + 1e-8, tol=1e-6
        )
        assert flag == 0 and niter <= 10
        np.testing.assert_allclose(x, xtrue, rtol=1e-5, atol=1e-6)
