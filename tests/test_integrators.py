"""Integrator tests on the rising-bubble problem: exponential (EPI/KIOPS,
PMEX), Rosenbrock, and fully implicit schemes all reproduce a fine explicit
reference solution at large time steps — the reference framework's
headline capability (config/gaussian_bubble.ini runs epi2 at dt=5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from wxfactory_tpu.geometry.cartesian import make_cartesian_2d
from wxfactory_tpu.integrators import (
    Bdf2,
    BackwardEuler,
    CrankNicolson,
    Epi,
    EpiStiff,
    Ros2,
    Tvdrk3,
    alpha_coeff,
)
from wxfactory_tpu.models import make_rhs_euler_cartesian
from wxfactory_tpu.ops import make_dfr_operators
from wxfactory_tpu.testcases import initialize_cartesian2d


@pytest.fixture(scope="module")
def bubble():
    ops = make_dfr_operators(3)
    geom = make_cartesian_2d((0, 1000), (0, 1500), 4, 6, 3)
    q0 = jnp.asarray(initialize_cartesian2d(geom, 2))
    rhs = make_rhs_euler_cartesian(geom, ops)
    # Fine explicit reference to t = 2.0
    st = Tvdrk3(rhs)
    qr = q0
    for _ in range(400):
        qr = st.step(qr, 0.005)
    return q0, rhs, qr


def _rel_err(a, b):
    return float(jnp.abs(a - b).max() / jnp.abs(b).max())


def test_epi2_kiops_large_step(bubble):
    q0, rhs, qr = bubble
    epi = Epi(rhs, order=2, tolerance=1e-12, exponential_solver="kiops")
    q = epi.step(q0, 2.0)
    assert _rel_err(q, qr) < 1e-7


def test_epi2_pmex_large_step(bubble):
    q0, rhs, qr = bubble
    epi = Epi(rhs, order=2, tolerance=1e-12, exponential_solver="pmex")
    q = epi.step(q0, 2.0)
    assert _rel_err(q, qr) < 1e-7


def test_epi3_multistep(bubble):
    q0, rhs, qr = bubble
    epi = Epi(rhs, order=3, tolerance=1e-12, exponential_solver="kiops")
    q = q0
    for _ in range(4):
        q = epi.step(q, 0.5)
    assert _rel_err(q, qr) < 1e-7


def test_epi2_device_resident_matches_host(bubble):
    # exponential_solver="kiops_jit": the WHOLE EPI step (RHS, vec assembly,
    # adaptive KIOPS, update) is one XLA program; must agree with the
    # host-orchestrated path to roundoff, stats included.
    q0, rhs, qr = bubble
    dev = Epi(rhs, order=2, tolerance=1e-12, exponential_solver="kiops_jit")
    host = Epi(rhs, order=2, tolerance=1e-12, exponential_solver="kiops")
    qd = dev.step(q0, 2.0)
    qh = host.step(q0, 2.0)
    assert _rel_err(qd, qh) < 1e-12
    assert dev.solver_info.total_num_it == host.solver_info.total_num_it
    assert _rel_err(qd, qr) < 1e-7


def test_epi3_device_resident_multistep(bubble):
    q0, rhs, qr = bubble
    dev = Epi(rhs, order=3, tolerance=1e-12, exponential_solver="kiops_jit")
    host = Epi(rhs, order=3, tolerance=1e-12, exponential_solver="kiops")
    qd, qh = q0, q0
    for _ in range(4):
        qd = dev.step(qd, 0.5)
        qh = host.step(qh, 0.5)
    assert _rel_err(qd, qh) < 1e-12
    assert _rel_err(qd, qr) < 1e-7


def test_epi_steps_device_scan_matches_single_steps(bubble):
    """steps_device (N device-resident EPI steps as ONE lax.scan program,
    device-side Krylov warm start) must reproduce the repeated-single-step
    trajectory exactly, for the memoryless order (2) AND a multistep order
    (3, history riding the scan carry)."""
    q0, rhs, qr = bubble
    for order in (2, 3):
        single = Epi(rhs, order=order, tolerance=1e-12, exponential_solver="kiops_jit")
        chunked = Epi(rhs, order=order, tolerance=1e-12, exponential_solver="kiops_jit")
        qs = q0
        for _ in range(4):
            qs = single.step(qs, 0.5)
        qc = chunked.steps_device(q0, 0.5, 4)
        assert _rel_err(qc, qs) < 1e-12, order
        assert chunked.krylov_size == single.krylov_size, order
        # Continuation after the chunk also agrees (history carried out).
        assert _rel_err(chunked.steps_device(qc, 0.5, 1), single.step(qs, 0.5)) < 1e-12

    # EpiStiff shares the device-scan machinery (phi_3-offset residuals).
    single = EpiStiff(rhs, order=4, tolerance=1e-12, exponential_solver="kiops_jit")
    chunked = EpiStiff(rhs, order=4, tolerance=1e-12, exponential_solver="kiops_jit")
    qs = q0
    for _ in range(5):
        qs = single.step(qs, 0.5)
    qc = chunked.steps_device(q0, 0.5, 5)
    assert _rel_err(qc, qs) < 1e-12


def test_ros2_steps_device_scan_matches_single_steps(bubble):
    """Ros2 steps_device (N whole-step FGMRES solves as ONE lax.scan
    program) must reproduce the repeated-single-step
    trajectory exactly; FGMRES carries no cross-step state so the match is
    bit-for-bit, with the same aggregate iteration count."""
    from wxfactory_tpu.integrators import Ros2

    q0, rhs, qr = bubble
    single = Ros2(rhs, tolerance=1e-10, gmres_restart=30, linear_solver="fgmres_jit")
    chunked = Ros2(rhs, tolerance=1e-10, gmres_restart=30, linear_solver="fgmres_jit")
    qs, total_it = q0, 0
    for _ in range(4):
        qs = single.step(qs, 0.5)
        total_it += single.solver_info.total_num_it
    qc = chunked.steps_device(q0, 0.5, 4)
    assert _rel_err(qc, qs) == 0.0
    assert chunked.solver_info.total_num_it == total_it
    assert chunked.solver_info.converged
    assert chunked.num_completed_steps == 4


def test_epistiff_device_resident(bubble):
    q0, rhs, qr = bubble
    dev = EpiStiff(rhs, order=4, tolerance=1e-12, exponential_solver="kiops_jit")
    qd = q0
    for _ in range(8):
        qd = dev.step(qd, 0.25)
    assert _rel_err(qd, qr) < 1e-6


def test_ros2_device_resident_matches_host(bubble):
    q0, rhs, qr = bubble
    dev = Ros2(rhs, tolerance=1e-10, linear_solver="fgmres_jit")
    host = Ros2(rhs, tolerance=1e-10, linear_solver="fgmres")
    qd, qh = q0, q0
    for _ in range(4):
        qd = dev.step(qd, 0.5)
        qh = host.step(qh, 0.5)
    assert dev.solver_info.converged and dev.failure_flag == 0
    assert dev.solver_info.total_num_it == host.solver_info.total_num_it
    assert _rel_err(qd, qh) < 1e-11


def test_srerk3_kiops_large_step(bubble):
    from wxfactory_tpu.integrators import Srerk

    q0, rhs, qr = bubble
    srerk = Srerk(rhs, order=3, tolerance=1e-12, exponential_solver="kiops")
    q = srerk.step(q0, 2.0)
    assert _rel_err(q, qr) < 1e-7
    assert srerk.solver_info is not None and srerk.solver_info.total_num_it > 0


def test_srerk6_multistep(bubble):
    from wxfactory_tpu.integrators import Srerk

    q0, rhs, qr = bubble
    srerk = Srerk(rhs, order=6, tolerance=1e-12, exponential_solver="pmex")
    q = q0
    for _ in range(2):
        q = srerk.step(q, 1.0)
    assert _rel_err(q, qr) < 1e-7


def test_srerk_custom_jtv_matches_default(bubble):
    # The Srerk_others capability: a user-supplied Jacobian action must give
    # the same step as the built-in jvp when it IS the jvp.
    import jax

    from wxfactory_tpu.integrators import Srerk

    q0, rhs, qr = bubble

    @jax.jit
    def jvp(v, dt, q, rhs_q):
        return dt * jax.jvp(rhs, (q,), (v.reshape(q.shape),))[1].ravel()

    a = Srerk(rhs, order=3, tolerance=1e-12).step(q0, 1.0)
    b = Srerk(rhs, order=3, tolerance=1e-12, jtv=jvp).step(q0, 1.0)
    assert _rel_err(a, b) < 1e-10


def test_epi_stiff_4(bubble):
    q0, rhs, qr = bubble
    epi = EpiStiff(rhs, order=4, tolerance=1e-12, exponential_solver="kiops")
    q = q0
    for _ in range(8):
        q = epi.step(q, 0.25)
    assert _rel_err(q, qr) < 1e-6


def test_ros2(bubble):
    q0, rhs, qr = bubble
    ros = Ros2(rhs, tolerance=1e-10)
    q = q0
    for _ in range(8):
        q = ros.step(q, 0.25)
    assert _rel_err(q, qr) < 1e-4


def test_crank_nicolson(bubble):
    q0, rhs, qr = bubble
    cn = CrankNicolson(rhs, tolerance=1e-10)
    q = q0
    for _ in range(4):
        q = cn.step(q, 0.5)
    assert _rel_err(q, qr) < 1e-4


def test_bdf2(bubble):
    q0, rhs, qr = bubble
    bdf = Bdf2(rhs, tolerance=1e-10)
    q = q0
    for _ in range(8):
        q = bdf.step(q, 0.25)
    assert _rel_err(q, qr) < 1e-4


def test_backward_euler(bubble):
    q0, rhs, qr = bubble
    be = BackwardEuler(rhs, tolerance=1e-10)
    q = q0
    for _ in range(8):
        q = be.step(q, 0.25)
    # first order: loose tolerance
    assert _rel_err(q, qr) < 5e-3


def test_alpha_coeff_epi3_matches_table():
    # EpiStiff order-3 alpha coefficients from node -1: known closed form
    a = alpha_coeff([-1.0])
    assert a.shape == (1, 1)
    # For c = [-1]: denom = 1, alpha[0,0] = factorial(2) * 1 = 2 (up to sign)
    assert np.isclose(abs(a[0, 0]), 2.0)


class TestHybridAndSplitting:
    """Imex2 / RosExp2 / PartRosExp2 / SDIRK / splittings reproduce the fine
    explicit reference on the bubble problem (reference integrators/
    imex2.py, rosexp2.py, partrosexp2.py, sdirk.py, splitting.py)."""

    def _err(self, q, qr):
        return float(jnp.max(jnp.abs(q[3] - qr[3])) / jnp.max(jnp.abs(qr[3])))

    def test_imex2(self, bubble):
        from wxfactory_tpu.integrators import Imex2

        q0, rhs, qr = bubble
        # Use the full RHS as the implicit part and zero as explicit: IMEX
        # midpoint then reduces to the implicit midpoint rule.
        integ = Imex2(lambda q: jnp.zeros_like(q), rhs, tolerance=1e-10)
        q = q0
        for _ in range(4):
            q = integ.step(q, 0.5)
        assert self._err(q, qr) < 2e-2

    @pytest.mark.parametrize("cls_name", ["RosExp2", "PartRosExp2"])
    def test_rosexp_variants(self, bubble, cls_name):
        import wxfactory_tpu.integrators as I

        q0, rhs, qr = bubble
        # implicit part = full RHS (exponential part then handles the rest)
        integ = getattr(I, cls_name)(rhs, rhs, tolerance=1e-8)
        q = q0
        for _ in range(4):
            q = integ.step(q, 0.5)
        assert self._err(q, qr) < 2e-2

    def test_sdirk(self, bubble):
        from wxfactory_tpu.integrators import SdirkLstable

        q0, rhs, qr = bubble
        integ = SdirkLstable(rhs, tolerance=1e-10)
        q = q0
        for _ in range(4):
            q = integ.step(q, 0.5)
        assert self._err(q, qr) < 2e-2

    def test_strang_splitting(self, bubble):
        from wxfactory_tpu.integrators import Epi, StrangSplitting, Tvdrk3

        q0, rhs, qr = bubble
        # Split the full RHS in half between two schemes.
        half = lambda q: 0.5 * rhs(q)
        integ = StrangSplitting(Epi(half, 2, tolerance=1e-10), Epi(half, 2, tolerance=1e-10))
        q = q0
        for _ in range(4):
            q = integ.step(q, 0.5)
        assert self._err(q, qr) < 2e-2

    def test_lie_and_os22(self, bubble):
        from wxfactory_tpu.integrators import Epi, LieSplitting, OS22Splitting

        q0, rhs, qr = bubble
        half = lambda q: 0.5 * rhs(q)
        for maker in (
            lambda: LieSplitting(Epi(half, 2, tolerance=1e-10), Epi(half, 2, tolerance=1e-10)),
            lambda: OS22Splitting(Epi(half, 2, tolerance=1e-10), Epi(half, 2, tolerance=1e-10), 0.8),
        ):
            integ = maker()
            q = q0
            for _ in range(4):
                q = integ.step(q, 0.5)
            assert self._err(q, qr) < 5e-2
