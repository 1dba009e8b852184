"""3D Euler on the cubed sphere: metric + RHS golden parity and dynamics."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

from ref_harness import reference_euler3d_case  # noqa: E402

from wxfactory_tpu.geometry.cubed_sphere_3d import make_cubed_sphere_3d  # noqa: E402
from wxfactory_tpu.geometry.metric3d import make_metric_3d  # noqa: E402
from wxfactory_tpu.models.euler_cubesphere import make_rhs_euler_cubesphere  # noqa: E402
from wxfactory_tpu.ops.dfr import make_dfr_operators  # noqa: E402
from wxfactory_tpu.testcases.dcmip import acoustic_wave, dcmip_gravity_wave  # noqa: E402

NEL_H, NEL_V, S, ZTOP = 3, 2, 2, 10000.0


@pytest.fixture(scope="module")
def ref31():
    return reference_euler3d_case(31, NEL_H, NEL_V, S, ZTOP)


@pytest.fixture(scope="module")
def mine31():
    from conftest import cs3d_setup
    geom, ops, _topo, metric = cs3d_setup(NEL_H, NEL_V, S, 10000.0)
    return geom, ops, metric


def test_metric_matches_reference(ref31, mine31):
    _, _, m = mine31
    ss = S * S
    checks = [
        (m.sqrtG, ref31["sqrtG"]),
        (m.inv_dzdeta, ref31["inv_dzdeta"]),
        (m.h_contra, ref31["h_contra"]),
        (m.christoffel, ref31["christoffel"]),
        (m.sqrtG_itf_i, ref31["sqrtG_itf_i"][..., 1:, :ss]),
        (m.sqrtG_itf_j, ref31["sqrtG_itf_j"][..., 1:, :, :ss]),
        (m.sqrtG_itf_k, ref31["sqrtG_itf_k"][..., 1:, :, :, :ss]),
        (m.h_contra_itf_i, ref31["h_contra_itf_i"][..., 1:, :ss]),
        (m.h_contra_itf_j, ref31["h_contra_itf_j"][..., 1:, :, :ss]),
        (m.h_contra_itf_k, ref31["h_contra_itf_k"][..., 1:, :, :, :ss]),
    ]
    for mine, theirs in checks:
        scale = np.abs(theirs).max() or 1.0
        assert np.abs(mine - theirs).max() / scale < 1e-12


def test_dcmip31_initial_condition_matches(ref31, mine31):
    geom, _, _ = mine31
    q = dcmip_gravity_wave(geom)
    scale = np.abs(ref31["Q"]).max()
    assert np.abs(q - ref31["Q"]).max() / scale < 1e-12


def test_dcmip31_rhs_matches_reference(ref31, mine31):
    geom, ops, metric = mine31
    rhs = make_rhs_euler_cubesphere(geom, ops, metric)
    dq = np.asarray(rhs(jnp.asarray(ref31["Q"])))
    scale = np.abs(ref31["dQ"]).max()
    assert np.abs(dq - ref31["dQ"]).max() / scale < 1e-10


def test_dcmip31_rhs_jit_and_steps(mine31):
    """Time-step the gravity wave explicitly; fields stay finite and mass is
    conserved (the DFR scheme is locally conservative)."""
    geom, ops, metric = mine31
    rhs = jax.jit(make_rhs_euler_cubesphere(geom, ops, metric))
    q = jnp.asarray(dcmip_gravity_wave(geom))

    w = jnp.asarray(np.tile(np.asarray(ops.weights), S * S).reshape(S, S, S).transpose(2, 1, 0))
    # quadrature weight per s^3 point: w_kz * w_ky * w_kx
    wq = jnp.asarray(
        np.einsum("i,j,k->ijk", ops.weights, ops.weights, ops.weights).reshape(-1)
    )
    sg = jnp.asarray(metric.sqrtG)
    mass = lambda q: float(jnp.sum(sg * wq * q[0]))

    m0 = mass(q)
    dt = 2.0  # reduced planet: dcmip31 reference dt=30 at nel 12x3; coarse grid here
    for _ in range(10):
        q1 = q + dt * rhs(q)
        q2 = 0.75 * q + 0.25 * (q1 + dt * rhs(q1))
        q = q / 3.0 + 2.0 / 3.0 * (q2 + dt * rhs(q2))
    assert np.all(np.isfinite(np.asarray(q)))
    assert abs(mass(q) - m0) / abs(m0) < 1e-12


def test_acoustic_wave_builds():
    geom = make_cubed_sphere_3d(NEL_H, NEL_V, S, ZTOP)
    q = acoustic_wave(geom)
    assert np.all(np.isfinite(q))
    assert q[0].min() > 0


def test_sharded_3d_rhs_matches(mine31):
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    if len(jax.devices()) < 6:
        pytest.skip("needs >= 6 virtual devices")

    geom, ops, metric = mine31
    rhs = make_rhs_euler_cubesphere(geom, ops, metric)
    q = jnp.asarray(dcmip_gravity_wave(geom))
    expected = np.asarray(jax.jit(rhs)(q))

    mesh = Mesh(np.array(jax.devices()[:6]).reshape(6, 1), axis_names=("panel", "y"))
    sharding = NamedSharding(mesh, P(None, "panel", None, "y", None, None))
    q_sharded = jax.device_put(q, sharding)
    got = np.asarray(jax.jit(rhs, in_shardings=(sharding,), out_shardings=sharding)(q_sharded))
    np.testing.assert_allclose(got, expected, rtol=1e-11, atol=1e-14)


def test_epi2_kiops_steps_match_reference(mine31):
    """End-to-end time integration parity: 2 EPI2+KIOPS steps vs the
    reference integrator (adaptive Krylov paths diverge slowly from
    subgradient differences at kinks; tolerance reflects that)."""
    from ref_harness import reference_euler3d_epi_steps

    from wxfactory_tpu.integrators import Epi

    # nel_h=4 is the smallest grid where the trajectory is not dominated by
    # amplification of solver-tolerance noise within two steps.
    nel_h = 4
    ref_states = reference_euler3d_epi_steps(31, nel_h, NEL_V, S, ZTOP, 30.0, 2)

    from conftest import cs3d_setup
    geom, ops, _topo, metric = cs3d_setup(nel_h, NEL_V, S, 10000.0)
    rhs = make_rhs_euler_cubesphere(geom, ops, metric)
    q = jnp.asarray(dcmip_gravity_wave(geom))
    integ = Epi(rhs, order=2, exponential_solver="kiops", tolerance=1e-7)
    tols = (1e-4, 5e-3)
    for i in range(2):
        q = integ.step(q, 30.0)
        scale = np.abs(ref_states[i]).max()
        d = np.abs(np.asarray(q) - ref_states[i]).max() / scale
        assert d < tols[i], (i, d)


def test_epi2_kiops_jit_mixed_precision_matches_reference(mine31):
    """Mixed-precision device-resident exponential stepping: KIOPS Arnoldi
    matvec through the f32 perturbation-form jvp, f64 controller/basis. The 2-step dcmip31 trajectory must stay within the
    same golden tolerances as the full-f64 path."""
    from ref_harness import reference_euler3d_epi_steps

    from wxfactory_tpu.integrators import Epi

    nel_h = 4
    ref_states = reference_euler3d_epi_steps(31, nel_h, NEL_V, S, ZTOP, 30.0, 2)

    from conftest import cs3d_setup
    geom, ops, _topo, metric = cs3d_setup(nel_h, NEL_V, S, 10000.0)
    rhs = make_rhs_euler_cubesphere(geom, ops, metric)
    q = jnp.asarray(dcmip_gravity_wave(geom))
    rhs32 = make_rhs_euler_cubesphere(
        geom, ops, metric, dtype=jnp.float32,
        perturbation_base=q.astype(jnp.float64),
    )
    integ = Epi(rhs, order=2, exponential_solver="kiops_jit", tolerance=1e-7,
                mmin=16, mmax=64, rhs32=rhs32)
    tols = (1e-4, 5e-3)
    for i in range(2):
        q = integ.step(q, 30.0)
        scale = np.abs(ref_states[i]).max()
        d = np.abs(np.asarray(q) - ref_states[i]).max() / scale
        assert d < tols[i], (i, d)


# float64: the tile step is the same arithmetic as the global step up to
# reassociation. float32: the momentum of the initial gravity wave is ~1e-3
# of the density, so one f32 ulp of the density-scale terms is ~6e-5 of the
# momentum scale; the three momentum rows then share one scale (the
# vector's), so the near-zero initial rho*w is not judged on its own tiny
# magnitude.
@pytest.mark.parametrize("n,nel_h,nel_v,s,dtype,atol", [
    pytest.param(1, 4, 3, 2, jnp.float64, 1e-12, id="1"),
    pytest.param(2, 4, 3, 2, jnp.float64, 1e-12, id="2"),
    pytest.param(1, 2, 3, 3, jnp.float64, 1e-12, id="1-s3"),
    pytest.param(1, 2, 2, 4, jnp.float64, 1e-12, id="1-s4"),
    pytest.param(1, 2, 3, 2, jnp.float32, 2e-4, id="1-f32"),
])
def test_shard_map_euler3d_tiles_match_global(n, nel_h, nel_v, s, dtype, atol):
    """The 3D Euler shard_map step (one device per tile over a (6, N, N)
    mesh, 4 interior-shift + 4 edge-colored ppermute halo rounds; the tile
    body IS the model core with per-tile metric operands) matches the
    single-device formulation at 6 and 24 devices, in float64 to machine
    precision and in float32 to its rounding."""
    from jax.sharding import Mesh

    from wxfactory_tpu.parallel.shard_map_euler3d import make_shard_map_euler3d_step

    ndev = 6 * n * n
    if len(jax.devices()) < ndev:
        pytest.skip(f"needs >= {ndev} virtual devices")

    from conftest import cs3d_setup
    geom, ops, _topo, metric = cs3d_setup(nel_h, nel_v, s, 10000.0)
    q = jnp.asarray(dcmip_gravity_wave(geom), dtype)
    rhs = jax.jit(make_rhs_euler_cubesphere(geom, ops, metric, dtype=dtype))
    dt = 1.0

    def plain(qq):
        q1 = qq + rhs(qq) * dt
        q2 = 0.75 * qq + 0.25 * (q1 + rhs(q1) * dt)
        return qq / 3.0 + 2.0 / 3.0 * (q2 + rhs(q2) * dt)

    want = np.asarray(plain(plain(q)))

    mesh = Mesh(np.array(jax.devices()[:ndev]).reshape(6, n, n), ("panel", "y", "x"))
    step, sharding = make_shard_map_euler3d_step(geom, ops, metric, mesh, dt, dtype=dtype)
    got = step(step(jax.device_put(q, sharding)))
    assert got.dtype == dtype
    got = np.asarray(got)
    scale = np.abs(want).max(axis=(1, 2, 3, 4, 5), keepdims=True)
    if dtype == jnp.float32:
        scale[1:4] = scale[1:4].max()
    np.testing.assert_allclose(got / scale, want / scale, atol=atol)


def test_perturbation_form_f32_accuracy():
    """Perturbation-form (base-state-split) 3D Euler: term-level expansion
    around the balanced base state (models/euler_cubesphere.py
    _euler3d_rhs_core_pert). In f64 it must reproduce the absolute operator
    exactly; in f32, stepping the CARRIED perturbation must beat the
    absolute-state f32 trajectory error by >= 2 orders of magnitude
    against the f64 truth (the hydrostatic cancellation never crosses
    float32)."""
    nel_h, nel_v, s = 8, 3, 2
    from conftest import cs3d_setup
    geom, ops, _topo, metric = cs3d_setup(nel_h, nel_v, s, 10000.0)
    q0 = jnp.asarray(dcmip_gravity_wave(geom))

    rhs64 = jax.jit(make_rhs_euler_cubesphere(geom, ops, metric, dtype=jnp.float64))
    pert64 = make_rhs_euler_cubesphere(geom, ops, metric, dtype=jnp.float64,
                                       perturbation_base=q0)
    truth0 = np.asarray(rhs64(q0))
    scale0 = np.abs(truth0).max(axis=(1, 2, 3, 4, 5), keepdims=True)
    # exact (to reassociation roundoff) at the base state; matches the
    # absolute operator nearby
    np.testing.assert_allclose(np.asarray(pert64(q0)) / scale0, truth0 / scale0, atol=1e-13)
    rng = np.random.default_rng(0)
    qp = q0 * (1.0 + 1e-3 * rng.standard_normal(q0.shape))
    tp = np.asarray(rhs64(qp))
    sp = np.abs(tp).max(axis=(1, 2, 3, 4, 5), keepdims=True)
    assert np.abs((np.asarray(pert64(qp)) - tp) / sp).max() < 1e-11

    rhs32 = jax.jit(make_rhs_euler_cubesphere(geom, ops, metric, dtype=jnp.float32))
    pert32 = make_rhs_euler_cubesphere(geom, ops, metric, dtype=jnp.float32,
                                       perturbation_base=q0)
    delta = jax.jit(pert32.delta)

    def run(rhs, q, dt, n):
        for _ in range(n):
            q1 = q + rhs(q) * dt
            q2 = 0.75 * q + 0.25 * (q1 + rhs(q1) * dt)
            q = q / 3.0 + 2.0 / 3.0 * (q2 + rhs(q2) * dt)
        return q

    dt, n = 0.5, 25
    truth = np.asarray(run(rhs64, q0, dt, n))
    dev_scale = np.abs(truth - np.asarray(q0)).max(axis=(1, 2, 3, 4, 5), keepdims=True)
    err_abs = np.abs((np.asarray(run(rhs32, q0.astype(jnp.float32), dt, n)) - truth) / dev_scale).max()
    qprime = np.asarray(run(delta, jnp.zeros_like(q0, dtype=jnp.float32), dt, n))
    err_pert = np.abs((np.asarray(q0) + qprime - truth) / dev_scale).max()
    assert err_pert < err_abs / 50.0, (err_pert, err_abs)


def test_ros2_mixed_precision_matches_f64_path():
    """Mixed-precision Ros2 (f32 pert-form rational matvec + f32 inner
    FGMRES basis, f64 outer residuals/updates — restarted iterative
    refinement, solvers/fgmres_jit.py) must track the full-f64 device path:
    measured 3-step deviation ~4e-6 of the per-variable scale (1.3e-4 for
    the near-zero rho*w)."""
    from wxfactory_tpu.integrators import Ros2

    nel_h, nel_v, dt = 4, 2, 30.0
    from conftest import cs3d_setup
    geom, ops, _topo, metric = cs3d_setup(nel_h, nel_v, S, 10000.0)
    rhs = make_rhs_euler_cubesphere(geom, ops, metric)
    q0 = jnp.asarray(dcmip_gravity_wave(geom))
    rhs32 = make_rhs_euler_cubesphere(geom, ops, metric, dtype=jnp.float32,
                                      perturbation_base=q0)

    ros_mixed = Ros2(rhs, tolerance=1e-7, linear_solver="fgmres_jit", rhs32=rhs32)
    ros_f64 = Ros2(rhs, tolerance=1e-7, linear_solver="fgmres_jit")
    qa = qb = q0
    for _ in range(2):
        qa = ros_mixed.step(qa, dt)
        qb = ros_f64.step(qb, dt)
    assert ros_mixed.solver_info.converged
    qa, qb = np.asarray(qa), np.asarray(qb)
    scale = np.abs(qb).max(axis=(1, 2, 3, 4, 5), keepdims=True)
    errv = np.abs((qa - qb) / scale).max(axis=(1, 2, 3, 4, 5))
    assert errv[[0, 1, 2, 4]].max() < 5e-5, errv
    assert errv[3] < 2e-3, errv


def test_epi2_kiops_canonical_shape_matches_reference():
    """Golden trajectory AT THE CANONICAL dcmip31 SHAPE (reference
    config/dcmip31.ini: 12x12x3 elements, num_solpts=2, dt=30, epi2+kiops,
    tol=1e-7) for 5 steps vs the in-process reference. Per-variable gates:
    rho/momenta/rho*theta track to ~1e-4..4e-4 of their scales; rho*w starts
    near zero (the gravity wave spins up from a theta perturbation), so its
    RELATIVE deviation starts at ~7e-2 of its tiny scale and decays — the
    gate follows the measured decay with ~40% margin."""
    from ref_harness import reference_euler3d_epi_steps

    from wxfactory_tpu.integrators import Epi

    nel_h, nel_v, dt, nsteps = 12, 3, 30.0, 5
    ref_states = reference_euler3d_epi_steps(31, nel_h, nel_v, S, ZTOP, dt, nsteps)

    from conftest import cs3d_setup
    geom, ops, _topo, metric = cs3d_setup(nel_h, nel_v, S, 10000.0)
    rhs = make_rhs_euler_cubesphere(geom, ops, metric)
    q = jnp.asarray(dcmip_gravity_wave(geom))
    integ = Epi(rhs, order=2, exponential_solver="kiops", tolerance=1e-7)
    w_tol = (0.1, 2e-2, 1e-2, 8e-3, 5e-3)
    for k in range(nsteps):
        q = integ.step(q, dt)
        want = ref_states[k]
        scale = np.abs(want).max(axis=(1, 2, 3, 4, 5), keepdims=True)
        errv = np.abs((np.asarray(q) - want) / scale).max(axis=(1, 2, 3, 4, 5))
        assert errv[[0, 1, 2, 4]].max() < 1e-3, (k, errv)
        assert errv[3] < w_tol[k], (k, errv)
