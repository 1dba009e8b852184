"""Golden parity tests: run the ACTUAL reference implementation (in-process,
6 fake-MPI lockstep threads — tools/ref_harness.py) and compare initial
conditions and RHS evaluations pointwise.

This is the strongest correctness guarantee in the suite: it exercises the
geometry, metric, DFR operators, panel-edge halo exchange (flips + vector
basis rotations), AUSM fluxes, topography and forcing terms end to end
against the reference's own numerics.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

from ref_harness import reference_sw_case  # noqa: E402

from wxfactory_tpu.geometry import make_cubed_sphere_2d, make_metric_2d  # noqa: E402
from wxfactory_tpu.models import make_rhs_shallow_water  # noqa: E402
from wxfactory_tpu.ops.dfr import make_dfr_operators  # noqa: E402
from wxfactory_tpu.testcases import williamson_case2, williamson_case5, williamson_case6  # noqa: E402

CASES = [
    (2, (0.0, 0.0, 0.0)),
    (2, (-0.3, 0.2, -0.15)),  # rotated grid
    (5, (0.0, 0.0, 0.0)),  # topography
    (6, (0.0, 0.0, 0.0)),
]


def test_sw_case1_ic_matches_reference():
    """Cosine-bell (Williamson case 1) initial-condition parity through the
    full harness. Cases 0/9/10 cannot run through the harness: the reference
    snapshot's own circular_vortex / case_matsuno / case_unsteady_zonal crash
    (old-layout ``ni, nj = geom.lat.shape`` against the new-layout geometry,
    shallow_water_test.py:92,362,424) — their formulas are golden-tested
    directly below instead."""
    from wxfactory_tpu.testcases import williamson_case1  # noqa: PLC0415

    nel, s = 3, 3
    q_ref, _dq_ref = reference_sw_case(1, nel, s)
    geom = make_cubed_sphere_2d(nel, s)
    q_mine = williamson_case1(geom)
    scale_q = np.abs(q_ref).max(axis=(1, 2, 3, 4), keepdims=True)
    assert (np.abs(q_mine - q_ref) / scale_q).max() < 1e-12, "initial condition mismatch"


def test_matsuno_fields_match_reference_module():
    """Golden parity of the Matsuno wave algebra (case 9) against the
    reference's standalone init/matsuno.py (368 LoC: wave frequencies,
    Hermite-function amplitudes, field assembly), evaluated directly on raw
    lat/lon arrays for every field/wave-type at t=0 and t=3600."""
    import importlib.util  # noqa: PLC0415

    from ref_harness import REFERENCE_PATH, require_reference  # noqa: PLC0415

    from wxfactory_tpu.testcases import matsuno as mine  # noqa: PLC0415

    require_reference()
    spec = importlib.util.spec_from_file_location(
        "ref_matsuno", os.path.join(REFERENCE_PATH, "init", "matsuno.py")
    )
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)

    rng = np.random.default_rng(3)
    lat = rng.uniform(-np.pi / 2, np.pi / 2, size=12)
    lon = rng.uniform(0.0, 2 * np.pi, size=12)

    for wave_type in ("Rossby", "EIG", "WIG"):
        for field in ("phi", "u", "v"):
            for t in (0.0, 3600.0):
                # The reference eval_field is scalar-only (matsuno.py:342).
                want = np.array(
                    [ref.eval_field(la, lo, t, field=field, wave_type=wave_type, amp=1e-5)
                     for la, lo in zip(lat, lon)]
                )
                got = mine.eval_field(lat, lon, t, field=field, wave_type=wave_type, amp=1e-5)
                np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-300)


def test_vortex_ic_matches_reference_formulas():
    """Golden parity of the circular-vortex fields (case 0, Nair &
    Machenhauer 2002) against the reference's height_vortex run on a 2D
    proxy view (the snapshot's own function only accepts the old block
    layout, shallow_water_test.py:92)."""
    import importlib  # noqa: PLC0415
    import math  # noqa: PLC0415
    from types import SimpleNamespace  # noqa: PLC0415

    from ref_harness import _install_fake_modules  # noqa: PLC0415

    from wxfactory_tpu.testcases import circular_vortex, height_vortex  # noqa: PLC0415

    _install_fake_modules()
    swt = importlib.import_module("init.shallow_water_test")

    nel, s = 3, 3
    geom = make_cubed_sphere_2d(nel, s)
    lat2 = np.asarray(geom.lat).reshape(6 * nel * nel, s * s)
    lon2 = np.asarray(geom.lon).reshape(6 * nel * nel, s * s)
    proxy = SimpleNamespace(
        lat=lat2, lon=lon2, sinlat=np.sin(lat2), coslat=np.cos(lat2),
        earth_radius=geom.earth_radius,
    )
    param = SimpleNamespace(dt=60.0)
    h_ref, omega_ref = swt.height_vortex(proxy, None, param, 0)

    h_mine, omega_mine = height_vortex(geom, 0.0)
    np.testing.assert_allclose(np.asarray(h_mine).reshape(h_ref.shape), h_ref, rtol=1e-13)
    np.testing.assert_allclose(np.asarray(omega_mine).reshape(omega_ref.shape), omega_ref, rtol=1e-13)

    # Wind field: reference formulas inlined in circular_vortex (:52-60).
    lon_c, lat_c = math.pi - 0.8, math.pi / 4.8
    u_ref = geom.earth_radius * omega_ref.reshape(geom.lat.shape) * (
        math.sin(lat_c) * np.cos(geom.lat) - math.cos(lat_c) * np.cos(geom.lon - lon_c) * np.sin(geom.lat)
    )
    v_ref = geom.earth_radius * omega_ref.reshape(geom.lat.shape) * math.cos(lat_c) * np.sin(geom.lon - lon_c)
    q = circular_vortex(geom)
    u, v = geom.contra2wind(q[1] / q[0], q[2] / q[0])
    np.testing.assert_allclose(np.asarray(u), u_ref, atol=1e-9)
    np.testing.assert_allclose(np.asarray(v), v_ref, atol=1e-9)


def test_sw_multistep_trajectory_matches_reference():
    """Multi-step golden test: 3 TVD-RK3 steps of case 6 must track the
    reference's own stepping (tools/ref_harness.reference_sw_steps running
    its integrators/tvdrk3.py) pointwise at every step."""
    from ref_harness import reference_sw_steps  # noqa: PLC0415

    from wxfactory_tpu.integrators import Tvdrk3  # noqa: PLC0415

    nel, s, dt, nsteps = 3, 3, 300.0, 3
    ref_states = reference_sw_steps(6, nel, s, dt, nsteps)

    geom = make_cubed_sphere_2d(nel, s)
    ops = make_dfr_operators(s)
    metric = make_metric_2d(geom)
    rhs = make_rhs_shallow_water(geom, ops, metric)
    integ = Tvdrk3(rhs)
    q = jnp.asarray(williamson_case6(geom))
    for k in range(nsteps):
        q = integ.step(q, dt)
        want = ref_states[k]
        scale = np.abs(want).max(axis=(1, 2, 3, 4), keepdims=True)
        err = np.abs((np.asarray(q) - want) / scale).max()
        assert err < 1e-11, (k, err)


def test_sw_case10_analytic_consistency():
    """Unsteady zonal flow (case 10, Laeuter et al. 2005): the reference's
    own builder is broken in this snapshot, so check against the analytic
    solution directly: v = 0, u = u0*cos(lat), and the total geopotential
    g*(h + hsurf) equals the closed form at t = 0."""
    from wxfactory_tpu.common.constants import DAY_IN_SECS, GRAVITY  # noqa: PLC0415
    from wxfactory_tpu.testcases import case_unsteady_zonal  # noqa: PLC0415

    nel, s = 3, 3
    geom = make_cubed_sphere_2d(nel, s)
    ops = make_dfr_operators(s)
    q, topo = case_unsteady_zonal(geom, ops)

    u0 = 2.0 * np.pi * geom.earth_radius / (12.0 * DAY_IN_SECS)
    k1, k2 = 133681.0, 10.0
    u, v = geom.contra2wind(q[1] / q[0], q[2] / q[0])
    np.testing.assert_allclose(np.asarray(v), 0.0, atol=1e-9)
    np.testing.assert_allclose(np.asarray(u), u0 * np.cos(geom.lat), rtol=1e-12)

    # Laeuter et al. (2005): at t=0 the flow axis is the rotation axis, so
    # phi_total = -0.5*(u0 sin(lat) + Omega*a*sin(lat))^2 + 0.5*(Omega*a*sin(lat))^2 + k1,
    # and the surface geopotential is 0.5*(Omega*a*sin(lat))^2 + k2.
    sinl = np.sin(geom.lat)
    oa = geom.rotation_speed * geom.earth_radius
    phi_total = -0.5 * (u0 * sinl + oa * sinl) ** 2 + 0.5 * (oa * sinl) ** 2 + k1
    np.testing.assert_allclose(GRAVITY * (q[0] + topo.hsurf), phi_total, rtol=1e-11)
    np.testing.assert_allclose(GRAVITY * topo.hsurf, 0.5 * (oa * sinl) ** 2 + k2, rtol=1e-11)


@pytest.mark.parametrize("case_number,rotation", CASES)
def test_sw_rhs_matches_reference(case_number, rotation):
    nel, s = 3, 3
    l0, p0, a0 = rotation
    q_ref, dq_ref = reference_sw_case(case_number, nel, s, l0, p0, a0)

    geom = make_cubed_sphere_2d(nel, s, lambda0=l0, phi0=p0, alpha0=a0)
    ops = make_dfr_operators(s)
    metric = make_metric_2d(geom)

    if case_number == 2:
        q_mine, topo = williamson_case2(geom), None
    elif case_number == 5:
        q_mine, topo = williamson_case5(geom, ops)
    elif case_number == 6:
        q_mine, topo = williamson_case6(geom), None
    else:
        raise ValueError(case_number)

    scale_q = np.abs(q_ref).max()
    assert np.abs(q_mine - q_ref).max() / scale_q < 1e-13, "initial condition mismatch"

    rhs = make_rhs_shallow_water(geom, ops, metric, topo=topo)
    dq_mine = np.asarray(rhs(jnp.asarray(q_ref)))
    scale_dq = np.abs(dq_ref).max()
    assert np.abs(dq_mine - dq_ref).max() / scale_dq < 1e-11, "RHS mismatch"


def test_sw_case6_epi3_pmex_canonical_matches_reference():
    """Golden trajectory test AT THE CANONICAL SHAPE through the exponential
    stack: Williamson case 6 at the reference's own run configuration
    (config/case6.ini there: nel=10, num_solpts=3, dt=1800, epi3 + pmex,
    tol=1e-7) for 5 steps vs the in-process reference (its Epi integrator
    with complex-step Jacobian, its pmex, its 10-substep Epi2 bootstrap).
    Measured deviation <= 7.5e-9 of the per-variable scale; gate at 1e-7."""
    from ref_harness import reference_sw_epi_steps  # noqa: PLC0415

    from wxfactory_tpu.integrators import Epi  # noqa: PLC0415

    nel, s, dt, nsteps = 10, 3, 1800.0, 5
    ref_states = reference_sw_epi_steps(6, nel, s, dt, nsteps, order=3,
                                        exponential_solver="pmex", tolerance=1e-7)

    geom = make_cubed_sphere_2d(nel, s)
    ops = make_dfr_operators(s)
    metric = make_metric_2d(geom)
    rhs = make_rhs_shallow_water(geom, ops, metric)
    epi = Epi(rhs, order=3, tolerance=1e-7, exponential_solver="pmex", init_substeps=10)
    q = jnp.asarray(williamson_case6(geom))
    for k in range(nsteps):
        q = epi.step(q, dt)
        want = ref_states[k]
        scale = np.abs(want).max(axis=(1, 2, 3, 4), keepdims=True)
        err = np.abs((np.asarray(q) - want) / scale).max()
        assert err < 1e-7, (k, err)
