"""The plain XLA paths at the shapes the removed hand-written kernels were
tested at: the float32 perturbation-form companion RHS and its Krylov
matvec against float64, for both cubed-sphere models, and the shallow-water
shard_map tile step (float64 and float32) against the global step on
virtual CPU devices (the 3D tile step's twin is in test_euler3d.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from conftest import cs2d_setup, cs3d_setup
from wxfactory_tpu.models import make_rhs_euler_cubesphere, make_rhs_shallow_water
from wxfactory_tpu.testcases import dcmip_gravity_wave, williamson_case6

# (nel, num_solpts): case6.ini's discretization (10, 3), galewsky-class s=7
# and the other packings the generic SW kernel covered.
SW_SHAPES = [(10, 3), (12, 2), (4, 6), (8, 7), (16, 3), (6, 5), (4, 8)]
# (nel_h, nel_v, num_solpts): canonical dcmip31 (12, 3, 2) and neighbours.
E3_SHAPES = [(4, 4, 4), (12, 3, 2), (6, 4, 3), (4, 2, 3), (4, 8, 2)]


def _scale(a):
    a = np.asarray(a)
    return np.abs(a).max(axis=tuple(range(1, a.ndim)), keepdims=True)


def _sw_case(nel, s):
    geom, ops, _topo, metric = cs2d_setup(nel, s)
    q0 = jnp.asarray(williamson_case6(geom))
    rng = np.random.default_rng(0)
    q = q0 * (1.0 + 1e-3 * rng.standard_normal(q0.shape))
    v = jnp.asarray(rng.standard_normal(q0.shape)) * 1e-3 * _scale(q0)
    rhs64 = make_rhs_shallow_water(geom, ops, metric)
    rhs32 = make_rhs_shallow_water(geom, ops, metric, dtype=jnp.float32, perturbation_base=q0)
    return q0, q, v, rhs64, rhs32


def _e3_case(nel_h, nel_v, s):
    geom, ops, topo, metric = cs3d_setup(nel_h, nel_v, s)
    q0 = jnp.asarray(dcmip_gravity_wave(geom))
    rng = np.random.default_rng(0)
    q = q0 * (1.0 + 1e-4 * rng.standard_normal(q0.shape))
    v = jnp.asarray(rng.standard_normal(q0.shape)) * 1e-3 * _scale(q0)
    rhs64 = make_rhs_euler_cubesphere(geom, ops, metric, topo)
    rhs32 = make_rhs_euler_cubesphere(geom, ops, metric, topo, dtype=jnp.float32,
                                      perturbation_base=q0)
    return q0, q, v, rhs64, rhs32


def _companion_rhs_err(q0, q, rhs64, rhs32):
    truth = np.asarray(jax.jit(rhs64)(q))
    got = np.asarray(jax.jit(rhs32.delta)((q - q0).astype(jnp.float32)))
    absolute = np.asarray(jax.jit(rhs32)(q.astype(jnp.float32)))
    return np.abs((got - truth) / _scale(truth)).max(), np.abs((absolute - truth) / _scale(truth)).max()


def _companion_jvp_err(q, v, rhs64, rhs32):
    """The mixed-precision Krylov matvec (jax.jvp of the companion's
    absolute form, integrators/epi.py) against the f64 jvp."""
    truth = np.asarray(jax.jit(lambda a, b: jax.jvp(rhs64, (a,), (b,))[1])(q, v))
    got = np.asarray(jax.jit(lambda a, b: jax.jvp(rhs32.xla, (a,), (b,))[1])(
        q.astype(jnp.float32), v.astype(jnp.float32)))
    return np.abs((got - truth) / _scale(truth)).max()


# Tolerances: float32 rounding (~6e-8) amplified by the flux-divergence
# cancellations of each model; set with a 2-6x margin over the errors
# measured at these shapes on the CPU backend.
@pytest.mark.parametrize("nel,s", SW_SHAPES)
def test_sw_f32_companion_rhs_matches_f64(nel, s):
    q0, q, _v, rhs64, rhs32 = _sw_case(nel, s)
    err_delta, err_abs = _companion_rhs_err(q0, q, rhs64, rhs32)
    assert err_delta < 1e-4, err_delta
    assert err_abs < 1e-4, err_abs


@pytest.mark.parametrize("nel,s", SW_SHAPES)
def test_sw_f32_companion_jvp_matches_f64(nel, s):
    _q0, q, v, rhs64, rhs32 = _sw_case(nel, s)
    assert _companion_jvp_err(q, v, rhs64, rhs32) < 5e-6


@pytest.mark.parametrize("nel_h,nel_v,s", E3_SHAPES)
def test_e3_f32_companion_rhs_matches_f64(nel_h, nel_v, s):
    q0, q, _v, rhs64, rhs32 = _e3_case(nel_h, nel_v, s)
    err_delta, _err_abs = _companion_rhs_err(q0, q, rhs64, rhs32)
    assert err_delta < 5e-5, err_delta


@pytest.mark.parametrize("nel_h,nel_v,s", E3_SHAPES)
def test_e3_f32_companion_jvp_matches_f64(nel_h, nel_v, s):
    _q0, q, v, rhs64, rhs32 = _e3_case(nel_h, nel_v, s)
    assert _companion_jvp_err(q, v, rhs64, rhs32) < 5e-4


def _rk3(rhs, q, dt):
    q1 = q + rhs(q) * dt
    q2 = 0.75 * q + 0.25 * (q1 + rhs(q1) * dt)
    return q / 3.0 + 2.0 / 3.0 * (q2 + rhs(q2) * dt)


def _tile_mesh():
    if len(jax.devices()) < 6:
        pytest.skip("needs >= 6 virtual devices")
    return Mesh(np.array(jax.devices()[:6]).reshape(6, 1, 1), ("panel", "y", "x"))


# float64: the tile step is the same arithmetic as the global step up to
# reassociation; float32: one f32 ulp of the state per step, relative to the
# per-variable scale.
@pytest.mark.parametrize("nel,s,dtype,tol", [
    (4, 2, jnp.float64, 1e-13), (4, 4, jnp.float64, 1e-13),
    (4, 3, jnp.float32, 1e-6), (6, 2, jnp.float32, 1e-6),
])
def test_sw_tile_step_matches_global(nel, s, dtype, tol):
    from wxfactory_tpu.parallel.shard_map_sw import make_shard_map_sw_step_general

    mesh = _tile_mesh()
    geom, ops, _topo, metric = cs2d_setup(nel, s)
    q0 = jnp.asarray(williamson_case6(geom), dtype)
    dt = 300.0
    rhs = jax.jit(make_rhs_shallow_water(geom, ops, metric, dtype=dtype))
    want = np.asarray(_rk3(rhs, _rk3(rhs, q0, dt), dt))
    step, sharding = make_shard_map_sw_step_general(geom, ops, metric, mesh, dt, dtype=dtype)
    got = step(step(jax.device_put(q0, sharding)))
    assert got.dtype == dtype
    assert np.abs((np.asarray(got) - want) / _scale(want)).max() < tol
