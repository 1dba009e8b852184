"""Benchmark entry point. Prints one JSON line PER METRIC, then a final line
that carries every metric under "extra".

Every stage times the plain XLA path (the only one the package has) on the
default JAX device, and the run refuses to start without a GPU. Timing is
the wall clock around repeated calls that end in ``jax.block_until_ready``,
after one warm-up call that compiles; a stage that raises or fails its
accuracy gate makes the run exit non-zero.

Metrics (BASELINE.md "Numbers to be measured"):
  * sw_case6_canonical_gp_per_s     — Williamson case 6 at the case6.ini
    discretization (nel=10, s=3), f32 perturbation-form RHS, TVD-RK3 scan.
  * sw_case6_rhs_gridpoints_per_s   — the same scaled to nel=64.
  * sw_s4_rhs_gridpoints_per_s      — nel=64, s=4.
  * sw_galewsky_gp_per_s            — galewsky jet shape (nel=64, s=7).
  * sw_case6_epi3_steps_per_s / sw_galewsky_epi3_steps_per_s — end-to-end
    EPI3 + device-resident KIOPS (case6.ini, galewsky.ini operating points).
  * euler3d_dcmip31_rhs_gp_per_s    — canonical dcmip31 (12x12x3, s=2).
  * euler3d_dcmip31_{epi2,ros2}[_chunked]_steps_per_s — end-to-end EPI2 +
    KIOPS and Ros2 + FGMRES (one XLA program per step; the _chunked variant
    scans 10 steps per dispatch).
  * euler3d_dcmip31_s{2..6}_gp_per_s— the reference's constant-DOF RHS
    benchmark matrix (tests/rhs_benchmark/run.sh there).

vs_baseline ratios come from BASELINE_MEASURED.json (the reference's own
RHS/integrators on a 4-core host CPU, tools/measure_baseline.py).

Accuracy gate (ABSOLUTE): every f32 RHS number is reported only if the f32
RHS error against f64 truth, at a few-step drift state, stays under GATE_REL
(5e-3) of the per-variable tendency scale.

Usage: ``python bench.py [STAGE_SUBSTRING ...]`` runs every stage, or the
stages whose names contain one of the given substrings.
"""

import json
import sys
import time
import traceback
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from wxfactory_tpu.integrators.base import apply_rhs, as_pytree
from wxfactory_tpu.runtime import enable_compilation_cache

jax.config.update("jax_enable_x64", True)

RESULTS = []
FAILED = []
GATE_REL = 5e-3


def emit(metric, value, unit, baseline=None, note=None):
    rec = {"metric": metric, "value": value, "unit": unit,
           "vs_baseline": (value / baseline) if baseline else 1.0}
    if note:
        rec["note"] = note
    RESULTS.append(rec)
    print(json.dumps(rec), flush=True)


def load_baselines():
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "BASELINE_MEASURED.json")
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {}


def _time(fn, reps):
    """Seconds per call of ``fn`` (warm-up call first), and its last output."""
    jax.block_until_ready(fn())
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps, out


# The RHS is an argument of every jitted program here, so the constants of a
# Partial-built model RHS are parameters, not literals (see the models).
@partial(jax.jit, static_argnums=(3,))
def _rk3_scan(delta, dq, dt, nsteps):
    """``nsteps`` TVD-RK3 steps of dq/dt = delta(dq) as one program."""

    def body(q, _):
        q1 = q + dt * delta(q)
        q2 = 0.75 * q + 0.25 * (q1 + dt * delta(q1))
        return q / 3.0 + 2.0 / 3.0 * (q2 + dt * delta(q2)), None

    return jax.lax.scan(body, dq, None, length=nsteps)[0]


def _gate(rhs64, rhs32, q0, dt, nsteps, nvar_axes):
    """f32 perturbation-form RHS vs f64 truth at an ``nsteps`` f64 TVD-RK3
    drift state; returns the max error over the per-variable tendency scale."""
    rhs64 = as_pytree(rhs64)
    qt = _rk3_scan(rhs64, q0, dt, nsteps)
    truth = np.asarray(apply_rhs(rhs64, qt))
    scale = np.abs(truth).max(axis=nvar_axes, keepdims=True)
    got = np.asarray(apply_rhs(as_pytree(rhs32.delta), (qt - rhs32.base_state).astype(jnp.float32)))
    return float(np.abs((got - truth) / scale).max())


def _rhs_rate(name, rhs32, q0, dt, gp, nsteps, reps, err, baseline, what):
    if not err < GATE_REL:
        raise RuntimeError(f"{name}: accuracy gate failed, {err:.2e} of the tendency scale "
                           f"(gate {GATE_REL:.0e})")
    delta = as_pytree(rhs32.delta)
    dq0 = (q0 - rhs32.base_state).astype(jnp.float32)
    dt32 = jnp.asarray(dt, jnp.float32)
    sec, out = _time(lambda: _rk3_scan(delta, dq0, dt32, nsteps), reps)
    if not np.isfinite(np.asarray(out)).all():
        raise RuntimeError(f"{name}: non-finite state after the timed run")
    emit(name, gp * nsteps * 3 / sec, "gridpoints/s", baseline,
         note=f"{what}; f32 perturbation form, TVD-RK3 scan of {nsteps} steps; "
              f"accuracy gate {err:.1e} of tendency scale (gate {GATE_REL:.0e})")


def _sw_setup(nel, s, case="case6"):
    from wxfactory_tpu.geometry import make_cubed_sphere_2d, make_metric_2d
    from wxfactory_tpu.models import make_rhs_shallow_water
    from wxfactory_tpu.ops.dfr import make_dfr_operators
    from wxfactory_tpu.testcases import case_galewsky, williamson_case6

    geom = make_cubed_sphere_2d(nel, s)
    ops = make_dfr_operators(s)
    metric = make_metric_2d(geom)
    ic = case_galewsky if case == "galewsky" else williamson_case6
    return geom, ops, metric, jnp.asarray(ic(geom)), make_rhs_shallow_water


def bench_sw(nel, s, dt, name, baseline, nsteps=100, reps=3, case="case6"):
    geom, ops, metric, q64, make_rhs = _sw_setup(nel, s, case)
    rhs64 = make_rhs(geom, ops, metric, dtype=jnp.float64)
    rhs32 = make_rhs(geom, ops, metric, dtype=jnp.float32, perturbation_base=q64)
    err = _gate(rhs64, rhs32, q64, 150.0 * (10.0 / nel) * (3.0 / s), 4, (1, 2, 3, 4))
    _rhs_rate(name, rhs32, q64, dt, 6 * nel * nel * s * s, nsteps, reps, err, baseline,
              f"{case} nel={nel} s={s}")


def _bench_epi3(name, nel, dt, baseline, case, chunk=4):
    """End-to-end EPI3 + device-resident KIOPS, f32 perturbation-form
    Arnoldi companion, chunked stepping (the multistep history rides the
    scan carry)."""
    from wxfactory_tpu.integrators import Epi

    geom, ops, metric, q64, make_rhs = _sw_setup(nel, 3, case)
    rhs = make_rhs(geom, ops, metric)
    rhs32 = make_rhs(geom, ops, metric, dtype=jnp.float32, perturbation_base=q64)
    epi = Epi(rhs, order=3, tolerance=1e-7, exponential_solver="kiops_jit",
              init_substeps=10, rhs32=rhs32)
    q = epi.step(q64, dt)  # 10-substep Epi2 bootstrap
    q = epi.step(q, dt)
    sec, q = _time(lambda: epi.steps_device(q, dt, chunk), 3)
    if not np.isfinite(np.asarray(q)).all():
        raise RuntimeError(f"{name}: non-finite state")
    emit(name, chunk / sec, "steps/s", baseline,
         note=f"{case} nel={nel} s=3 EPI3 + kiops_jit, mixed precision, dt={dt}, "
              f"{chunk} steps per dispatch")


def _e3_setup(nel_h=12, nel_v=3, s=2, ztop=10000.0):
    from wxfactory_tpu.geometry.cubed_sphere_3d import make_cubed_sphere_3d
    from wxfactory_tpu.geometry.metric3d import make_metric_3d
    from wxfactory_tpu.models import make_rhs_euler_cubesphere
    from wxfactory_tpu.ops.dfr import make_dfr_operators
    from wxfactory_tpu.testcases.dcmip import dcmip_gravity_wave

    geom = make_cubed_sphere_3d(nel_h, nel_v, s, ztop, planet_scaling_factor=125.0,
                                planet_is_rotating=False)
    ops = make_dfr_operators(s, three_d=True)
    metric = make_metric_3d(geom, ops)
    return geom, ops, metric, jnp.asarray(dcmip_gravity_wave(geom)), make_rhs_euler_cubesphere


def bench_e3_rhs(name, nel_h, nel_v, s, baseline, nsteps, reps, what):
    geom, ops, metric, q0, make_rhs = _e3_setup(nel_h, nel_v, s)
    rhs64 = make_rhs(geom, ops, metric)
    rhs32 = make_rhs(geom, ops, metric, dtype=jnp.float32, perturbation_base=q0)
    # Under the vertical acoustic CFL (nel_v * s points in 10 km) with margin.
    dt = min(0.5, 0.25 * (10000.0 / (nel_v * s)) / 340.0)
    err = _gate(rhs64, rhs32, q0, dt, 2, (1, 2, 3, 4, 5))
    _rhs_rate(name, rhs32, q0, dt, 6 * nel_h * nel_h * nel_v * s**3, nsteps, reps, err,
              baseline, what)


def _bench_e3_steps(name, make_integ, baseline, note, chunk=10):
    geom, ops, metric, q0, make_rhs = _e3_setup()
    rhs = make_rhs(geom, ops, metric)
    rhs32 = make_rhs(geom, ops, metric, dtype=jnp.float32, perturbation_base=q0)
    integ = make_integ(rhs, rhs32)
    q = integ.step(q0, 30.0)
    sec, q = _time(lambda: integ.step(q, 30.0), 3)
    emit(name, 1.0 / sec, "steps/s", baseline, note=note + ", dt=30")
    sec_c, q = _time(lambda: integ.steps_device(q, 30.0, chunk), 2)
    if not np.isfinite(np.asarray(q)).all():
        raise RuntimeError(f"{name}: non-finite state")
    emit(name.replace("_steps_per_s", "_chunked_steps_per_s"), chunk / sec_c, "steps/s",
         baseline, note=note + f", {chunk} steps per dispatch")


def stages(b):
    from wxfactory_tpu.integrators import Epi, Ros2

    get = lambda k, f: b.get(k, {}).get(f)
    yield "sw_case6_canonical_gp_per_s", lambda: bench_sw(
        10, 3, 30.0, "sw_case6_canonical_gp_per_s", get("sw_case6_rhs", "gridpoints_per_s"),
        nsteps=200, reps=10)
    yield "sw_case6_rhs_gridpoints_per_s", lambda: bench_sw(
        64, 3, 10.0, "sw_case6_rhs_gridpoints_per_s", get("sw_case6_rhs_nel64", "gridpoints_per_s"))
    yield "sw_s4_rhs_gridpoints_per_s", lambda: bench_sw(64, 4, 30.0, "sw_s4_rhs_gridpoints_per_s", None)
    yield "sw_case6_epi3_steps_per_s", lambda: _bench_epi3(
        "sw_case6_epi3_steps_per_s", 10, 1800.0, get("sw_case6_epi3", "steps_per_s"), "case6")
    yield "euler3d_dcmip31_rhs_gp_per_s", lambda: bench_e3_rhs(
        "euler3d_dcmip31_rhs_gp_per_s", 12, 3, 2, get("euler3d_dcmip31_rhs", "gridpoints_per_s"),
        150, 5, "canonical dcmip31 (12x12x3, s=2)")
    yield "euler3d_dcmip31_epi2_steps_per_s", lambda: _bench_e3_steps(
        "euler3d_dcmip31_epi2_steps_per_s",
        lambda rhs, rhs32: Epi(rhs, order=2, tolerance=1e-7, exponential_solver="kiops_jit",
                               mmin=16, mmax=64, rhs32=rhs32),
        get("euler3d_dcmip31_epi2", "steps_per_s"),
        "EPI2 + kiops_jit, mixed precision (f32 pert-form matvec and basis, f64 H/controller)")
    yield "euler3d_dcmip31_ros2_steps_per_s", lambda: _bench_e3_steps(
        "euler3d_dcmip31_ros2_steps_per_s",
        lambda rhs, rhs32: Ros2(rhs, tolerance=1e-7, gmres_restart=30,
                                linear_solver="fgmres_jit", rhs32=rhs32),
        get("euler3d_dcmip31_ros2", "steps_per_s"),
        "Ros2 + fgmres_jit, mixed precision (f32 inner Arnoldi, f64 outer refinement)")
    yield "sw_galewsky_epi3_steps_per_s", lambda: _bench_epi3(
        "sw_galewsky_epi3_steps_per_s", 30, 900.0, get("sw_galewsky_epi3", "steps_per_s"),
        "galewsky")
    # The reference's constant-DOF matrix (run.sh:66-70 there): s=2..6 at
    # 30/20/15/12/10 elements per direction, ~1.3M gridpoints each.
    for s, n in ((2, 30), (3, 20), (4, 15), (5, 12), (6, 10)):
        name = f"euler3d_dcmip31_s{s}_gp_per_s"
        yield name, lambda name=name, s=s, n=n: bench_e3_rhs(
            name, n, n, s, None, 20, 2, f"constant-DOF dcmip31 {n}^3 elements, s={s}")
    yield "sw_galewsky_gp_per_s", lambda: bench_sw(
        64, 7, 10.0, "sw_galewsky_gp_per_s", None, case="galewsky")


def main(argv):
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py measures the GPU; JAX found {dev.platform!r}", file=sys.stderr)
        return 2
    enable_compilation_cache()
    device = {"platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices())}
    print(json.dumps({"device": device}), flush=True)
    for name, run in stages(load_baselines()):
        if argv and not any(tok in name for tok in argv):
            print(json.dumps({"metric": name, "skipped": "not selected"}), flush=True)
            continue
        try:
            run()
        except Exception:
            traceback.print_exc()
            FAILED.append(name)
            emit(name, 0.0, "failed", note="stage raised; see the traceback on stderr")
    final = dict(RESULTS[0]) if RESULTS else {"metric": "none", "value": 0.0}
    final["device"] = device
    final["failed"] = FAILED
    final["extra"] = {r["metric"]: {"value": r["value"], "unit": r["unit"],
                                    "vs_baseline": r["vs_baseline"]} for r in RESULTS}
    print(json.dumps(final), flush=True)
    return 1 if FAILED else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
