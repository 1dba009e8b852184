"""How far the 3D Euler answers move on one CPU when nothing changes but the
evaluation order or the last bits of the input: the witnesses behind the
gates of chip_smoke.py's phase 3, which compares the GPU with the CPU
backend (two backends differ in summation order and nothing else).

Parts (run from the root of a checkout, on the CPU):

    JAX_PLATFORMS=cpu python tools/backend_witness.py epi2 --dt 30 10
    JAX_PLATFORMS=cpu python tools/backend_witness.py rhs

``epi2``: one EPI2 + kiops_jit step of DCMIP 3-1 at the canonical shape
(12x12x3, s=2, tolerance 1e-7) through ``Simulation``, from the initial
state and from the initial state times (1 + 1e-15 noise), at each dt.
Prints the change per variable over the per-variable state scale, with the
Krylov iterations, substeps and rejected substeps of each step.

``rhs``: the f64 RHS at a near-balanced state (the initial state after
3 EPI2 steps at dt=10; 4x15x4 by default), jitted against eager (op by op),
per variable over the tendency scale, at that state and at a 1e-3
perturbation of it. Also the f32 perturbation-form companion (base: the
initial state) against f64 at chip_smoke's gate state (2 small TVD-RK3
steps from the base) and at the near-balanced state (30 s from the base).
"""

import argparse
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from wxfactory_tpu.config import Configuration  # noqa: E402
from wxfactory_tpu.integrators.base import apply_rhs  # noqa: E402
from wxfactory_tpu.models import make_rhs_euler_cubesphere  # noqa: E402
from wxfactory_tpu.simulation import Simulation  # noqa: E402

INI = """[General]
equations = euler
[System]
desired_device = cpu
distribute = off
[Grid]
grid_type = cubed_sphere
ztop = 10000
[Test_case]
case_number = 31
[Time_integration]
dt = {dt}
t_end = {t_end}
time_integrator = epi2
exponential_solver = kiops_jit
tolerance = 1e-7
[Spatial_discretization]
num_solpts = {s}
num_elements_horizontal = {nel_h}
num_elements_vertical = {nel_v}
[Output_options]
output_dir = {outdir}
"""


def simulation(shape, dt, nsteps, outdir):
    nel_h, nel_v, s = shape
    return Simulation(Configuration(INI.format(
        dt=dt, t_end=nsteps * dt, s=s, nel_h=nel_h, nel_v=nel_v, outdir=outdir)))


def per_variable(got, want):
    """max |got - want| over max |want|, per variable (leading axis)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    axes = tuple(range(1, want.ndim))
    return np.abs(got - want).max(axis=axes) / np.abs(want).max(axis=axes)


def epi2_sensitivity(dt, shape=(12, 3, 2), eps=1e-15, seed=0, outdir="chiprun_out/backend_witness"):
    """One EPI2 step from q0 and from q0 * (1 + eps * noise). Returns the
    per-variable change and the solver reports of both steps."""
    sim = simulation(shape, dt, 1, outdir)
    q0 = np.asarray(sim.initial_q)
    noise = np.random.default_rng(seed).standard_normal(q0.shape)
    out, reports = [], []
    for e in (0.0, eps):
        q = sim.integrator.step(jnp.asarray(q0 * (1.0 + e * noise)), dt)
        info = sim.integrator.solver_info
        out.append(np.asarray(q))
        reports.append(dict(krylov_its=info.total_num_it, substeps=info.num_substeps,
                            rejected=info.num_rejected, converged=bool(info.converged)))
    return per_variable(out[1], out[0]), reports


def rhs_order_and_f32(shape=(4, 15, 4), dt=10.0, nsteps=3, outdir="chiprun_out/backend_witness"):
    """RHS jit vs eager at the near-balanced state and 1e-3 off it, and the
    f32 companion's error at the gate state and the near-balanced state."""
    sim = simulation(shape, dt, nsteps, outdir)
    q = sim.initial_q
    for step in range(1, nsteps + 1):
        q, _ = sim.step(q, step, (step - 1) * dt)
    qn = np.asarray(q)
    q_pert = jnp.asarray(qn * (1.0 + 1e-3 * np.random.default_rng(1).standard_normal(qn.shape)))
    readings = {}
    for label, state in (("near_balanced", q), ("perturbed_1e-3", q_pert)):
        jitted = apply_rhs(sim.rhs, state)
        with jax.disable_jit():
            eager = sim.rhs(state)
        readings[f"rhs_jit_vs_eager_{label}"] = per_variable(jitted, eager)

    rhs32 = make_rhs_euler_cubesphere(sim.geom, sim.ops, sim.metric, sim.topology,
                                      dtype=jnp.float32, perturbation_base=sim.initial_q)
    nel_v, s = shape[1], shape[2]
    dt_gate = min(0.5, 0.25 * (10000.0 / (nel_v * s)) / 340.0)
    q_gate = sim.initial_q
    for _ in range(2):  # chip_smoke's gate state: 2 small TVD-RK3 steps
        q1 = q_gate + dt_gate * apply_rhs(sim.rhs, q_gate)
        q2 = 0.75 * q_gate + 0.25 * (q1 + dt_gate * apply_rhs(sim.rhs, q1))
        q_gate = q_gate / 3.0 + 2.0 / 3.0 * (q2 + dt_gate * apply_rhs(sim.rhs, q2))
    for label, state in (("gate_state", q_gate), (f"{nsteps * dt:g}s_from_base", q)):
        got32 = apply_rhs(rhs32.delta, (state - rhs32.base_state).astype(jnp.float32))
        readings[f"f32_companion_vs_f64_{label}"] = per_variable(got32, apply_rhs(sim.rhs, state))
    return readings


def fmt(values):
    return "[" + ", ".join(f"{v:.3g}" for v in values) + "]"


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("part", choices=["epi2", "rhs"])
    parser.add_argument("--dt", type=float, nargs="+", default=[30.0, 10.0])
    parser.add_argument("--shape", type=int, nargs=3, default=None,
                        help="nel_h nel_v num_solpts (default: 12 3 2 for epi2, 4 15 4 for rhs)")
    args = parser.parse_args(argv)
    print(f"jax {jax.__version__} on {jax.devices()[0].device_kind}; variables rho, rho*u1, "
          "rho*u2, rho*w, rho*theta", flush=True)
    if args.part == "epi2":
        shape = tuple(args.shape or (12, 3, 2))
        for dt in args.dt:
            change, reports = epi2_sensitivity(dt, shape)
            print(f"epi2 shape={shape} dt={dt:g}: change from a 1e-15 input perturbation "
                  f"{fmt(change)} (max {change.max():.3g}); steps {reports}", flush=True)
    else:
        shape = tuple(args.shape or (4, 15, 4))
        for name, values in rhs_order_and_f32(shape).items():
            print(f"{name} shape={shape}: {fmt(values)} (max {values.max():.3g})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
