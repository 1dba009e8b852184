"""On-chip smoke test: drive wxfactory_tpu's main path on an NVIDIA GPU.

Run from the root of a checkout:

    python chip_smoke.py               # one GPU: phases 1-5
    python chip_smoke.py --four-cards  # four GPUs: phase 6 only

Phases (one process; the CLI is driven in-process):

1. Refuse to run unless JAX's first device is a GPU.
2. 3D Euler, DCMIP 3-1 gravity wave at the reference's GPU RHS-benchmark
   size (15x15x15 elements, 4 solution points: 1.296 M grid points, f64)
   through ``Simulation``: 3 steps of EPI2 + kiops_jit, then 3 steps of
   Ros2 + fgmres_jit, with the dcmip31 solver settings (tolerance 1e-7,
   gmres_restart 200).
3. Plain references: the GPU f64 RHS against the same RHS jitted on the CPU
   backend, at a 1e-3 perturbation of the phase-2 state (1e-11 of the
   per-variable tendency scale: only the summation order differs) and at
   the near-balanced state itself (3e-10: the tendencies there are residuals
   of cancelling terms); the f32 perturbation-form companion against f64
   where bench.py gates it (5e-3, after 2 small f64 steps from its base);
   one EPI2 step at the canonical dcmip31 shape (12x12x3, s=2, dt=10) on
   the GPU against the CPU (1e-7 relative, the solver tolerance).
4. Shallow water through the CLI: Williamson case 6, nel=64, s=3, EPI3 +
   kiops_jit, 3 steps, one state save inside the run.
5. Timings of one f64 RHS, one f32-companion RHS and one ``jax.jvp``
   matvec at the phase-2 shape, with the bytes XLA's cost analysis reports.
6. (``--four-cards``) Phase 2's EPI2 run at 16x16x15 elements on the
   (2, 1, 2) mesh of four GPUs against the one-GPU run of the same shape
   (1e-10 relative: the reduction order differs).

INI files and outputs go to ``chiprun_out/chip_smoke`` in the checkout.
Every failure raises, so the exit code is non-zero and no result line is
printed. The last line of stdout is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

import argparse
import glob
import json
import os
import shutil
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

import wxfactory_tpu
from wxfactory_tpu.__main__ import main as cli_main
from wxfactory_tpu.integrators.base import apply_rhs
from wxfactory_tpu.models import make_rhs_euler_cubesphere
from wxfactory_tpu.output.state import load_state
from wxfactory_tpu.runtime import enable_compilation_cache
from wxfactory_tpu.simulation import Simulation

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "chiprun_out", "chip_smoke")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet

# (nel_h, nel_v, num_solpts) and dt of each phase.
E3_SHAPE, E3_DT = (15, 15, 4), 10.0
# At the canonical shape one EPI2 step at dcmip31.ini's dt=30 moves by
# ~6e-5 of rho's scale when its input moves by 1e-15, because kiops_jit
# takes another path of rejected substeps; at dt=10 the same change is
# ~2e-11 (tools/backend_witness.py epi2). So the backends are compared at
# dt=10; kiops_jit's accuracy at dt=30 is an open question (ROADMAP).
CANONICAL_SHAPE, CANONICAL_DT = (12, 3, 2), 10.0
SW_SHAPE, SW_DT = (64, 3), 300.0
FOUR_CARD_SHAPE = (16, 15, 4)
NSTEPS = 3

E3_INI = """[General]
equations = euler
[System]
desired_device = {device}
distribute = {distribute}
[Grid]
grid_type = cubed_sphere
ztop = 10000
[Test_case]
case_number = 31
[Time_integration]
dt = {dt}
t_end = {t_end}
time_integrator = {integrator}
exponential_solver = kiops_jit
linear_solver = fgmres_jit
tolerance = 1e-7
gmres_restart = 200
[Spatial_discretization]
num_solpts = {s}
num_elements_horizontal = {nel_h}
num_elements_vertical = {nel_v}
[Output_options]
output_dir = {outdir}
"""

SW_INI = """[General]
equations = shallow_water
[System]
desired_device = {device}
[Grid]
grid_type = cubed_sphere
phi0 = pi/4
[Test_case]
case_number = 6
[Time_integration]
dt = {dt}
t_end = {t_end}
time_integrator = epi3
exponential_solver = kiops_jit
tolerance = 1e-7
[Spatial_discretization]
num_solpts = {s}
num_elements_horizontal = {nel}
[Output_options]
save_state_freq = 2
output_dir = {outdir}
"""


def write_ini(name, text):
    os.makedirs(OUT, exist_ok=True)
    path = os.path.join(OUT, name + ".ini")
    with open(path, "w", encoding="utf-8") as fh:
        fh.write(text)
    return path


def e3_ini(name, device, shape, dt, integrator, distribute="auto", nsteps=NSTEPS):
    nel_h, nel_v, s = shape
    return write_ini(name, E3_INI.format(
        device=device, distribute=distribute, dt=dt, t_end=nsteps * dt, integrator=integrator,
        s=s, nel_h=nel_h, nel_v=nel_v, outdir=os.path.join(OUT, name)))


def sw_ini(name, device, shape, dt, nsteps=NSTEPS):
    nel, s = shape
    return write_ini(name, SW_INI.format(
        device=device, dt=dt, t_end=nsteps * dt, s=s, nel=nel, outdir=os.path.join(OUT, name)))


def say(phase, **kv):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()), flush=True)


def peak_bytes():
    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use", "not reported")


def rel_err(got, want, per_variable):
    """max |got - want| over max |want|, per variable (leading axis) or over
    the whole state."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if not per_variable:
        return float(np.abs(got - want).max() / np.abs(want).max())
    axes = tuple(range(1, want.ndim))
    return (np.abs(got - want).max(axis=axes) / np.abs(want).max(axis=axes)).tolist()


def _rk3_steps(rhs, q, dt, nsteps):
    """``nsteps`` TVD-RK3 steps of ``rhs`` (an argument of the program)."""

    @jax.jit
    def step(f, qq):
        q1 = qq + dt * f(qq)
        q2 = 0.75 * qq + 0.25 * (q1 + dt * f(q1))
        return qq / 3.0 + 2.0 / 3.0 * (q2 + dt * f(q2))

    for _ in range(nsteps):
        q = step(rhs, q)
    return q


def check(ok, what):
    if not ok:
        raise AssertionError(what)


def run_sim(phase, ini_path, nsteps=NSTEPS):
    """Build a Simulation from ``ini_path`` and take ``nsteps`` steps through
    ``Simulation.step``. Returns (sim, final state)."""
    t0 = time.perf_counter()
    sim = Simulation(ini_path)
    jax.block_until_ready(sim.initial_q)
    setup = time.perf_counter() - t0
    q, t, secs, its = sim.initial_q, 0.0, [], []
    for step in range(1, nsteps + 1):
        t0 = time.perf_counter()
        q, t = sim.step(q, step, t)
        jax.block_until_ready(q)
        secs.append(time.perf_counter() - t0)
        info = sim.integrator.solver_info
        check(info.converged and sim.integrator.failure_flag == 0,
              f"{phase}: solver did not converge at step {step}")
        its.append(info.total_num_it)
    steady = secs[1:] or secs
    qn = np.asarray(q)
    check(np.isfinite(qn).all(), f"{phase}: non-finite state")
    say(phase, setup_s=f"{setup:.2f}", compile_s=f"{secs[0] - min(steady):.2f}",
        steps_per_s=f"{len(steady) / sum(steady):.4f}", krylov_its_per_step=its,
        peak_bytes_in_use=peak_bytes(), dt=sim.config.dt, shape=tuple(qn.shape))
    return sim, q


def phase_e3(device, shape=E3_SHAPE, dt=E3_DT):
    """Phase 2: EPI2 and Ros2 at the reference's GPU size. Returns the EPI2
    Simulation and its final state for phases 3 and 5."""
    sims = {}
    for integ in ("epi2", "ros2"):
        sim, q = run_sim(f"2:{integ}", e3_ini(f"e3_{integ}", device, shape, dt, integ))
        rho = np.asarray(q)[0]
        check(0.3 < rho.min() and rho.max() < 1.5, f"2:{integ}: density left (0.3, 1.5)")
        sims[integ] = (sim, q)
    return sims["epi2"]


def phase_reference(sim, q, device, canonical_shape=CANONICAL_SHAPE):
    """Phase 3: the device's RHS and EPI2 step against the CPU backend."""
    # 3a: f64 RHS, device vs CPU backend. Near the balanced phase-2 state the
    # tendencies are residuals of hydrostatic cancellation, orders of
    # magnitude smaller than their terms, so one ulp of the terms in another
    # evaluation order is ~1e-10 of the tendency (jit against eager on one
    # CPU: tools/backend_witness.py rhs): gate 3e-10. Perturbed by 1e-3 the
    # tendencies carry their terms' magnitude and only the summation order
    # can differ: gate 1e-11.
    cfg = sim.config
    shape = (cfg.num_elements_horizontal, cfg.num_elements_vertical, cfg.num_solpts)
    sim_cpu = Simulation(e3_ini("e3_rhs_cpu", "cpu", shape, cfg.dt, "epi2"))
    qn = np.asarray(q)
    q_pert = qn * (1.0 + 1e-3 * np.random.default_rng(1).standard_normal(qn.shape))
    for label, state, gate in (("phase2_state", qn, 3e-10), ("perturbed_1e-3", q_pert, 1e-11)):
        want = np.asarray(apply_rhs(sim_cpu.rhs, jax.device_put(state, sim_cpu.device)))
        got = np.asarray(apply_rhs(sim.rhs, jax.device_put(state, sim.device)))
        err = rel_err(got, want, per_variable=True)
        say(f"3:rhs_f64_vs_cpu_{label}", max_err_over_tendency_scale=err, gate=gate)
        check(max(err) < gate, f"3: f64 RHS differs from the CPU backend ({label})")
        if label == "phase2_state":
            truth = want

    # 3b: f32 perturbation-form companion (base: the initial state) against
    # f64, gated where bench.py gates it: after 2 f64 TVD-RK3 steps from the
    # base at a quarter of the vertical acoustic CFL. At the phase-2 state,
    # 30 s from the base, the error is reported but not gated: it grows with
    # the distance from the base, which the companion never moves (an open
    # question, ROADMAP).
    rhs32 = make_rhs_euler_cubesphere(sim.geom, sim.ops, sim.metric, sim.topology,
                                      dtype=jnp.float32, perturbation_base=sim.initial_q)
    nel_v, s = cfg.num_elements_vertical, cfg.num_solpts
    q_drift = _rk3_steps(sim.rhs, sim.initial_q, min(0.5, 0.25 * (10000.0 / (nel_v * s)) / 340.0), 2)
    for label, state, want64, gate in (
        ("bench_gate_state", q_drift, np.asarray(apply_rhs(sim.rhs, q_drift)), 5e-3),
        ("phase2_state", q, truth, None),
    ):
        got32 = np.asarray(apply_rhs(rhs32.delta, (state - rhs32.base_state).astype(jnp.float32)))
        err32 = rel_err(got32, want64, per_variable=True)
        say(f"3:rhs_f32_companion_vs_f64_{label}", max_err_over_tendency_scale=err32,
            gate=gate or "reported only")
        if gate is not None:
            check(max(err32) < gate, "3: f32 companion outside the accuracy gate")

    # 3c: one EPI2 step at the canonical dcmip31 shape, device vs CPU.
    out = {}
    for dev in (device, "cpu"):
        _, out[dev] = run_sim(f"3:canonical_epi2_{dev}",
                              e3_ini(f"canonical_{dev}", dev, canonical_shape, CANONICAL_DT, "epi2"),
                              nsteps=1)
    err_c = rel_err(out[device], out["cpu"], per_variable=False)
    say("3:canonical_epi2_vs_cpu", max_rel_err=err_c,
        per_variable=rel_err(out[device], out["cpu"], per_variable=True), gate=1e-7)
    check(err_c < 1e-7, "3: canonical EPI2 step differs from the CPU backend")
    return rhs32


def phase_cli(device, shape=SW_SHAPE, dt=SW_DT):
    """Phase 4: shallow water through ``python -m wxfactory_tpu``'s main()."""
    path = sw_ini("sw_case6", device, shape, dt)
    shutil.rmtree(os.path.join(OUT, "sw_case6"), ignore_errors=True)  # an earlier run's saves
    t0 = time.perf_counter()
    rc = cli_main([path])
    check(rc == 0, f"4: CLI exited with {rc}")
    saved = glob.glob(os.path.join(OUT, "sw_case6", "state_vector_*.00000002.npy"))
    check(len(saved) == 1, "4: expected one state save at step 2")
    state, _, _ = load_state(saved[0])
    nel, s = shape
    check(state.shape == (3, 6, nel, nel, s * s) and np.isfinite(state).all(),
          "4: saved state has the wrong shape or is not finite")
    say("4:sw_cli", wall_s=f"{time.perf_counter() - t0:.2f}", dt=dt, saved=os.path.basename(saved[0]),
        peak_bytes_in_use=peak_bytes())


def phase_finding(sim, q, rhs32, card, reps=20):
    """Phase 5: time the f64 RHS, the f32 companion RHS and the jvp matvecs."""
    q32 = q.astype(jnp.float32)
    v = jnp.asarray(np.random.default_rng(0).standard_normal(q.shape)) * 1e-3 * q

    def jvp(f, a, b):
        return jax.jvp(f, (a,), (b,))[1]

    # Each operator is an argument of its program (see the models), as in
    # the integrators; "jvp_f32_companion" is the mixed-precision matvec.
    cases = {
        "rhs_f64": (lambda f, a: f(a), (sim.rhs, q)),
        "rhs_f32_companion": (lambda f, a: f(a), (rhs32, q32)),
        "jvp_f64": (jvp, (sim.rhs, q, v)),
        "jvp_f32_companion": (jvp, (rhs32.xla, q32, v.astype(jnp.float32))),
    }
    for name, (fn, args) in cases.items():
        t0 = time.perf_counter()
        compiled = jax.jit(fn).lower(*args).compile()
        compile_s = time.perf_counter() - t0
        ca = compiled.cost_analysis()
        ca = ca[0] if isinstance(ca, (list, tuple)) else ca
        nbytes = float(ca.get("bytes accessed", 0.0))
        jax.block_until_ready(compiled(*args))
        t0 = time.perf_counter()
        for _ in range(reps):
            out = compiled(*args)
        jax.block_until_ready(out)
        sec = (time.perf_counter() - t0) / reps
        say(f"5:{name}", ms=f"{sec * 1e3:.3f}", compile_s=f"{compile_s:.2f}",
            xla_bytes_accessed=f"{nbytes:.4g}", bytes_per_s=f"{nbytes / sec:.4g}",
            of_3_35TBps=f"{nbytes / sec / HBM_BYTES_PER_S:.3f}", flops=f"{float(ca.get('flops', 0.0)):.4g}",
            card=repr(card))


def phase_four_cards(device, shape=FOUR_CARD_SHAPE, dt=E3_DT):
    """Phase 6: EPI2 on the (2, 1, 2) mesh against one device."""
    check(len(jax.devices()) >= 4, f"6: needs four devices, JAX sees {len(jax.devices())}")
    sim4, q4 = run_sim("6:epi2_mesh", e3_ini("four_mesh", device, shape, dt, "epi2"))
    check(sim4.mesh is not None and sim4.mesh.devices.size == 4
          and tuple(sim4.mesh.devices.shape) == (2, 1, 2),
          f"6: expected a (2, 1, 2) mesh over 4 devices, got {sim4.mesh}")
    say("6:mesh", shape=dict(sim4.mesh.shape), devices=[str(d) for d in sim4.mesh.devices.flat])
    _, q1 = run_sim("6:epi2_one_device", e3_ini("four_single", device, shape, dt, "epi2", distribute="off"))
    err = rel_err(q4, q1, per_variable=False)
    say("6:mesh_vs_one_device", max_rel_err=err, per_variable=rel_err(q4, q1, per_variable=True),
        gate=1e-10)
    check(err < 1e-10, "6: the 4-device run differs from the 1-device run")


def nvidia_smi():
    """Card name and power limit, read by a child process that stays off JAX."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only phase 6, the four-GPU mesh against one GPU")
    args = parser.parse_args(argv)

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke.py needs a GPU; JAX's first device is {dev.platform!r}", file=sys.stderr)
        return 1
    check(os.path.dirname(os.path.abspath(wxfactory_tpu.__file__)) == os.path.join(HERE, "wxfactory_tpu"),
          f"wxfactory_tpu was imported from {wxfactory_tpu.__file__}, not from this checkout")
    card = nvidia_smi()
    say("1:device", nvidia_smi=repr(card), jax=jax.__version__, devices=jax.devices(),
        compilation_cache=enable_compilation_cache())
    if args.four_cards:
        phase_four_cards("cuda")
    else:
        sim, q = phase_e3("cuda")
        rhs32 = phase_reference(sim, q, "cuda")
        phase_cli("cuda")
        phase_finding(sim, q, rhs32, card)
    print(card, flush=True)
    device = {"platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices())}
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
