"""Config system, checkpointing, and Simulation driver tests.

Mirrors the reference's test strategy: config validation
(tests/unit/common/test_configuration.py there), state round-trip
(tests/unit/output/test_state.py), and restart semantics
(tests/unit/restart/test_restart.py: run N steps, restart from a saved
state, require identical results)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from wxfactory_tpu.config import Configuration, ConfigurationError, load_configuration
from wxfactory_tpu.output.state import load_state, save_state
from wxfactory_tpu.simulation import Simulation

CASE6_INI = """
[General]
equations = shallow_water
[Grid]
grid_type = cubed_sphere
phi0 = pi/4
[Test_case]
case_number = 6
[Time_integration]
dt = 1800
t_end = {t_end}
time_integrator = {integrator}
exponential_solver = pmex
tolerance = 1e-7
starting_step = {starting_step}
[Spatial_discretization]
num_solpts = 3
num_elements_horizontal = 4
[Output_options]
save_state_freq = {save_freq}
output_dir = {outdir}
"""


def test_reference_configs_parse():
    import glob
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
    from ref_harness import REFERENCE_ROOT, require_reference  # noqa: PLC0415

    require_reference()
    paths = sorted(glob.glob(os.path.join(REFERENCE_ROOT, "config", "*.ini")))
    assert paths, "reference configs missing"
    parsed = 0
    for p in paths:
        if "vortex" in p:  # genuinely incomplete in the reference snapshot
            continue
        c = load_configuration(p)
        assert c.num_solpts >= 1
        parsed += 1
    assert parsed >= 20


def test_config_validation_errors():
    with pytest.raises(ConfigurationError):
        Configuration(CASE6_INI.format(t_end=0, integrator="epi3", starting_step=0,
                                       save_freq=0, outdir="x").replace("num_solpts = 3", "num_solpts = 0"))
    with pytest.raises(ConfigurationError):
        Configuration("[General]\nequations = nonsense\n[Grid]\ngrid_type = cubed_sphere\n")


def test_config_expressions():
    c = Configuration(CASE6_INI.format(t_end=3600, integrator="epi3", starting_step=0,
                                       save_freq=0, outdir="x"))
    assert c.phi0 == pytest.approx(np.pi / 4)


def test_state_roundtrip(tmp_path):
    c = Configuration(CASE6_INI.format(t_end=3600, integrator="epi3", starting_step=0,
                                       save_freq=0, outdir=str(tmp_path)))
    q = np.random.default_rng(0).normal(size=(3, 6, 4, 4, 9))
    path = str(tmp_path / "state.npy")
    save_state(q, c, path)
    q2, c2, version = load_state(path)
    np.testing.assert_array_equal(q, q2)
    assert c2.case_number == c.case_number
    # On-disk payload is panel-major like the reference's gather_cube output.
    with open(path, "rb") as fh:
        raw = np.load(fh)
    assert raw.shape == (6, 3, 4, 4, 9)


def test_simulation_run_and_restart(tmp_path):
    outdir = str(tmp_path / "results")
    full = Simulation(Configuration(CASE6_INI.format(
        t_end=4 * 1800, integrator="epi2", starting_step=0, save_freq=2, outdir=outdir)))
    q_full = np.asarray(full.run())

    restarted = Simulation(Configuration(CASE6_INI.format(
        t_end=4 * 1800, integrator="epi2", starting_step=2, save_freq=2, outdir=outdir)))
    assert restarted.starting_step == 2
    q_rest = np.asarray(restarted.run())

    # Multistep history differs across the restart boundary (the reference's
    # restart has the same property), so allow a tolerance-level difference.
    np.testing.assert_allclose(q_rest, q_full, rtol=1e-5, atol=1e-8)
    assert os.path.exists(os.path.join(outdir, full.output.state_file_name(4).split("/")[-1]))


def test_cli_config_options():
    from wxfactory_tpu.__main__ import main

    assert main(["--config-options"]) == 0


def test_multigrid_preconditioner_via_config(tmp_path):
    """p-MG through the config path on the bubble problem (the reference
    gates this off; simulation.py:274-275 there raises for != none)."""
    ini = """
[General]
equations = euler
[Grid]
grid_type = cartesian2d
x0 = 0
x1 = 1000
z0 = 0
z1 = 1500
[Test_case]
case_number = 2
[Time_integration]
dt = 1
t_end = 2
time_integrator = ros2
tolerance = 1e-7
[Preconditioning]
preconditioner = p-mg
num_mg_levels = 3
pseudo_cfl = 3.0
[Spatial_discretization]
num_solpts = 4
num_elements_horizontal = 5
num_elements_vertical = 7
[Output_options]
output_dir = {outdir}
""".format(outdir=tmp_path)
    sim = Simulation(Configuration(ini))
    q = sim.run()
    assert np.all(np.isfinite(np.asarray(q)))


@pytest.mark.slow  # ~6 min host-path MG run; sphere-MG + config-path coverage
# stays default via test_multigrid_sphere_preconditions_fgmres +
# test_multigrid_preconditioner_via_config
def test_multigrid_sphere_sw_via_config(tmp_path):
    """p-MG on the cubed-sphere shallow-water system (case 6 + ros2):
    per-level geometry/metric/RHS rebuild like the reference
    multigrid.py:38-165, validated end to end through the config path."""
    ini = """
[General]
equations = shallow_water
[Grid]
grid_type = cubed_sphere
[Test_case]
case_number = 6
[Time_integration]
dt = 1800
t_end = 3600
time_integrator = ros2
tolerance = 1e-7
[Preconditioning]
preconditioner = p-mg
num_mg_levels = 2
pseudo_cfl = 3.0
[Spatial_discretization]
num_solpts = 3
num_elements_horizontal = 4
[Output_options]
output_dir = {outdir}
""".format(outdir=tmp_path)
    sim = Simulation(Configuration(ini))
    q = sim.run()
    assert np.all(np.isfinite(np.asarray(q)))


def test_multigrid_sphere_preconditions_fgmres():
    """The SW p-MG V-cycle must be a valid FGMRES preconditioner: the
    preconditioned solve of the stiff rational system reaches the same
    tolerance in no more iterations than the plain solve."""
    import jax
    import jax.numpy as jnp

    from wxfactory_tpu.geometry import make_cubed_sphere_2d, make_metric_2d
    from wxfactory_tpu.models import make_rhs_shallow_water
    from wxfactory_tpu.ops.dfr import make_dfr_operators
    from wxfactory_tpu.precondition import Multigrid
    from wxfactory_tpu.solvers import fgmres
    from wxfactory_tpu.testcases import williamson_case6

    geom = make_cubed_sphere_2d(4, 3)
    ops = make_dfr_operators(3)
    metric = make_metric_2d(geom)
    rhs = make_rhs_shallow_water(geom, ops, metric)
    q = jnp.asarray(williamson_case6(geom))
    dt = 7200.0  # strongly implicit step: the Krylov solve needs many iters

    shape = q.shape

    def apply_A(v):
        vq = jnp.asarray(v.reshape(shape))
        out = vq - 0.5 * dt * jax.jvp(rhs, (q,), (vq,))[1]
        return np.asarray(out).ravel()

    b = np.asarray(rhs(q)).ravel() * dt

    _, r_plain, nb, it_plain, _, _ = fgmres(apply_A, b, tol=1e-7, restart=40, maxiter=3)
    mg = Multigrid.for_geometry(geom, num_levels=2, num_pre_smoothe=2, num_post_smoothe=2, pseudo_cfl=3.0)
    mg.prepare(dt, q)
    _, r_mg, _, it_mg, _, _ = fgmres(apply_A, b, tol=1e-7, restart=40, maxiter=3, preconditioner=mg)

    # Same-or-better convergence per iteration, and a genuinely useful
    # residual drop with the preconditioner.
    assert r_mg <= r_plain * 1.05, (r_mg, r_plain)
    assert it_mg <= it_plain, (it_mg, it_plain)


def test_fv_agglomeration_multigrid_preconditions_fgmres():
    """FV-agglomeration MG (reference precondition/multigrid.py:38-165
    'fv' discretization): DG->FV cell-mean transfer (the Interpolator role)
    into a 2x-agglomerated FV hierarchy. Must (a) round-trip the DG<->FV
    transfer exactly (square modal pair), (b) build the expected level
    chain, and (c) accelerate FGMRES on the implicit bubble system."""
    import jax
    import jax.numpy as jnp

    from wxfactory_tpu.geometry.cartesian import make_cartesian_2d
    from wxfactory_tpu.models import make_rhs_euler_cartesian
    from wxfactory_tpu.ops.dfr import make_dfr_operators
    from wxfactory_tpu.precondition import Multigrid
    from wxfactory_tpu.precondition.multigrid import dg_fv_interpolators
    from wxfactory_tpu.solvers import fgmres
    from wxfactory_tpu.testcases import initialize_cartesian2d

    # (a) exact DG<->FV round trip
    for s in (2, 3, 4):
        m, minv = dg_fv_interpolators(s)
        np.testing.assert_allclose(m @ minv, np.eye(s), atol=1e-12)
        # cell means of a constant are that constant
        np.testing.assert_allclose(m @ np.ones(s), np.ones(s), atol=1e-12)

    s = 3
    geom = make_cartesian_2d((0, 1000), (0, 1500), 4, 6, s)
    rhs = make_rhs_euler_cartesian(geom, make_dfr_operators(s))
    q = jnp.asarray(initialize_cartesian2d(geom, 2))
    dt = 20.0

    mg = Multigrid.for_geometry(geom, kind="fv-mg", num_levels=3,
                                num_pre_smoothe=2, num_post_smoothe=2, pseudo_cfl=3.0)
    # (b) level chain: DG(3) -> FV 12x18 -> FV 6x9 (odd -> stop)
    assert [lv.num_solpts for lv in mg.levels] == [3, 1, 1]
    mg.prepare(dt, q)

    shape = q.shape

    def apply_A(v):
        vq = jnp.asarray(v.reshape(shape))
        out = vq - 0.5 * dt * jax.jvp(rhs, (q,), (vq,))[1]
        return np.asarray(out).ravel()

    b = np.asarray(rhs(q)).ravel() * dt
    _, r_plain, _, it_plain, _, _ = fgmres(apply_A, b, tol=1e-7, restart=30, maxiter=2)
    _, r_mg, _, it_mg, _, _ = fgmres(apply_A, b, tol=1e-7, restart=30, maxiter=2, preconditioner=mg)
    assert r_mg <= r_plain * 1.05, (r_mg, r_plain)
    assert it_mg <= it_plain, (it_mg, it_plain)


def test_multigrid_kiops_smoother_strictly_accelerates_canonical_case5():
    """STRICT acceleration on a canonical stiff solve:
    the Williamson case-5 rational system (I - dt/2 J) x = dt f(Q) at the
    canonical shape (nel=10, s=3; reference config/case5.ini) with a
    strongly implicit dt, solved by FGMRES alone vs FGMRES preconditioned
    by the 2-level p-MG V-cycle with the EXPONENTIAL (KIOPS) smoother
    (reference smoother.py KiopsSmoother). The smoother choice is the
    load-bearing part: A's spectrum is 1 +- i*beta (gravity waves), which
    pseudo-time RK barely damps, while the exponential update contracts the
    error by exp(-tau*A) — |exp(-tau(1+i*beta))| = e^-tau uniformly in
    beta. Measured: 94 plain vs 7-13 preconditioned iterations; gate at 4x."""
    import jax
    import jax.numpy as jnp

    from wxfactory_tpu.geometry import make_cubed_sphere_2d, make_metric_2d
    from wxfactory_tpu.models import make_rhs_shallow_water
    from wxfactory_tpu.ops.dfr import make_dfr_operators
    from wxfactory_tpu.precondition import Multigrid
    from wxfactory_tpu.solvers import fgmres
    from wxfactory_tpu.testcases import williamson_case5

    geom = make_cubed_sphere_2d(10, 3)
    ops = make_dfr_operators(3)
    metric = make_metric_2d(geom)
    q0, topo = williamson_case5(geom, ops)
    rhs = make_rhs_shallow_water(geom, ops, metric, topo=topo)
    q = jnp.asarray(q0)
    dt = 3600.0

    shape = q.shape
    jvp = jax.jit(lambda v: jax.jvp(rhs, (q,), (v,))[1])

    def apply_A(v):
        vq = jnp.asarray(v.reshape(shape))
        return np.asarray(vq - 0.5 * dt * jvp(vq)).ravel()

    b = np.asarray(rhs(q)).ravel() * dt
    _, r_plain, _, it_plain, _, _ = fgmres(apply_A, b, tol=1e-7, restart=100, maxiter=3)

    # tau = pseudo_cfl / (4 * nel * s^2) = 720/360 = 2 pseudo-seconds.
    mg = Multigrid.for_geometry(geom, num_levels=2, num_pre_smoothe=1,
                                num_post_smoothe=1, pseudo_cfl=720.0,
                                smoother="kiops")
    mg.prepare(dt, q)
    _, r_mg, _, it_mg, _, _ = fgmres(apply_A, b, tol=1e-7, restart=100, maxiter=3,
                                     preconditioner=mg)
    assert r_mg <= r_plain * 1.05, (r_mg, r_plain)
    assert it_mg * 4 <= it_plain, (it_mg, it_plain)


def test_rhs_timing_sampled_in_real_run(tmp_path):
    """Per-stage RHS timing during a PRODUCTION run (reference
    rhs/rhs.py:88-118 persists stage timestamps per step to the
    solver-stats rhs_timing table): with store_solver_stats +
    rhs_timing_freq, every sampled step writes one row per stage."""
    import sqlite3

    outdir = str(tmp_path / "results")
    ini = CASE6_INI.format(t_end=2 * 1800, integrator="epi2", starting_step=0,
                           save_freq=0, outdir=outdir)
    ini += "store_solver_stats = 1\nrhs_timing_freq = 1\n"
    sim = Simulation(Configuration(ini))
    sim.run()
    db = sqlite3.connect(os.path.join(outdir, "solver_stats.db"))
    rows = db.execute("SELECT step_id, stage, elapsed FROM rhs_timing").fetchall()
    stages = {r[1] for r in rows}
    steps = {r[0] for r in rows}
    assert {"full_rhs(fused)", "extrapolation", "interior_derivative",
            "halo_exchange"} <= stages
    assert steps == {1, 2}
    assert all(r[2] > 0.0 for r in rows)


def test_device_step_chunk_matches_single_steps(tmp_path):
    """`device_step_chunk` (extension: N steps per device
    dispatch, simulation.py run loop) must not change the trajectory, must
    still land checkpoints exactly on their configured steps, and must
    store per-chunk solver stats."""
    import sqlite3

    base_ini = CASE6_INI.format(t_end=6 * 1800, integrator="epi2", starting_step=0,
                                save_freq=3, outdir=str(tmp_path / "single")).replace(
        "exponential_solver = pmex", "exponential_solver = kiops_jit")
    base_ini += "store_solver_stats = 1\n"  # appends inside [Output_options]
    q_single = np.asarray(Simulation(Configuration(base_ini)).run())

    chunk_ini = CASE6_INI.format(t_end=6 * 1800, integrator="epi2", starting_step=0,
                                 save_freq=3, outdir=str(tmp_path / "chunk")).replace(
        "exponential_solver = pmex",
        "exponential_solver = kiops_jit\ndevice_step_chunk = 4")
    chunk_ini += "store_solver_stats = 1\n"
    sim = Simulation(Configuration(chunk_ini))
    # The event calendar (save_state_freq=3) caps chunks at the checkpoint
    # steps: 3,3 (never the full 4).
    assert sim._chunk_len(0, 0.0) == 3
    assert sim._chunk_len(3, 3 * 1800.0) == 3
    q_chunk = np.asarray(sim.run())

    scale = np.abs(q_single).max(axis=(1, 2, 3, 4), keepdims=True)
    np.testing.assert_allclose(q_chunk / scale, q_single / scale, atol=1e-9)
    # Checkpoints landed on steps 3 and 6, identically placed.
    for sid in (3, 6):
        assert os.path.exists(sim.output.state_file_name(sid)), sid
    db = sqlite3.connect(os.path.join(str(tmp_path / "chunk"), "solver_stats.db"))
    steps = [r[0] for r in db.execute("SELECT step_id FROM results_data ORDER BY step_id")]
    assert steps == [3, 6]  # one aggregate row per chunk


def test_device_step_chunk_respects_t_end_clamp(tmp_path):
    """A chunked run whose t_end is NOT a multiple of dt must stop at
    exactly t_end (the clamped final partial step runs through the
    single-step path) and match the unchunked trajectory."""
    t_end = int(4.5 * 1800)  # 4 full steps + one clamped 900 s step
    single_ini = CASE6_INI.format(t_end=t_end, integrator="epi2", starting_step=0,
                                  save_freq=0, outdir=str(tmp_path / "s")).replace(
        "exponential_solver = pmex", "exponential_solver = kiops_jit")
    q_single = np.asarray(Simulation(Configuration(single_ini)).run())

    chunk_ini = CASE6_INI.format(t_end=t_end, integrator="epi2", starting_step=0,
                                 save_freq=0, outdir=str(tmp_path / "c")).replace(
        "exponential_solver = pmex",
        "exponential_solver = kiops_jit\ndevice_step_chunk = 3")
    sim = Simulation(Configuration(chunk_ini))
    assert sim._chunk_len(0, 0.0) == 3          # chunk the first 3 full steps
    assert sim._chunk_len(3, 3 * 1800.0) == 1   # one full step left before clamp
    q_chunk = np.asarray(sim.run())

    scale = np.abs(q_single).max(axis=(1, 2, 3, 4), keepdims=True)
    np.testing.assert_allclose(q_chunk / scale, q_single / scale, atol=1e-9)
