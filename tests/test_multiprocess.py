"""Multi-controller (multi-host) execution tests.

The reference validates its MPI scale-out by actually running under mpirun
(tests/unit/run_mpi_tests.py there); the JAX analogue launches TWO
real controller processes on the CPU backend (4 virtual devices each),
joined by jax.distributed over localhost, and asserts that a sharded
EPI2+kiops_jit trajectory over the cross-process mesh and a distributed
checkpoint/restart round trip match the single-process run exactly."""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "mp_worker.py")


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _single_process_reference(nel=8, s=2, dt=60.0, steps=2):
    from wxfactory_tpu.geometry import make_cubed_sphere_2d, make_metric_2d
    from wxfactory_tpu.integrators import Epi
    from wxfactory_tpu.models import make_rhs_shallow_water
    from wxfactory_tpu.ops.dfr import make_dfr_operators
    from wxfactory_tpu.testcases import williamson_case6

    geom = make_cubed_sphere_2d(nel, s)
    ops = make_dfr_operators(s)
    metric = make_metric_2d(geom)
    rhs = make_rhs_shallow_water(geom, ops, metric)
    q = jnp.asarray(williamson_case6(geom))
    epi = Epi(rhs, order=2, tolerance=1e-7, exponential_solver="kiops_jit", mmin=16, mmax=64)
    for _ in range(steps):
        q = epi.step(q, dt)
    q2 = q
    epi_restart = Epi(rhs, order=2, tolerance=1e-7, exponential_solver="kiops_jit", mmin=16, mmax=64)
    q3 = epi_restart.step(q2, dt)
    return np.asarray(q2), np.asarray(q3)


@pytest.mark.slow
def test_two_process_epi2_and_restart(tmp_path):
    """Launch 2 controller processes; the mesh spans both (8 devices).
    The sharded EPI2 trajectory, the distributed checkpoint round trips
    (both on-disk forms) and the post-restart step must match the
    single-process run."""
    port = _free_port()
    outdir = str(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(port), "2", str(i), outdir],
            env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=900)
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out[-4000:]}"
        assert f"worker {i}: OK" in out

    want2, want3 = _single_process_reference()
    got2 = np.load(os.path.join(outdir, "result.npy"))
    got3 = np.load(os.path.join(outdir, "result_restart.npy"))
    scale2 = np.abs(want2).max(axis=(1, 2, 3, 4), keepdims=True)
    scale3 = np.abs(want3).max(axis=(1, 2, 3, 4), keepdims=True)
    assert np.abs((got2 - want2) / scale2).max() < 1e-10
    assert np.abs((got3 - want3) / scale3).max() < 1e-10

    # The sharded-manifest checkpoint artifacts exist and parse.
    manifest = os.path.join(outdir, "ckpt_sharded.npy")
    assert os.path.exists(manifest)
    import json

    with open(manifest) as fh:
        m = json.load(fh)
    assert m["format"] == "wxfactory_tpu-sharded-state"
    assert len(m["shards"]) == 8  # one per device across both processes


DRIVER_WORKER = os.path.join(REPO, "tests", "mp_driver_worker.py")

DRIVER_INI = """
[General]
equations = shallow_water
[Grid]
grid_type = cubed_sphere
phi0 = pi/4
[Test_case]
case_number = 6
[Time_integration]
dt = 60
t_end = 240
time_integrator = tvdrk3
tolerance = 1e-7
{extra}
[Spatial_discretization]
num_solpts = 3
num_elements_horizontal = 4
[Output_options]
output_dir = {outdir}
save_state_freq = 2
stat_freq = 2
"""


def _launch_driver_workers(port, config_path):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    procs = [
        subprocess.Popen(
            [sys.executable, DRIVER_WORKER, str(port), "2", str(i), config_path],
            env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=900)
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"driver worker {i} failed:\n{out[-4000:]}"
    return outs


@pytest.mark.slow
def test_two_process_production_driver(tmp_path):
    """The REAL CLI (`__main__ --num-processes 2`) runs the case6 config on
    a mesh spanning two controller processes (12 virtual devices each ->
    (6,2,2)), with rank-gated stdout/blockstats, a distributed checkpoint,
    and a restart THROUGH the driver — all matching the single-process
    trajectory."""
    from wxfactory_tpu.simulation import Simulation

    outdir_mp = str(tmp_path / "mp")
    cfg = str(tmp_path / "case6_mp.ini")
    with open(cfg, "w") as fh:
        fh.write(DRIVER_INI.format(outdir=outdir_mp, extra=""))

    outs = _launch_driver_workers(_free_port(), cfg)
    # Rank gating: the step log + blockstats print on process 0 only.
    assert "Step 4/4" in outs[0]
    assert "Step 4/4" not in outs[1]
    assert ("mass" in outs[0].lower()) or ("integral" in outs[0].lower())

    # Single-process reference of the same config, same driver.
    outdir_1p = str(tmp_path / "single")
    cfg1 = str(tmp_path / "case6_1p.ini")
    with open(cfg1, "w") as fh:
        fh.write(DRIVER_INI.format(outdir=outdir_1p, extra="")
                 + "[System]\ndistribute = off\n")
    sim = Simulation(cfg1)
    q_want = np.asarray(sim.run())

    # The multi-process run checkpointed steps 2 and 4; compare step 4.
    sim_probe = Simulation(cfg)  # just for state_file_name
    from wxfactory_tpu.parallel import load_state_distributed

    got4, _cfgtext = load_state_distributed(
        os.path.join(outdir_mp, os.path.basename(sim_probe.output.state_file_name(4))))
    scale = np.abs(q_want).max(axis=(1, 2, 3, 4), keepdims=True)
    assert np.abs((got4 - q_want) / scale).max() < 1e-13

    # Restart THROUGH the driver at step 2, multi-process again.
    cfg_r = str(tmp_path / "case6_restart.ini")
    with open(cfg_r, "w") as fh:
        fh.write(DRIVER_INI.format(outdir=outdir_mp, extra="starting_step = 2"))
    _launch_driver_workers(_free_port(), cfg_r)
    got4b, _ = load_state_distributed(
        os.path.join(outdir_mp, os.path.basename(sim_probe.output.state_file_name(4))))
    assert np.abs((got4b - q_want) / scale).max() < 1e-13
