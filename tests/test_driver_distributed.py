"""Mesh-sharded execution through the PRODUCTION driver: `Simulation`
built from a config must shard the state over the visible devices and
reproduce the single-device trajectory.

The reference's production invocation is inherently distributed
(`mpirun -n 6N^2 ./WxFactory config.ini`, WxFactory:102-105 there,
one rank per tile, process_topology.py:69-94 there); here the same config
file on a 24-device platform turns into a (6, 2, 2) mesh automatically.

Trajectory equality criterion: partitioned execution necessarily
re-associates floating-point reductions (halo gathers, Krylov dots), so
bit-for-bit equality is not the correct invariant — the tests hold the
trajectories to 1e-14 relative (measured: 5e-16..8e-16, i.e. 1-2 ulps) and
the Krylov paths additionally to identical iteration counts."""

import os

import jax
import numpy as np
import pytest

from wxfactory_tpu.config import Configuration
from wxfactory_tpu.simulation import Simulation

INI = """
[General]
equations = shallow_water
[Grid]
grid_type = cubed_sphere
phi0 = pi/4
[Test_case]
case_number = 6
[Time_integration]
dt = {dt}
t_end = {t_end}
time_integrator = {integ}
exponential_solver = kiops_jit
tolerance = 1e-7
[Spatial_discretization]
num_solpts = 3
num_elements_horizontal = 4
[Output_options]
output_dir = {outdir}
[System]
distribute = {dist}
"""

E3_INI = """
[General]
equations = euler
[Grid]
grid_type = cubed_sphere
ztop = 10000
[Test_case]
case_number = 31
[Time_integration]
dt = 1.0
t_end = 2.0
time_integrator = {integ}
exponential_solver = kiops_jit
tolerance = 1e-7
[Spatial_discretization]
num_solpts = 2
num_elements_horizontal = 4
num_elements_vertical = 3
[Output_options]
output_dir = {outdir}
[System]
distribute = {dist}
"""


def _run(ini):
    sim = Simulation(Configuration(ini))
    return sim, np.asarray(sim.run())


needs_mesh = pytest.mark.skipif(len(jax.devices()) < 24, reason="needs 24 virtual devices")


@needs_mesh
def test_tvdrk3_driver_tile_step_matches_single(tmp_path):
    """Explicit SW run: auto mode must select the hand-scheduled shard_map
    tile step (ShardMapTvdrk3 over the (6,2,2) mesh) and reproduce the
    single-device trajectory."""
    kw = dict(dt=60, t_end=180, integ="tvdrk3")
    _, q_off = _run(INI.format(dist="off", outdir=str(tmp_path / "off"), **kw))
    sim, q_auto = _run(INI.format(dist="auto", outdir=str(tmp_path / "auto"), **kw))

    assert sim.mesh is not None and dict(sim.mesh.shape) == {"panel": 6, "y": 2, "x": 2}
    assert type(sim.integrator).__name__ == "ShardMapTvdrk3"
    assert sim.initial_q.sharding.spec == sim.sharding.spec
    scale = np.abs(q_off).max(axis=(1, 2, 3, 4), keepdims=True)
    assert np.abs((q_auto - q_off) / scale).max() < 1e-14


@needs_mesh
def test_epi2_driver_gspmd_matches_single(tmp_path):
    """Exponential SW run: the state is sharded and the device-resident
    KIOPS hot loop partitions over the mesh via GSPMD, with identical
    controller decisions."""
    kw = dict(dt=1800, t_end=5400, integ="epi2")
    sim_off, q_off = _run(INI.format(dist="off", outdir=str(tmp_path / "off"), **kw))
    sim, q_auto = _run(INI.format(dist="auto", outdir=str(tmp_path / "auto"), **kw))

    assert sim.mesh is not None
    assert sim._shard_maker is None  # Krylov runs partition via GSPMD, not tile step
    scale = np.abs(q_off).max(axis=(1, 2, 3, 4), keepdims=True)
    assert np.abs((q_auto - q_off) / scale).max() < 1e-14
    assert sim.integrator.solver_info.total_num_it == sim_off.integrator.solver_info.total_num_it


@needs_mesh
def test_euler3d_driver_sharded_matches_single(tmp_path):
    """3D Euler (dcmip31) through the driver: vertical stays device-local,
    the horizontal element grid shards over the mesh."""
    _, q_off = _run(E3_INI.format(dist="off", outdir=str(tmp_path / "off"), integ="tvdrk3"))
    sim, q_auto = _run(E3_INI.format(dist="auto", outdir=str(tmp_path / "auto"), integ="tvdrk3"))

    assert sim.mesh is not None
    assert type(sim.integrator).__name__ == "ShardMapTvdrk3"
    scale = np.abs(q_off).max(axis=(1, 2, 3, 4, 5), keepdims=True)
    # The tile step derives panel-edge traces via the halo-rotation tables
    # (a different but equivalent association order than the global gather);
    # measured 2e-13 on this 3D metric.
    assert np.abs((q_auto - q_off) / scale).max() < 1e-11


@needs_mesh
def test_distribute_off_and_forced_modes(tmp_path):
    """'off' keeps the state unsharded; 'gspmd' forces sharding without the
    tile step even for explicit runs; 'shard_map' on an incompatible run
    raises."""
    kw = dict(dt=60, t_end=60, integ="tvdrk3")
    sim_off = Simulation(Configuration(INI.format(dist="off", outdir=str(tmp_path / "o"), **kw)))
    assert sim_off.mesh is None and sim_off.sharding is None

    sim_g = Simulation(Configuration(INI.format(dist="gspmd", outdir=str(tmp_path / "g"), **kw)))
    assert sim_g.mesh is not None and sim_g._shard_maker is None
    assert type(sim_g.integrator).__name__ == "Tvdrk3"

    with pytest.raises(ValueError, match="shard_map"):
        Simulation(Configuration(INI.format(dist="shard_map", outdir=str(tmp_path / "s"),
                                            dt=1800, t_end=1800, integ="epi2")))


@needs_mesh
def test_restart_from_sharded_checkpoint(tmp_path):
    """A sharded run's checkpoint restarts a second sharded run through the
    driver, matching the uninterrupted trajectory (reference
    restart-at-any-PE-count analogue)."""
    outdir = str(tmp_path / "run")
    base = INI.format(dist="auto", outdir=outdir, dt=60, t_end=240, integ="tvdrk3").replace(
        "[Output_options]", "[Output_options]\nsave_state_freq = 2")
    _, q_full = _run(base)

    resumed = base.replace("starting_step = 0", "").replace(
        "tolerance = 1e-7", "tolerance = 1e-7\nstarting_step = 2")
    sim2, q_res = _run(resumed)
    assert sim2.starting_step == 2
    scale = np.abs(q_full).max(axis=(1, 2, 3, 4), keepdims=True)
    assert np.abs((q_res - q_full) / scale).max() < 1e-13
