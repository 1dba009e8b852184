"""Runtime plumbing: the compile-cache helper, the platform choice of
``System.desired_device``, device placement and the mesh notice of
``Simulation``, and the entry points that must refuse to run without their
devices (chip_smoke.py, bench.py, __graft_entry__.dryrun_multichip)."""

import os
import shutil
import subprocess
import sys
import tempfile

import jax
import pytest

from wxfactory_tpu.config import Configuration, ConfigurationError
from wxfactory_tpu.runtime import enable_compilation_cache, platform_devices
from wxfactory_tpu.simulation import Simulation

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SW_INI = """
[General]
equations = shallow_water
[System]
desired_device = {device}
distribute = {distribute}
[Grid]
grid_type = cubed_sphere
[Test_case]
case_number = 6
[Time_integration]
dt = 1800
t_end = 1800
time_integrator = tvdrk3
[Spatial_discretization]
num_solpts = 2
num_elements_horizontal = {nel}
[Output_options]
output_dir = {outdir}
"""


def _cache_dir_config():
    return jax.config.jax_compilation_cache_dir


def test_cache_helper_follows_env(monkeypatch, tmp_path):
    before = _cache_dir_config()
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert enable_compilation_cache() == str(tmp_path)
    assert _cache_dir_config() == before  # JAX reads the variable itself


def test_cache_helper_defaults_to_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = _cache_dir_config()
    try:
        path = enable_compilation_cache()
        assert _cache_dir_config() == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    assert path == os.path.join(REPO, ".jax_cache")


def test_cache_helper_path_is_stable(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = _cache_dir_config()
    try:
        paths = {enable_compilation_cache() for _ in range(2)}
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    (path,) = paths
    assert not path.startswith(tempfile.gettempdir())
    assert str(os.getpid()) not in path


def test_desired_device_cpu_and_unknown():
    assert all(d.platform == "cpu" for d in platform_devices("cpu"))
    with pytest.raises(ValueError):
        platform_devices("opencl")


def test_desired_device_raises_when_platform_absent():
    if any(d.platform == "gpu" for d in jax.devices()):
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="desired_device='cuda'"):
        platform_devices("cuda")


def test_desired_device_unset_uses_default_platform(tmp_path):
    ini = SW_INI.format(device="", distribute="off", nel=2, outdir=tmp_path)
    cfg = Configuration(ini.replace("desired_device = \n", ""))
    assert cfg.desired_device is None
    assert platform_devices(None) == jax.devices()
    sim = Simulation(cfg)
    assert sim.device == jax.devices()[0]
    assert sim.initial_q.devices() == {jax.devices()[0]}


def test_simulation_refuses_absent_platform(tmp_path):
    if any(d.platform == "gpu" for d in jax.devices()):
        pytest.skip("a GPU is present")
    cfg = Configuration(SW_INI.format(device="cuda", distribute="off", nel=2, outdir=tmp_path))
    with pytest.raises(RuntimeError, match="not available"):
        Simulation(cfg)


def test_config_rejects_unknown_device(tmp_path):
    with pytest.raises(ConfigurationError):
        Configuration(SW_INI.format(device="opencl", distribute="off", nel=2, outdir=tmp_path))


def test_simulation_places_state_on_chosen_device(tmp_path):
    sim = Simulation(Configuration(SW_INI.format(device="cpu", distribute="off", nel=2, outdir=tmp_path)))
    assert sim.initial_q.devices() == {jax.devices("cpu")[0]}
    assert sim.device == jax.devices("cpu")[0]


def test_simulation_says_when_it_declines_the_mesh(tmp_path, capsys):
    if len(jax.devices()) < 4:
        pytest.skip("needs several virtual devices")
    # nel=3 divides over no mesh axis of size 2.
    sim = Simulation(Configuration(SW_INI.format(device="cpu", distribute="auto", nel=3, outdir=tmp_path)))
    out = capsys.readouterr().out
    assert sim.mesh is None
    lines = [line for line in out.splitlines() if "does not divide" in line]
    assert len(lines) == 1 and "(3, 6, 3, 3, 4)" in lines[0], out


def _run(args, cwd, timeout=240):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable] + args, cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=timeout)


def test_chip_smoke_refuses_cpu():
    r = _run(["chip_smoke.py"], REPO)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "needs a GPU" in r.stderr


def test_chip_smoke_fails_without_the_package(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run(["chip_smoke.py"], tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_bench_refuses_cpu():
    r = _run(["bench.py"], REPO)
    assert r.returncode != 0
    assert "measures the GPU" in r.stderr


def test_dryrun_multichip_fails_without_devices():
    sys.path.insert(0, REPO)
    import __graft_entry__

    with pytest.raises(RuntimeError, match="needs"):
        __graft_entry__.dryrun_multichip(len(jax.devices()) + 1)


def test_canonical_epi2_step_is_well_conditioned_at_smoke_dt(tmp_path):
    """chip_smoke.py compares one canonical EPI2 step on the GPU and the CPU
    to 1e-7 at CANONICAL_DT. That comparison means something only if the
    step itself moves by much less when its input moves by one ulp."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import backend_witness

    sys.path.insert(0, REPO)
    import chip_smoke as cs

    change, reports = backend_witness.epi2_sensitivity(
        cs.CANONICAL_DT, cs.CANONICAL_SHAPE, outdir=str(tmp_path))
    assert all(r["converged"] for r in reports), reports
    assert change.max() < 1e-7, change


@pytest.fixture
def chip_smoke(monkeypatch, tmp_path):
    sys.path.insert(0, REPO)
    import chip_smoke as cs

    monkeypatch.setattr(cs, "OUT", str(tmp_path))
    return cs


@pytest.mark.parametrize("which", ["e3_epi2", "e3_ros2", "canonical", "four_mesh", "four_single", "sw"])
def test_chip_smoke_ini_files_load(chip_smoke, which):
    from wxfactory_tpu.config import load_configuration

    cs = chip_smoke
    paths = {
        "e3_epi2": lambda: cs.e3_ini("e3_epi2", "cuda", cs.E3_SHAPE, cs.E3_DT, "epi2"),
        "e3_ros2": lambda: cs.e3_ini("e3_ros2", "cuda", cs.E3_SHAPE, cs.E3_DT, "ros2"),
        "canonical": lambda: cs.e3_ini("canonical_cpu", "cpu", cs.CANONICAL_SHAPE, cs.CANONICAL_DT, "epi2"),
        "four_mesh": lambda: cs.e3_ini("four_mesh", "cuda", cs.FOUR_CARD_SHAPE, cs.E3_DT, "epi2"),
        "four_single": lambda: cs.e3_ini("four_single", "cuda", cs.FOUR_CARD_SHAPE, cs.E3_DT, "epi2",
                                         distribute="off"),
        "sw": lambda: cs.sw_ini("sw_case6", "cuda", cs.SW_SHAPE, cs.SW_DT),
    }
    path = paths[which]()
    assert path.startswith(cs.OUT)
    c = load_configuration(path)
    assert c.tolerance == 1e-7
    assert c.t_end == pytest.approx(cs.NSTEPS * c.dt)
    assert c.output_dir.startswith(cs.OUT)
    if which == "sw":
        assert (c.equations, c.case_number, c.time_integrator) == ("shallow_water", 6, "epi3")
        assert (c.num_elements_horizontal, c.num_solpts, c.save_state_freq) == (64, 3, 2)
    else:
        assert (c.equations, c.case_number, c.gmres_restart) == ("euler", 31, 200)
        shape = (c.num_elements_horizontal, c.num_elements_vertical, c.num_solpts)
        assert shape == {"canonical": (12, 3, 2), "four_mesh": (16, 15, 4),
                         "four_single": (16, 15, 4)}.get(which, (15, 15, 4))
    assert c.desired_device == ("cpu" if which == "canonical" else "cuda")
