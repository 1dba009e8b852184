"""Test configuration: run everything on a virtual 8-device CPU mesh.

Multi-chip sharding logic is validated on host devices
(xla_force_host_platform_device_count), mirroring how the reference tests
multi-rank behavior under mpirun (tests/unit/mpi_test.py there). The
platform is the CPU unless JAX_PLATFORMS names another; tests marked ``gpu``
skip unless JAX's first device is a GPU (``gpu_device`` fixture):

    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    # 24 = 6*2^2 panels x tiles: enough for the general (panel, y, x)
    # shard_map decomposition at N=2 (reference 6*N^2-rank analogue).
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=24").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
jax.config.update("jax_enable_x64", True)

import pytest


# ---------------------------------------------------------------------------
# Session-scoped construction caches: geometry + metric
# builds are the dominant fixed cost of many test modules and are pure
# functions of their arguments — cache them across modules. Tests treat the
# returned objects as read-only (topography cases build their own geometry
# and bypass the cache).

import functools


@functools.lru_cache(maxsize=None)
def cs3d_setup(nel_h, nel_v, s, ztop=10000.0, scale=125.0, rotating=False,
               deep=False):
    """(geom, ops, topo, metric) for a 3D cubed-sphere discretization."""
    from wxfactory_tpu.geometry.cubed_sphere_3d import make_cubed_sphere_3d
    from wxfactory_tpu.geometry.metric3d import make_metric_3d
    from wxfactory_tpu.ops.dfr import make_dfr_operators
    from wxfactory_tpu.parallel.topology import CubedSphereTopology

    geom = make_cubed_sphere_3d(
        nel_h, nel_v, s, ztop=ztop, planet_scaling_factor=scale,
        planet_is_rotating=rotating, deep=deep,
    )
    ops = make_dfr_operators(s, three_d=True)
    topo = CubedSphereTopology(geom)
    metric = make_metric_3d(geom, ops, topo)
    return geom, ops, topo, metric


@functools.lru_cache(maxsize=None)
def cs2d_setup(nel, s, lambda0=0.0, phi0=0.7853981633974483, alpha0=0.0):
    """(geom, ops, topo, metric) for a 2D cubed-sphere discretization."""
    from wxfactory_tpu.geometry.cubed_sphere import make_cubed_sphere_2d
    from wxfactory_tpu.geometry.metric import make_metric_2d
    from wxfactory_tpu.ops.dfr import make_dfr_operators
    from wxfactory_tpu.parallel.topology import CubedSphereTopology

    geom = make_cubed_sphere_2d(nel, s, lambda0, phi0, alpha0)
    ops = make_dfr_operators(s)
    metric = make_metric_2d(geom)
    topo = CubedSphereTopology(geom)
    return geom, ops, topo, metric


def pytest_addoption(parser):
    parser.addoption(
        "--runslow", action="store_true", default=False,
        help="run tests marked slow (multi-process launches)",
    )


def pytest_collection_modifyitems(config, items):
    """Keep the default suite fast: `slow`-marked tests (multi-process
    launches, long golden trajectories) run only with --runslow or
    WXF_RUN_SLOW=1."""
    if config.getoption("--runslow") or os.environ.get("WXF_RUN_SLOW") == "1":
        return
    skip = pytest.mark.skip(reason="slow test: use --runslow (or WXF_RUN_SLOW=1)")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)


@pytest.fixture
def gpu_device():
    """The first JAX device when it is a GPU; skips the test otherwise. The
    decision is made here, inside the test, never at import."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's first device is {dev.platform!r}")
    return dev
