"""Stiff-PDE lab tests: operator parity with the reference + end-to-end
exponential integration (the low-sync benchmark capability)."""

import os
import sys

import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

from ref_harness import run_lockstep  # noqa: E402

from wxfactory_tpu.integrators import Epi  # noqa: E402
from wxfactory_tpu.stiff_pdes import (  # noqa: E402
    initial_condition,
    make_adr,
    make_allen_cahn,
    make_burgers,
    make_porous_medium,
)


def test_operators_match_reference():
    """Allen-Cahn + ADR RHS match the reference's hand-rolled FD loops
    exactly. (The reference's periodic/Dirichlet advection single-process
    paths are broken — UnboundLocalError — so only these two can be
    compared.)"""
    from ref_harness import REFERENCE_PATH, require_reference  # noqa: PLC0415

    require_reference()
    sys.path.insert(0, REFERENCE_PATH)

    def single(rank):
        from mpi4py import MPI

        from stiff_pdes import initWorld, rhs_jac_pdefuncs

        world = initWorld.InitWorld(MPI.COMM_WORLD, "Neumann", [-1.0, 1.0], 34)
        rng = np.random.default_rng(0)
        u = rng.uniform(0.1, 0.9, world.oneDsize)
        return {
            "ac": rhs_jac_pdefuncs.allencahn_rhs(u, 0.1, world),
            "adr": rhs_jac_pdefuncs.adr_rhs(u, 0.01, -10.0, 100.0, world),
            "meta": (world.numPointsX, world.dx),
            "u": u,
        }

    res = run_lockstep(1, single)[0]
    n, dx = res["meta"]
    npts = round(2.0 / dx) + 1
    uu = res["u"].reshape(n, n)
    for name, rhs in (
        ("ac", make_allen_cahn(num_points=npts, eps=0.1)),
        ("adr", make_adr(num_points=npts, eps=0.01, alpha=-10.0, gamma=100.0)),
    ):
        mine = np.asarray(rhs(jnp.asarray(uu))).ravel()
        assert np.abs(mine - res[name]).max() / np.abs(res[name]).max() < 1e-13


def test_all_problems_integrate():
    for maker in (make_allen_cahn, make_adr, make_burgers, make_porous_medium):
        rhs = maker(num_points=42)
        q = jnp.asarray(initial_condition(42))
        stepper = Epi(rhs, 2, exponential_solver="icwy_ne", tolerance=1e-8)
        for _ in range(3):
            q = stepper.step(q, 1e-3)
        assert bool(jnp.all(jnp.isfinite(q)))


def test_benchmark_runner():
    from wxfactory_tpu.stiff_pdes.benchmark import run

    elapsed = run("ac", "epi3", "kiops", grid=42, dt=1e-3, t_end=3e-3, verbose=False)
    assert elapsed > 0
