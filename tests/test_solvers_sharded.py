"""The solver stack ON THE MESH: the production
exponential/implicit hot loops — EPI2 + device-resident KIOPS and Ros2 +
device-resident FGMRES — executed with the state sharded over a multi-device
mesh, asserted against the single-device trajectory, and with the collective
count per Krylov iteration read off the compiled (SPMD-partitioned) HLO and
held to the 1-sync/2-sync budget (the analogue of the reference's
2-allreduce-per-iter kiops.py:190-199 and 1-sync fgmres.py:41)."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from wxfactory_tpu.geometry import make_cubed_sphere_2d, make_metric_2d
from wxfactory_tpu.integrators import Epi, Ros2
from wxfactory_tpu.models import make_rhs_shallow_water
from wxfactory_tpu.ops.dfr import make_dfr_operators
from wxfactory_tpu.testcases import williamson_case6


def _sw(nel=8, s=2):
    geom = make_cubed_sphere_2d(nel, s)
    ops = make_dfr_operators(s)
    metric = make_metric_2d(geom)
    rhs = make_rhs_shallow_water(geom, ops, metric)
    q0 = jnp.asarray(williamson_case6(geom))
    return rhs, q0


def _mesh_sharding(ndev):
    mesh = Mesh(np.array(jax.devices()[:ndev]).reshape(ndev), ("ypart",))
    return NamedSharding(mesh, P(None, None, "ypart"))


def test_epi2_kiops_jit_sharded_matches_single():
    """EPI2 + kiops_jit with the y-element axis sharded over 8 devices must
    reproduce the single-device trajectory (same controller decisions,
    results to roundoff)."""
    if len(jax.devices()) < 8:
        pytest.skip("needs >= 8 virtual devices")
    rhs, q0 = _sw()
    dt = 60.0

    epi_1 = Epi(rhs, order=2, tolerance=1e-7, exponential_solver="kiops_jit", mmin=16, mmax=64)
    q_single = q0
    for _ in range(2):
        q_single = epi_1.step(q_single, dt)
    want = np.asarray(q_single)

    sharding = _mesh_sharding(8)
    epi_2 = Epi(rhs, order=2, tolerance=1e-7, exponential_solver="kiops_jit", mmin=16, mmax=64)
    q_sh = jax.device_put(q0, sharding)
    for _ in range(2):
        q_sh = epi_2.step(q_sh, dt)
    got = np.asarray(q_sh)

    scale = np.abs(want).max(axis=(1, 2, 3, 4), keepdims=True)
    assert np.abs((got - want) / scale).max() < 1e-10
    assert epi_2.solver_info.total_num_it == epi_1.solver_info.total_num_it


def test_ros2_fgmres_jit_sharded_matches_single():
    """Ros2 + fgmres_jit (one XLA program per implicit solve) on the same
    sharded state must match single-device."""
    if len(jax.devices()) < 8:
        pytest.skip("needs >= 8 virtual devices")
    rhs, q0 = _sw()
    dt = 120.0

    ros_1 = Ros2(rhs, tolerance=1e-8, gmres_restart=30, linear_solver="fgmres_jit")
    want = np.asarray(ros_1.step(ros_1.step(q0, dt), dt))

    sharding = _mesh_sharding(8)
    ros_2 = Ros2(rhs, tolerance=1e-8, gmres_restart=30, linear_solver="fgmres_jit")
    q_sh = jax.device_put(q0, sharding)
    got = np.asarray(ros_2.step(ros_2.step(q_sh, dt), dt))

    scale = np.abs(want).max(axis=(1, 2, 3, 4), keepdims=True)
    assert np.abs((got - want) / scale).max() < 1e-10
    assert ros_2.solver_info.total_num_it == ros_1.solver_info.total_num_it


# ----------------------------------------------------------------------
# Collective budget per Krylov iteration, from the compiled SPMD HLO.
# The while-loop body is traced ONCE, so the static all-reduce count in the
# module's while-body computations IS the per-iteration collective count.
# ----------------------------------------------------------------------

def _allreduce_count(compiled_text: str) -> int:
    """Number of DEFINED all-reduce instructions in the optimized module
    (operand-name references excluded). Loop bodies are traced once, so
    this is a static per-iteration count plus the outside-the-loop ones."""
    return len([l for l in compiled_text.splitlines()
                if re.search(r"= \S+ all-reduce(?:-start)?\(", l)])


def _kiops_program_allreduces(one_sync: bool, full_ortho: bool = False) -> int:
    from wxfactory_tpu.solvers.kiops_jit import kiops_jit

    rhs, q0 = _sw(nel=8, s=2)
    sharding = _mesh_sharding(8)
    q = jax.device_put(q0, sharding)

    def prog(q, vec):
        def Aop(v):
            return jax.jvp(rhs, (q,), (v,))[1]

        w, st = kiops_jit(Aop, vec, tol=1e-7, mmin=16, mmax=32,
                          one_sync=one_sync, full_ortho=full_ortho)
        return w

    vec = jnp.stack([jnp.zeros_like(q0), jnp.asarray(rhs(q0))])
    compiled = jax.jit(prog).lower(q, jax.device_put(vec, NamedSharding(
        sharding.mesh, P(None, None, None, "ypart")))).compile()
    return _allreduce_count(compiled.as_text())


def _fgmres_program_allreduces(one_sync: bool) -> int:
    from wxfactory_tpu.solvers.fgmres_jit import fgmres_jit

    rhs, q0 = _sw(nel=8, s=2)
    sharding = _mesh_sharding(8)
    q = jax.device_put(q0, sharding)

    def prog(q, b):
        def Aop(v):
            jv = jax.jvp(rhs, (q,), (v,))[1]
            return v - 30.0 * jv

        x, info = fgmres_jit(Aop, b, tol=1e-7, restart=10, max_outer=3,
                             one_sync=one_sync)
        return x

    b = jax.device_put(jnp.asarray(rhs(q0)), sharding)
    compiled = jax.jit(prog).lower(q, b).compile()
    return _allreduce_count(compiled.as_text())


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs >= 8 virtual devices")
def test_kiops_jit_collective_budget():
    """IOP KIOPS: 2 fused reductions per Arnoldi iteration (Gram + norm,
    like the reference's kiops.py:190-199); one_sync=True drops the loop to
    ONE (kiops_nest structure). The compiled module also carries a bounded
    number of outside-the-loop reductions (restart beta, controller)."""
    two = _kiops_program_allreduces(one_sync=False)
    one = _kiops_program_allreduces(one_sync=True)
    assert one < two, (one, two)
    # Loop body: 2 vs 1; module overhead (restart beta + input scaling
    # norm): 2. Measured: 4 vs 3 on the 8-device CPU mesh.
    assert two <= 2 + 2, two
    assert one <= 1 + 2, one


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs >= 8 virtual devices")
def test_fgmres_jit_collective_budget():
    """FGMRES: classical GS costs 2 collectives/iter; one_sync=True fuses
    the norm into the batched product (the reference fgmres.py:41 1-sync
    scheme) -> 1/iter."""
    two = _fgmres_program_allreduces(one_sync=False)
    one = _fgmres_program_allreduces(one_sync=True)
    assert one < two, (one, two)
    # Loop body: 2 vs 1; module overhead (norm_b, initial + outer residual
    # norms): 3.
    assert two <= 2 + 3, two
    assert one <= 1 + 3, one
