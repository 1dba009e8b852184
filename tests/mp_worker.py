"""Worker for the multi-controller (multi-host) tests.

Launched N times by tests/test_multiprocess.py (subprocess per controller,
CPU backend with 4 virtual devices each — the JAX analogue of the
reference's `mpirun -n` test harness, tests/unit/mpi_test.py there). Each
worker joins the jax.distributed world, runs a sharded EPI2+kiops_jit
trajectory over a mesh spanning BOTH processes' devices, and exercises the
distributed checkpoint/restart path (parallel/distributed.py).

Usage: python tests/mp_worker.py <port> <num_procs> <process_id> <outdir>
"""

import os
import sys

os.environ.pop("XLA_FLAGS", None)

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 4)
jax.config.update("jax_enable_x64", True)


def main():
    port, nproc, pid, outdir = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from wxfactory_tpu.parallel import (
        gather_global,
        init_distributed,
        is_primary,
        load_state_distributed,
        save_state_distributed,
    )

    init_distributed(f"localhost:{port}", nproc, pid)
    assert jax.process_count() == nproc, jax.process_count()
    ndev = len(jax.devices())

    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from wxfactory_tpu.geometry import make_cubed_sphere_2d, make_metric_2d
    from wxfactory_tpu.integrators import Epi
    from wxfactory_tpu.models import make_rhs_shallow_water
    from wxfactory_tpu.ops.dfr import make_dfr_operators
    from wxfactory_tpu.testcases import williamson_case6

    nel, s, dt = 8, 2, 60.0
    geom = make_cubed_sphere_2d(nel, s)
    ops = make_dfr_operators(s)
    metric = make_metric_2d(geom)
    rhs = make_rhs_shallow_water(geom, ops, metric)
    q0 = jnp.asarray(williamson_case6(geom))

    # Shard the y-element axis of (nvar, 6, ny, nx, s^2) over every device
    # of every process — the 2D domain decomposition spanning hosts.
    mesh = Mesh(np.array(jax.devices()).reshape(ndev), ("y",))
    sharding = NamedSharding(mesh, P(None, None, "y"))
    q = jax.device_put(q0, sharding)

    epi = Epi(rhs, order=2, tolerance=1e-7, exponential_solver="kiops_jit",
              mmin=16, mmax=64)
    for _ in range(2):
        q = epi.step(q, dt)
    result = gather_global(q)
    if is_primary():
        np.save(os.path.join(outdir, "result.npy"), result)

    # --- distributed checkpoint round trips --------------------------------
    class _Cfg:
        raw_text = "[test]\nfrom = mp_worker\n"

    # (a) small-state path: gather + reference-format single file.
    p_small = os.path.join(outdir, "ckpt_small.npy")
    save_state_distributed(q, _Cfg(), p_small, panel_major=True)
    state_a, _ = load_state_distributed(p_small, panel_major=True)
    assert np.array_equal(state_a, result), "single-file checkpoint round trip"

    # (b) large-state path: per-shard npy + JSON manifest (forced).
    p_big = os.path.join(outdir, "ckpt_sharded.npy")
    save_state_distributed(q, _Cfg(), p_big, panel_major=True, small_bytes=0)
    state_b, cfg_text = load_state_distributed(p_big)
    assert np.array_equal(state_b, result), "sharded checkpoint round trip"
    assert cfg_text and "mp_worker" in cfg_text

    # --- restart: continue the trajectory from the checkpoint --------------
    q_re = jax.device_put(jnp.asarray(state_b), sharding)
    epi2 = Epi(rhs, order=2, tolerance=1e-7, exponential_solver="kiops_jit",
               mmin=16, mmax=64)
    q_re = epi2.step(q_re, dt)
    # gather_global is COLLECTIVE: every process must call it (putting it
    # inside the is_primary() branch deadlocks the primary — the exact
    # failure mode the rank-0 gating design must avoid).
    restart_result = gather_global(q_re)
    if is_primary():
        np.save(os.path.join(outdir, "result_restart.npy"), restart_result)

    jax.distributed.shutdown()
    print(f"worker {pid}: OK", flush=True)


if __name__ == "__main__":
    main()
