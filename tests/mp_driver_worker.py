"""Worker for the PRODUCTION-DRIVER multi-controller test: each process
runs the real CLI entry point —
``python -m wxfactory_tpu config.ini --coordinator ... --num-processes N
--process-id I`` — so rank-gated output, blockstats-under-sharding and the
distributed checkpoint/restart all flow through `Simulation`/`OutputManager`
rather than a hand-built loop (the analogue of the reference's
tests/unit/run_mpi_tests.py driving its real object stack under mpirun).

Usage: python tests/mp_driver_worker.py <port> <num_procs> <process_id>
       <config_path>
"""

import os
import sys

os.environ.pop("XLA_FLAGS", None)

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 12)
jax.config.update("jax_enable_x64", True)


def main():
    port, nproc, pid, config_path = (
        sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    )
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from wxfactory_tpu.__main__ import main as cli_main

    rc = cli_main([
        config_path,
        "--coordinator", f"localhost:{port}",
        "--num-processes", str(nproc),
        "--process-id", str(pid),
        "--show-every-crash",
    ])
    assert jax.process_count() == nproc, jax.process_count()
    sys.exit(rc)


if __name__ == "__main__":
    main()
