"""Command-line entry point: ``python -m wxfactory_tpu config.ini``.

Capability parity with the reference's ./WxFactory executable: run a
simulation from an INI file, dump the option reference with
--config-options, optional cProfile.
"""

import argparse
import cProfile
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="wxfactory_tpu", description="JAX NWP dynamical core (WxFactory capabilities)"
    )
    parser.add_argument("config", nargs="?", help="Path to the simulation configuration (INI)")
    parser.add_argument("--profile", action="store_true", help="Profile the run with cProfile")
    parser.add_argument(
        "--config-options", action="store_true", help="Print every available configuration option and exit"
    )
    parser.add_argument("--show-every-crash", action="store_true", help="Print full tracebacks")
    parser.add_argument(
        "--jax-trace", metavar="DIR", default=None,
        help="Capture a jax.profiler trace of the run into DIR (TensorBoard/"
             "Perfetto-viewable; the analogue of the reference's NSight "
             "hookup, scripts/wx.sh:23 there)",
    )
    # Multi-controller (multi-host) execution — the analogue of the
    # reference's `mpirun -n N ./WxFactory` (one process per host here, the
    # mesh spans every host's devices; reference process_topology.py:50).
    parser.add_argument(
        "--coordinator", metavar="HOST:PORT", default=None,
        help="jax.distributed coordinator address (multi-host runs; launch the "
             "same command on every host with its own --process-id)",
    )
    parser.add_argument("--num-processes", type=int, default=None,
                        help="Total number of controller processes")
    parser.add_argument("--process-id", type=int, default=None,
                        help="This process's index in [0, num-processes)")
    args = parser.parse_args(argv)

    if args.num_processes is not None and args.num_processes > 1:
        from .parallel import init_distributed

        init_distributed(args.coordinator, args.num_processes, args.process_id)

    if args.config_options:
        from .config import schema_documentation

        print(schema_documentation())
        return 0

    if not args.config:
        parser.error("a configuration file is required (or use --config-options)")

    from .runtime import enable_compilation_cache
    from .simulation import Simulation

    enable_compilation_cache()

    def run():
        sim = Simulation(args.config)
        sim.run()

    try:
        if args.jax_trace:
            import jax

            with jax.profiler.trace(args.jax_trace):
                run()
            print(f"jax.profiler trace written to {args.jax_trace}")
        elif args.profile:
            cProfile.runctx("run()", globals(), locals(), filename="prof.out")
            print("Profile written to prof.out")
        else:
            run()
    except Exception:
        # Crash traceback from the primary process only, unless overridden
        # (reference WxFactory:114-143 + --show-every-crash).
        from .parallel import is_primary

        if args.show_every_crash or is_primary():
            import traceback

            traceback.print_exc()
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
