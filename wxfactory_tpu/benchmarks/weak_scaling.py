"""Weak-scaling benchmark: grid-points/s at constant per-device load.

The BASELINE.md north star: weak-scaling efficiency of the cubed-sphere
step from 1 device to a full mesh (target >= 80%). Four measurable paths:

  * ``gspmd``   — the plain global RHS + TVD-RK3 under GSPMD sharding
                  (any device count; the fallback distributed path).
  * ``tile-sw`` — the hand-scheduled distributed step: one cubed-sphere tile
                  per device inside shard_map with edge-colored ppermute
                  halo rounds (parallel/shard_map_sw.py); needs a 6*N^2 mesh.
  * ``tile-e3`` — same for 3D Euler (parallel/shard_map_euler3d.py).
  * ``epi2``    — the sharded exponential hot loop: EPI2 + device-resident
                  KIOPS on the GSPMD-sharded state (the state-shaped
                  Krylov basis keeps every dot one fused all-reduce,
                  solvers/kiops_jit.py).

On a CPU host this exercises the virtual-device partitioning path
(JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=N — the
numbers measure partitioning/collective overhead, not fabric bandwidth). On
several GPUs the same code measures the real interconnect.

Usage:
    python -m wxfactory_tpu.benchmarks.weak_scaling --path tile-sw --steps 3
"""

import argparse
import math
import time

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def mesh_shape(n: int):
    p = math.gcd(n, 6)
    rest = n // p
    y = int(math.sqrt(rest))
    while rest % y:
        y -= 1
    return p, y, rest // y


def _sw_parts(nel, num_solpts, dtype):
    from ..geometry import make_cubed_sphere_2d, make_metric_2d
    from ..models import make_rhs_shallow_water
    from ..ops.dfr import make_dfr_operators
    from ..testcases import williamson_case6

    geom = make_cubed_sphere_2d(nel, num_solpts)
    ops = make_dfr_operators(num_solpts)
    metric = make_metric_2d(geom)
    q = jnp.asarray(williamson_case6(geom))
    return geom, ops, metric, q


def run_gspmd(devices, base_nel, num_solpts, nsteps, dtype):
    from ..models import make_rhs_shallow_water
    from ..ops.dfr import make_dfr_operators

    n = len(devices)
    p, y, x = mesh_shape(n)
    nel = base_nel * max(y, x)
    geom, ops, metric, q = _sw_parts(nel, num_solpts, dtype)
    from ..models import make_rhs_shallow_water as mk

    rhs = mk(geom, ops, metric, dtype=dtype)
    q = q.astype(dtype)
    dt = jnp.asarray(30.0, dtype)

    mesh = Mesh(np.array(devices).reshape(p, y, x), axis_names=("panel", "y", "x"))
    sharding = NamedSharding(mesh, P(None, "panel", "y", "x", None))
    q = jax.device_put(q, sharding)

    @jax.jit
    def multi_step(q):
        def body(q, _):
            q1 = q + rhs(q) * dt
            q2 = 0.75 * q + 0.25 * (q1 + rhs(q1) * dt)
            return q / 3.0 + 2.0 / 3.0 * (q2 + rhs(q2) * dt), None

        return jax.lax.scan(body, q, None, length=nsteps)[0]

    elapsed = _time2(multi_step, q)
    pts = 6 * nel * nel * num_solpts**2
    coll = collective_counts(lambda qq: multi_step(qq), q)
    return pts * nsteps * 3 / elapsed, pts, nsteps, coll


def _tile_mesh(devices):
    n = len(devices)
    N = int(round(math.sqrt(n / 6)))
    if 6 * N * N != n:
        raise ValueError(f"the tile path needs 6*N^2 devices, got {n}")
    return N, Mesh(np.array(devices).reshape(6, N, N), axis_names=("panel", "y", "x"))


def run_tile_sw(devices, base_nel, num_solpts, nsteps, dtype):
    """Hand-scheduled distributed step: one tile per device in shard_map.
    len(devices) must be 6*N^2; per-tile load constant (base_nel elems)."""
    from ..parallel.shard_map_sw import make_shard_map_sw_step_general

    N, mesh = _tile_mesh(devices)
    nel = base_nel * N
    geom, ops, metric, q = _sw_parts(nel, num_solpts, dtype)
    step, sharding = make_shard_map_sw_step_general(geom, ops, metric, mesh, 30.0, dtype=dtype)
    q = jax.device_put(q.astype(dtype), sharding)

    def multi(qq):
        for _ in range(nsteps):
            qq = step(qq)
        return qq

    elapsed = _time2(multi, q)
    pts = 6 * nel * nel * num_solpts**2
    coll = collective_counts(step, q)
    return pts * nsteps * 3 / elapsed, pts, nsteps, coll


def run_tile_e3(devices, base_nel, num_solpts, nsteps, dtype):
    from ..geometry import make_cubed_sphere_3d, make_metric_3d
    from ..ops.dfr import make_dfr_operators
    from ..parallel.shard_map_euler3d import make_shard_map_euler3d_step
    from ..testcases.dcmip import dcmip_gravity_wave

    N, mesh = _tile_mesh(devices)
    nel = base_nel * N
    nel_v = 3
    geom = make_cubed_sphere_3d(nel, nel_v, num_solpts, 10000.0,
                                planet_scaling_factor=125.0, planet_is_rotating=False)
    ops = make_dfr_operators(num_solpts, three_d=True)
    metric = make_metric_3d(geom, ops)
    q = jnp.asarray(dcmip_gravity_wave(geom))
    step, sharding = make_shard_map_euler3d_step(geom, ops, metric, mesh, 1.0, dtype=dtype)
    q = jax.device_put(q.astype(dtype), sharding)

    def multi(qq):
        for _ in range(nsteps):
            qq = step(qq)
        return qq

    elapsed = _time2(multi, q)
    pts = 6 * nel * nel * nel_v * num_solpts**3
    coll = collective_counts(step, q)
    return pts * nsteps * 3 / elapsed, pts, nsteps, coll


def run_epi2(devices, base_nel, num_solpts, nsteps, dtype):
    """Sharded exponential hot loop: EPI2 + kiops_jit on the GSPMD state."""
    from ..integrators import Epi

    n = len(devices)
    p, y, x = mesh_shape(n)
    nel = base_nel * max(y, x)
    geom, ops, metric, q = _sw_parts(nel, num_solpts, jnp.float64)
    from ..models import make_rhs_shallow_water as mk

    rhs = mk(geom, ops, metric)
    mesh = Mesh(np.array(devices).reshape(p, y, x), axis_names=("panel", "y", "x"))
    sharding = NamedSharding(mesh, P(None, "panel", "y", "x", None))
    q = jax.device_put(q, sharding)
    epi = Epi(rhs, order=2, tolerance=1e-7, exponential_solver="kiops_jit",
              mmin=16, mmax=64)
    q1 = epi.step(q, 60.0)  # compile
    jax.block_until_ready(q1)
    t0 = time.perf_counter()
    for _ in range(nsteps):
        q1 = epi.step(q1, 60.0)
    jax.block_until_ready(q1)
    elapsed = time.perf_counter() - t0
    pts = 6 * nel * nel * num_solpts**2
    # Per-iteration collective budgets for this hot loop are asserted from
    # compiled HLO in tests/test_solvers_sharded.py; no static per-step
    # count is well-defined here (adaptive substeps).
    return pts * nsteps / elapsed, pts, nsteps, None


def _time2(fn, q):
    out = fn(q)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    out = fn(q)
    jax.block_until_ready(out)
    return time.perf_counter() - t0


def collective_counts(fn, q) -> dict:
    """Static collective-op counts from the compiled (SPMD-partitioned)
    HLO of one step program — the honest mechanics number on a virtual
    mesh (wall time there measures host oversubscription, not scaling)."""
    import re

    text = jax.jit(fn).lower(q).compile().as_text()
    counts = {}
    for op in ("collective-permute", "all-reduce", "all-gather",
               "all-to-all", "reduce-scatter"):
        hits = len(re.findall(rf"= \S+ {op}(?:-start)?\(", text))
        if hits:
            counts[op] = hits
    return counts


PATHS = {"gspmd": run_gspmd, "tile-sw": run_tile_sw, "tile-e3": run_tile_e3,
         "epi2": run_epi2}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--base-nel", type=int, default=4,
                        help="elements per device axis (per tile for the tile paths)")
    parser.add_argument("--num-solpts", type=int, default=2)
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--dtype", default="f64", choices=["f32", "f64"])
    parser.add_argument("--path", default="gspmd", choices=sorted(PATHS))
    parser.add_argument("--device-counts", type=int, nargs="*", default=None)
    args = parser.parse_args(argv)

    dtype = jnp.float32 if args.dtype == "f32" else jnp.float64
    all_devices = jax.devices()
    nd = len(all_devices)
    if args.device_counts:
        counts = [c for c in args.device_counts if c <= nd]
    elif args.path.startswith("tile"):
        counts = [6 * k * k for k in (1, 2, 3) if 6 * k * k <= nd]
    else:
        counts = sorted({1, 2, min(4, nd), min(6, nd), nd})

    virtual = jax.default_backend() == "cpu"
    if virtual:
        print("# virtual CPU mesh: all devices share one host, so wall-clock "
              "'efficiency' is NOT measurable here — reporting per-device step "
              "time (host-serialized work) + static collective counts from the "
              "compiled SPMD program instead. Fabric efficiency needs several "
              "real devices (same code, no changes).", flush=True)
    base_rate = None
    for n in counts:
        rate, pts, nst, coll = PATHS[args.path](all_devices[:n], args.base_nel,
                                                args.num_solpts, args.steps, dtype)
        per_dev = rate / n
        step_ms = pts * nst * (3 if args.path != "epi2" else 1) / rate / nst * 1e3
        if coll is None:  # adaptive loop: budgets HLO-asserted in tests instead
            coll_s = "collectives asserted in tests/test_solvers_sharded.py"
        elif coll:
            coll_s = "collectives/step " + ",".join(f"{k}={v}" for k, v in coll.items())
        else:
            coll_s = "no collectives"
        line = (f"path={args.path} devices={n:3d} mesh={mesh_shape(n)} points={pts:9d}: "
                f"{rate:.3e} pts/s total, {per_dev:.3e}/dev, step {step_ms:.1f} ms, {coll_s}")
        if not virtual:
            if base_rate is None:
                base_rate = per_dev
            line += f", efficiency {per_dev / base_rate * 100.0:5.1f}%"
        print(line, flush=True)


if __name__ == "__main__":
    main()
