"""Production device-mesh construction + state sharding for the driver.

This is the piece that makes ``python -m wxfactory_tpu config.ini`` a
DISTRIBUTED invocation, the way ``mpirun -n 6N^2 ./WxFactory config.ini`` is
for the reference (WxFactory:102-105 there; one rank per tile,
process_topology.py:69-94 there). Here there is no rank arithmetic:
:class:`Simulation` calls :func:`build_mesh` once, places the state with
:func:`shard_state`, and every jitted step program — explicit chains and the
device-resident Krylov loops alike — partitions over the mesh via GSPMD
(XLA inserts the halo/reduction collectives). Explicit cubed-sphere runs
additionally get the hand-scheduled shard_map tile step (one device per
cubed-sphere tile, edge-colored lax.ppermute halo rounds) through
:class:`ShardMapTvdrk3`.

Unlike the reference, which REQUIRES the PE count to match 6*N^2
(simulation.py:209-230 there aborts otherwise), any device count works:
6*N^2 counts take the tile path, everything else falls back to GSPMD over a
(panel, y, x) factorization.
"""

import math
from typing import Optional, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..integrators.base import Integrator, SolverInfo

AXES = ("panel", "y", "x")


def _factor_rest(rest: int) -> Tuple[int, int]:
    y = int(math.isqrt(rest))
    while rest % y:
        y -= 1
    return y, rest // y


def build_mesh(n_devices: Optional[int] = None, devices=None) -> Optional[Mesh]:
    """A ('panel', 'y', 'x') mesh over ``devices`` (default: the visible
    devices of the default backend); None when there is only one device:
    single-device runs skip the partitioner entirely.

    6*N^2 devices (the reference's canonical PE counts) become the exact
    (6, N, N) tile mesh the shard_map paths need; any other count is
    factored as (gcd(n,6), y, x) for GSPMD."""
    devices = list(jax.devices() if devices is None else devices)
    n = len(devices) if n_devices is None else n_devices
    if n <= 1:
        return None
    devices = devices[:n]
    root = math.isqrt(n // 6) if n >= 6 else 0
    if root and 6 * root * root == n:
        shape = (6, root, root)
    else:
        p = math.gcd(n, 6)
        shape = (p,) + _factor_rest(n // p)
    return Mesh(np.array(devices).reshape(shape), axis_names=AXES)


def is_tile_mesh(mesh: Mesh) -> bool:
    return mesh.shape["panel"] == 6 and mesh.shape["y"] == mesh.shape["x"]


def state_spec(grid_type: str, equations: str) -> P:
    """PartitionSpec of the model state layout for each grid family:
    SW (3, 6, ny, nx, s^2); 3D Euler (5, 6, nk, ny, nx, s^3) — vertical
    columns stay device-local, the reference's own decomposition choice
    (process_topology.py there is horizontal-only); cartesian2d
    (4, nj, ni, s^2) shards its element axes over (y, x)."""
    if grid_type == "cartesian2d":
        return P(None, "y", "x", None)
    if equations == "euler":
        return P(None, "panel", None, "y", "x", None)
    return P(None, "panel", "y", "x", None)


def divisible(shape: Tuple[int, ...], mesh: Mesh, spec: P) -> bool:
    """True when every sharded axis divides evenly over its mesh axis —
    the predicate `auto` mode uses before committing to a sharding (uneven
    GSPMD padding works but costs performance and bit-reproducibility)."""
    for dim, axis in zip(shape, spec):
        if axis is None:
            continue
        if dim % mesh.shape[axis]:
            return False
    return True


def shard_state(q, sharding: NamedSharding):
    """Place a host/global array with ``sharding``. Multi-controller: every
    process passes the same global numpy value and only its addressable
    shards are materialized (the analogue of the reference's
    distribute_cube scatter, process_topology.py:444 there)."""
    if jax.process_count() == 1:
        return jax.device_put(q, sharding)
    arr = np.asarray(q)
    return jax.make_array_from_callback(arr.shape, sharding, lambda idx: arr[idx])


class ShardMapTvdrk3(Integrator):
    """TVD-RK3 through the hand-scheduled shard_map tile step (one device
    per cubed-sphere tile, explicit edge-colored ppermute halo rounds).
    ``maker(dt) -> (step, sharding)``;
    compiled steps are cached per distinct dt (the t_end-clamped final
    step is the only second value a run produces)."""

    def __init__(self, maker, **kwargs) -> None:
        super().__init__(**kwargs)
        self._maker = maker
        self._steps = {}

    def __step__(self, q, dt: float):
        self.solver_info = SolverInfo(total_num_it=1)
        key = float(dt)
        if key not in self._steps:
            self._steps[key] = self._maker(key)[0]
        return self._steps[key](q)
