"""In-process harness for running the REFERENCE implementation (a read-only
WxFactory checkout named by ``$WXF_REFERENCE_DIR``) to produce golden data
for parity tests. Tests that need it skip when the variable is unset or the
directory is missing (``require_reference``).

The reference requires mpi4py with >= 6 ranks (one per cubed-sphere panel).
This harness fakes mpi4py with a 6-thread lockstep world: every collective
used by the reference (bcast, allreduce, gather, scatter, Split,
Create_dist_graph_adjacent + Ineighbor_alltoall) is implemented with a
shared barrier, which is sound because all ranks execute the identical
sequence of collectives. The compiled-kernel Device is replaced by a tiny
numpy stand-in (the shallow-water path is pure numpy).

This file is test tooling, not part of the wxfactory_tpu package.
"""

import os
import sys
import threading
import types
from typing import Callable, Dict, List

import numpy as np

REFERENCE_ROOT = os.environ.get("WXF_REFERENCE_DIR") or None
REFERENCE_PATH = os.path.join(REFERENCE_ROOT, "wx_factory") if REFERENCE_ROOT else None


def require_reference() -> None:
    """Skip the calling test unless ``WXF_REFERENCE_DIR`` names a reference
    checkout. Called from inside tests and fixtures, never at import, so
    every pytest worker collects the same tests."""
    import pytest

    if REFERENCE_PATH is None:
        pytest.skip("reference implementation not configured (set WXF_REFERENCE_DIR)")
    if not os.path.isdir(REFERENCE_PATH):
        pytest.skip(f"reference implementation not found at {REFERENCE_PATH} (WXF_REFERENCE_DIR)")

_tls = threading.local()


class _World:
    """Shared lockstep state for one fake-MPI world."""

    def __init__(self, size: int):
        self.size = size
        self.barrier = threading.Barrier(size)
        self.slots: List = [None] * size
        self.lock = threading.Lock()
        self.subcomms: Dict = {}


class FakeComm:
    """Subset of mpi4py.MPI.Comm used by the reference, thread-lockstep."""

    def __init__(self, world: _World, ranks: List[int]):
        self._world = world
        self._ranks = ranks  # global thread-ranks of the members, sorted by key

    # -- rank bookkeeping -------------------------------------------------
    def _grank(self) -> int:
        return _tls.rank

    @property
    def rank(self) -> int:
        return self._ranks.index(_tls.rank)

    @property
    def size(self) -> int:
        return len(self._ranks)

    def Get_rank(self) -> int:
        return self.rank

    def Get_size(self) -> int:
        return self.size

    # -- generic lockstep exchange ---------------------------------------
    def _exchange(self, value):
        """Deposit `value`; returns the list of every member's value, indexed
        by member rank. Two barriers make the slot array safe for reuse."""
        w = self._world
        w.slots[self._grank()] = value
        w.barrier.wait()
        gathered = [w.slots[g] for g in self._ranks]
        w.barrier.wait()
        return gathered

    # -- collectives ------------------------------------------------------
    def bcast(self, obj, root: int = 0):
        return self._exchange(obj)[root]

    def allreduce(self, value, op=None):
        vals = self._exchange(value)
        if op is None or op == "sum":
            out = vals[0]
            for v in vals[1:]:
                out = out + v
            return out
        if op == "max":
            return max(vals)
        if op == "min":
            return min(vals)
        raise NotImplementedError(f"allreduce op {op}")

    def Allreduce(self, sendbuf, recvbuf, op=None):
        # mpi4py accepts [buffer, datatype] pairs — unwrap them.
        if isinstance(sendbuf, (list, tuple)):
            sendbuf = sendbuf[0]
        if isinstance(recvbuf, (list, tuple)):
            recvbuf = recvbuf[0]
        vals = self._exchange(np.array(sendbuf))
        if op == "max":
            out = np.max(np.stack(vals), axis=0)
        elif op == "min":
            out = np.min(np.stack(vals), axis=0)
        else:
            out = np.sum(np.stack(vals), axis=0)
        np.copyto(recvbuf, out)

    def gather(self, obj, root: int = 0):
        vals = self._exchange(obj)
        return vals if self.rank == root else None

    def scatter(self, objs, root: int = 0):
        vals = self._exchange(objs)
        return vals[root][self.rank]

    def barrier(self):
        self._exchange(None)

    Barrier = barrier

    def Split(self, color, key=0):
        members = self._exchange((color, key, self._grank()))
        mine = [(k, g) for (c, k, g) in members if c == color]
        ranks = [g for _, g in sorted(mine)]
        keytuple = (tuple(ranks),)
        with self._world.lock:
            if keytuple not in self._world.subcomms:
                self._world.subcomms[keytuple] = FakeComm(self._world, ranks)
        self._world.barrier.wait()
        return self._world.subcomms[keytuple]

    def Create_dist_graph_adjacent(self, sources, destinations):
        return FakeGraphComm(self, list(sources), list(destinations))


class FakeGraphComm:
    """Neighborhood alltoall over a parent FakeComm."""

    def __init__(self, parent: FakeComm, sources: List[int], destinations: List[int]):
        self.parent = parent
        self.sources = sources
        self.destinations = destinations

    def Ineighbor_alltoall(self, sendbuf, recvbuf):
        # Everyone deposits (destinations, sendbuf); then each rank pulls, for
        # its k-th source, the source's send-block addressed to this rank
        # (matching duplicate destinations by occurrence index, like MPI).
        me = self.parent.rank
        deposited = self.parent._exchange((self.destinations, np.array(sendbuf, copy=True)))

        seen: Dict[int, int] = {}
        for k, src in enumerate(self.sources):
            occurrence = seen.get(src, 0)
            seen[src] = occurrence + 1
            src_dests, src_buf = deposited[src]
            positions = [i for i, d in enumerate(src_dests) if d == me]
            recvbuf[k] = src_buf[positions[occurrence]]
        return _DoneRequest()


class _DoneRequest:
    def Wait(self):
        return None

    def wait(self):
        return None


def _install_fake_modules():
    """Install fake mpi4py + device modules, and the reference on sys.path."""
    require_reference()
    if REFERENCE_PATH not in sys.path:
        sys.path.insert(0, REFERENCE_PATH)

    if "mpi4py" not in sys.modules:
        mpi4py = types.ModuleType("mpi4py")
        mpi_ns = types.SimpleNamespace()
        mpi_ns.SUM = "sum"
        mpi_ns.MAX = "max"
        mpi_ns.MIN = "min"
        mpi_ns.DOUBLE = "double"
        mpi_ns.COMPLEX16 = "complex16"
        mpi_ns.COMM_NULL = None
        mpi_ns.Comm = FakeComm
        mpi_ns.Request = _DoneRequest
        mpi_ns.COMM_WORLD = None  # set per-world below via _set_world
        mpi4py.MPI = mpi_ns
        sys.modules["mpi4py"] = mpi4py
        sys.modules["mpi4py.MPI"] = mpi_ns

    if "device" not in sys.modules:
        device_mod = types.ModuleType("device")

        class Device:  # minimal duck-typed stand-in (reference device/device.py:16)
            def __init__(self, comm):
                import scipy

                self.xp = np
                self.xalg = scipy
                self.comm = comm
                self.pde = None

            def synchronize(self, **kw):
                pass

            def timestamp(self, **kw):
                import time

                return time.time()

            def elapsed(self, timestamps):
                out = [timestamps[i + 1] - timestamps[i] for i in range(len(timestamps) - 1)]
                out.append(timestamps[-1] - timestamps[0])
                return out

            def array(self, a):
                return np.asarray(a)

            def to_host(self, a):
                return np.asarray(a)

            def has_128_bits_float(self) -> bool:
                # pmex's norm-estimate path (solvers/pmex.py:198 there).
                return hasattr(np, "float128")

        device_mod.Device = Device
        device_mod.CpuDevice = Device
        device_mod.CudaDevice = Device
        sys.modules["device"] = device_mod


_PERSISTENT_WORLDS: Dict[int, tuple] = {}


def run_lockstep(size: int, fn: Callable[[int], object]) -> List:
    """Run fn(rank) on `size` lockstep threads under the fake MPI world.
    Returns the per-rank results (exceptions re-raised).

    The world object is PERSISTENT per size: the reference's
    ProcessTopology.__init__ captures ``MPI.COMM_WORLD`` as a default
    argument at import time (process_topology.py:50), so the first world
    must stay THE world; a crashed run leaves its barrier aborted, which is
    repaired here so one failing golden test cannot poison the rest."""
    _install_fake_modules()
    if size in _PERSISTENT_WORLDS:
        world, comm_world = _PERSISTENT_WORLDS[size]
        if world.barrier.broken:
            world.barrier.reset()
    else:
        world = _World(size)
        comm_world = FakeComm(world, list(range(size)))
        _PERSISTENT_WORLDS[size] = (world, comm_world)
    sys.modules["mpi4py"].MPI.COMM_WORLD = comm_world

    results: List = [None] * size
    errors: List = [None] * size

    def worker(r):
        _tls.rank = r
        try:
            results[r] = fn(r)
        except BaseException as e:  # noqa: BLE001 - reported to caller
            errors[r] = e
            # Break every barrier so siblings do not hang.
            world.barrier.abort()

    threads = [threading.Thread(target=worker, args=(r,)) for r in range(size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    # Prefer the ROOT failure: a thread that died breaks the barrier, so
    # sibling ranks die with a (secondary) BrokenBarrierError.
    root = [e for e in errors if e is not None and not isinstance(e, threading.BrokenBarrierError)]
    if root:
        raise root[0]
    for e in errors:
        if e is not None:
            raise e
    return results


# ---------------------------------------------------------------------------
# Reference shallow-water runs


def reference_sw_case(case_number: int, nel_per_tile: int, num_solpts: int, lambda0=0.0, phi0=0.0, alpha0=0.0):
    """Run the reference SW initial condition + one RHS evaluation on 6 ranks.

    Returns (Q, rhs) as global arrays (3, 6, ny, nx, s^2) in panel order.
    """
    _install_fake_modules()

    def tile_run(rank):
        import numpy as xp_np  # noqa: F401

        from mpi4py import MPI

        import device as device_mod

        dev = device_mod.CpuDevice(MPI.COMM_WORLD)

        from process_topology import ProcessTopology

        ptopo = ProcessTopology(dev)

        from types import SimpleNamespace

        param = SimpleNamespace(
            case_number=case_number,
            filter_apply=False,
            expfilter_apply=False,
            apply_sponge=False,
            dt=60.0,
            t_end=0.0,
            matsuno_wave_type="Rossby",
            matsuno_amp=1e-5,
            num_elements_horizontal=nel_per_tile,
            num_solpts=num_solpts,
        )

        from geometry.cubed_sphere_2d import CubedSphere2D
        from geometry.metric2d import Metric2D
        from geometry.operators import DFROperators

        geom = CubedSphere2D(nel_per_tile, num_solpts, lambda0, phi0, alpha0, ptopo, param, dev)
        mtrx = DFROperators(geom, param, dev)
        metric = Metric2D(geom)

        import init.shallow_water_test as swt

        topo = None
        if case_number == 0:
            u1, u2, h = swt.circular_vortex(geom, metric, param)
        elif case_number == 1:
            u1, u2, h = swt.williamson_case1(geom, metric, param)
        elif case_number == 9:
            u1, u2, h = swt.case_matsuno(geom, metric, param)
        elif case_number == 10:
            u1, u2, h, hsurf, dzdx1, dzdx2, hsurf_i, hsurf_j = swt.case_unsteady_zonal(geom, metric, mtrx, param)
            topo = SimpleNamespace(hsurf=hsurf, dzdx1=dzdx1, dzdx2=dzdx2, hsurf_itf_i=hsurf_i, hsurf_itf_j=hsurf_j)
        elif case_number == 2:
            u1, u2, h = swt.williamson_case2(geom, metric, param)
        elif case_number == 5:
            u1, u2, h, hsurf, dzdx1, dzdx2, hsurf_i, hsurf_j = swt.williamson_case5(geom, metric, mtrx, param)
            topo = SimpleNamespace(hsurf=hsurf, dzdx1=dzdx1, dzdx2=dzdx2, hsurf_itf_i=hsurf_i, hsurf_itf_j=hsurf_j)
        elif case_number == 6:
            u1, u2, h = swt.williamson_case6(geom, metric, param)
        elif case_number == 8:
            u1, u2, h = swt.case_galewsky(geom, metric, param)
        else:
            raise ValueError(case_number)

        Q = np.stack([np.asarray(h), np.asarray(h * u1), np.asarray(h * u2)])

        from rhs.rhs_sw import RhsShallowWater

        rhs_fn = RhsShallowWater(Q.shape, geom, mtrx, metric, topo, ptopo, num_solpts, nel_per_tile)
        dQ = rhs_fn(Q)
        return np.asarray(Q), np.asarray(dQ)

    results = run_lockstep(6, tile_run)
    Q = np.stack([r[0] for r in results], axis=1)  # (3, 6, ny, nx, s^2)
    dQ = np.stack([r[1] for r in results], axis=1)
    return Q, dQ


def reference_euler3d_rhs_at(case_number, nel_h, nel_v, num_solpts, ztop, Q_global):
    """Evaluate the reference RHS at a PROVIDED global state (nv, 6, ...).
    Returns the global dQ."""
    _install_fake_modules()
    Q_global = np.asarray(Q_global)

    def tile_run(rank):
        from types import SimpleNamespace

        from mpi4py import MPI

        import device as device_mod

        dev = device_mod.CpuDevice(MPI.COMM_WORLD)
        from process_topology import ProcessTopology

        ptopo = ProcessTopology(dev)
        param = SimpleNamespace(
            case_number=case_number, depth_approx="shallow", filter_apply=False,
            expfilter_apply=False, apply_sponge=False, num_elements_horizontal=nel_h,
            num_elements_vertical=nel_v, num_solpts=num_solpts, ztop=ztop, dt=30.0, t_end=0.0,
        )
        from geometry.cubed_sphere_3d import CubedSphere3D
        from geometry.metric3d import Metric3DTopo
        from geometry.operators import DFROperators

        geom = CubedSphere3D(nel_h, nel_v, num_solpts, 0.0, 0.0, 0.0, ztop, ptopo, param, dev)
        mtrx = DFROperators(geom, param, dev)
        metric = Metric3DTopo(geom, mtrx)
        from init.initialize import initialize_euler

        initialize_euler(geom, metric, mtrx, param)  # builds metric (case geometry)
        from pde.pde_euler_cubesphere import PDEEulerCubesphere
        from rhs.rhs_dfr import RHSDirecFluxReconstruction_mpi

        Q = np.ascontiguousarray(Q_global[:, rank])
        pde = PDEEulerCubesphere(geom, param, metric)
        rhs_fn = RHSDirecFluxReconstruction_mpi(pde, geom, mtrx, metric, None, ptopo, param, Q.shape)
        return np.asarray(rhs_fn(Q))

    results = run_lockstep(6, tile_run)
    return np.stack(results, axis=1)


def reference_euler3d_epi_steps(
    case_number: int,
    nel_h: int,
    nel_v: int,
    num_solpts: int,
    ztop: float,
    dt: float,
    num_steps: int,
    order: int = 2,
    exponential_solver: str = "kiops",
    tolerance: float = 1e-7,
):
    """Run the reference Epi integrator for `num_steps` steps on a 3D Euler
    case. Returns the global state after each step: (num_steps, nv, 6, ...)."""
    _install_fake_modules()

    def tile_run(rank):
        from types import SimpleNamespace

        from mpi4py import MPI

        import device as device_mod

        dev = device_mod.CpuDevice(MPI.COMM_WORLD)

        from process_topology import ProcessTopology

        ptopo = ProcessTopology(dev)

        param = SimpleNamespace(
            case_number=case_number,
            depth_approx="shallow",
            filter_apply=False,
            expfilter_apply=False,
            apply_sponge=False,
            num_elements_horizontal=nel_h,
            num_elements_vertical=nel_v,
            num_solpts=num_solpts,
            ztop=ztop,
            dt=dt,
            t_end=dt * num_steps,
            tolerance=tolerance,
            jacobian_method="complex",
            exponential_solver=exponential_solver,
            time_integrator=f"epi{order}",
            exode_method="RK45",
            exode_controller="",
            verbose_solver=0,
        )

        from geometry.cubed_sphere_3d import CubedSphere3D
        from geometry.metric3d import Metric3DTopo
        from geometry.operators import DFROperators

        geom = CubedSphere3D(nel_h, nel_v, num_solpts, 0.0, 0.0, 0.0, ztop, ptopo, param, dev)
        mtrx = DFROperators(geom, param, dev)
        metric = Metric3DTopo(geom, mtrx)

        from init.initialize import initialize_euler

        Q, _topo = initialize_euler(geom, metric, mtrx, param)

        from pde.pde_euler_cubesphere import PDEEulerCubesphere
        from rhs.rhs_dfr import RHSDirecFluxReconstruction_mpi

        pde = PDEEulerCubesphere(geom, param, metric)
        rhs_fn = RHSDirecFluxReconstruction_mpi(pde, geom, mtrx, metric, None, ptopo, param, Q.shape)

        from integrators.epi import Epi

        stepper = Epi(param, order, rhs_fn, device=dev)
        states = []
        for _ in range(num_steps):
            Q = stepper.step(Q, dt)
            states.append(np.asarray(Q).copy())
        return np.stack(states)

    results = run_lockstep(6, tile_run)
    return np.stack(results, axis=2)  # (num_steps, nv, 6, ...)


def reference_euler3d_ros2_steps(
    case_number: int,
    nel_h: int,
    nel_v: int,
    num_solpts: int,
    ztop: float,
    dt: float,
    num_steps: int,
    tolerance: float = 1e-7,
    gmres_restart: int = 30,
):
    """Run the reference Ros2 integrator (integrators/ros2.py there:
    FGMRES on (I - dt/2 J)) for `num_steps` steps on a 3D Euler case.
    Returns the global state after each step."""
    _install_fake_modules()

    def tile_run(rank):
        from types import SimpleNamespace

        from mpi4py import MPI

        import device as device_mod

        dev = device_mod.CpuDevice(MPI.COMM_WORLD)

        from process_topology import ProcessTopology

        ptopo = ProcessTopology(dev)

        param = SimpleNamespace(
            case_number=case_number,
            depth_approx="shallow",
            filter_apply=False,
            expfilter_apply=False,
            apply_sponge=False,
            num_elements_horizontal=nel_h,
            num_elements_vertical=nel_v,
            num_solpts=num_solpts,
            ztop=ztop,
            dt=dt,
            t_end=dt * num_steps,
            tolerance=tolerance,
            jacobian_method="complex",
            time_integrator="ros2",
            gmres_restart=gmres_restart,
            linear_solver="fgmres",
            verbose_solver=0,
        )

        from geometry.cubed_sphere_3d import CubedSphere3D
        from geometry.metric3d import Metric3DTopo
        from geometry.operators import DFROperators

        geom = CubedSphere3D(nel_h, nel_v, num_solpts, 0.0, 0.0, 0.0, ztop, ptopo, param, dev)
        mtrx = DFROperators(geom, param, dev)
        metric = Metric3DTopo(geom, mtrx)

        from init.initialize import initialize_euler

        Q, _topo = initialize_euler(geom, metric, mtrx, param)

        from pde.pde_euler_cubesphere import PDEEulerCubesphere
        from rhs.rhs_dfr import RHSDirecFluxReconstruction_mpi

        pde = PDEEulerCubesphere(geom, param, metric)
        rhs_fn = RHSDirecFluxReconstruction_mpi(pde, geom, mtrx, metric, None, ptopo, param, Q.shape)

        from integrators.ros2 import Ros2

        stepper = Ros2(param, rhs_fn, device=dev)
        states = []
        for _ in range(num_steps):
            Q = stepper.step(Q, dt)
            states.append(np.asarray(Q).copy())
        return np.stack(states)

    results = run_lockstep(6, tile_run)
    return np.stack(results, axis=2)  # (num_steps, nv, 6, ...)


def reference_sw_steps(case_number: int, nel_per_tile: int, num_solpts: int,
                       dt: float, num_steps: int):
    """Run the reference SW model for `num_steps` TVD-RK3 steps
    (integrators/tvdrk3.py there). Returns the global state after each step:
    (num_steps, 3, 6, ny, nx, s^2)."""
    _install_fake_modules()

    def tile_run(rank):
        from types import SimpleNamespace

        from mpi4py import MPI

        import device as device_mod

        dev = device_mod.CpuDevice(MPI.COMM_WORLD)
        from process_topology import ProcessTopology

        ptopo = ProcessTopology(dev)
        param = SimpleNamespace(
            case_number=case_number, filter_apply=False, expfilter_apply=False,
            apply_sponge=False, dt=dt, t_end=dt * num_steps,
            matsuno_wave_type="Rossby", matsuno_amp=1e-5,
            num_elements_horizontal=nel_per_tile, num_solpts=num_solpts,
            verbose_solver=0, store_solver_stats=False,
        )
        from geometry.cubed_sphere_2d import CubedSphere2D
        from geometry.metric2d import Metric2D
        from geometry.operators import DFROperators

        geom = CubedSphere2D(nel_per_tile, num_solpts, 0.0, 0.0, 0.0, ptopo, param, dev)
        mtrx = DFROperators(geom, param, dev)
        metric = Metric2D(geom)
        import init.shallow_water_test as swt

        if case_number == 2:
            u1, u2, h = swt.williamson_case2(geom, metric, param)
        elif case_number == 6:
            u1, u2, h = swt.williamson_case6(geom, metric, param)
        elif case_number == 8:
            u1, u2, h = swt.case_galewsky(geom, metric, param)
        else:
            raise ValueError(case_number)
        Q = np.stack([np.asarray(h), np.asarray(h * u1), np.asarray(h * u2)])
        from rhs.rhs_sw import RhsShallowWater

        rhs_fn = RhsShallowWater(Q.shape, geom, mtrx, metric, None, ptopo, num_solpts, nel_per_tile)
        from integrators.tvdrk3 import Tvdrk3

        stepper = Tvdrk3(param, rhs_fn, device=dev)
        states = []
        for _ in range(num_steps):
            Q = stepper.step(Q, dt)
            states.append(np.asarray(Q).copy())
        return np.stack(states)

    results = run_lockstep(6, tile_run)
    return np.stack(results, axis=2)  # (num_steps, 3, 6, ny, nx, s^2)


def reference_sw_epi_steps(case_number: int, nel_per_tile: int, num_solpts: int,
                           dt: float, num_steps: int, order: int = 3,
                           exponential_solver: str = "pmex", tolerance: float = 1e-7):
    """Run the reference SW model through its Epi exponential integrator
    (integrators/epi.py there, complex-step Jacobian + kiops/pmex) for
    `num_steps` steps — the canonical case6 configuration
    (reference config/case6.ini: epi3 + pmex). Returns the global
    state after each step: (num_steps, 3, 6, ny, nx, s^2)."""
    _install_fake_modules()

    def tile_run(rank):
        from types import SimpleNamespace

        from mpi4py import MPI

        import device as device_mod

        dev = device_mod.CpuDevice(MPI.COMM_WORLD)
        from process_topology import ProcessTopology

        ptopo = ProcessTopology(dev)
        param = SimpleNamespace(
            case_number=case_number, filter_apply=False, expfilter_apply=False,
            apply_sponge=False, dt=dt, t_end=dt * num_steps,
            matsuno_wave_type="Rossby", matsuno_amp=1e-5,
            num_elements_horizontal=nel_per_tile, num_solpts=num_solpts,
            tolerance=tolerance, jacobian_method="complex",
            exponential_solver=exponential_solver,
            time_integrator=f"epi{order}",
            exode_method="RK45", exode_controller="",
            verbose_solver=0, store_solver_stats=False,
        )
        from geometry.cubed_sphere_2d import CubedSphere2D
        from geometry.metric2d import Metric2D
        from geometry.operators import DFROperators

        geom = CubedSphere2D(nel_per_tile, num_solpts, 0.0, 0.0, 0.0, ptopo, param, dev)
        mtrx = DFROperators(geom, param, dev)
        metric = Metric2D(geom)
        import init.shallow_water_test as swt

        if case_number == 2:
            u1, u2, h = swt.williamson_case2(geom, metric, param)
        elif case_number == 6:
            u1, u2, h = swt.williamson_case6(geom, metric, param)
        elif case_number == 8:
            u1, u2, h = swt.case_galewsky(geom, metric, param)
        else:
            raise ValueError(case_number)
        Q = np.stack([np.asarray(h), np.asarray(h * u1), np.asarray(h * u2)])
        from rhs.rhs_sw import RhsShallowWater

        rhs_fn = RhsShallowWater(Q.shape, geom, mtrx, metric, None, ptopo, num_solpts, nel_per_tile)
        from integrators.epi import Epi

        stepper = Epi(param, order, rhs_fn, device=dev, init_substeps=10)
        states = []
        for _ in range(num_steps):
            Q = stepper.step(Q, dt)
            states.append(np.asarray(Q).copy())
        return np.stack(states)

    results = run_lockstep(6, tile_run)
    return np.stack(results, axis=2)  # (num_steps, 3, 6, ny, nx, s^2)


# ---------------------------------------------------------------------------
# Reference 3D Euler runs


def reference_euler3d_case(case_number: int, nel_h: int, nel_v: int, num_solpts: int, ztop: float):
    """Run the reference 3D Euler initial condition + metric + one RHS
    evaluation on 6 ranks (one panel per rank).

    Returns a dict of global arrays (leading panel axis inserted after any
    variable axis): Q, dQ, and the 'new layout' metric fields.
    """
    _install_fake_modules()

    def tile_run(rank):
        from types import SimpleNamespace

        from mpi4py import MPI

        import device as device_mod

        dev = device_mod.CpuDevice(MPI.COMM_WORLD)

        from process_topology import ProcessTopology

        ptopo = ProcessTopology(dev)

        param = SimpleNamespace(
            case_number=case_number,
            depth_approx="shallow",
            filter_apply=False,
            expfilter_apply=False,
            apply_sponge=False,
            num_elements_horizontal=nel_h,
            num_elements_vertical=nel_v,
            num_solpts=num_solpts,
            ztop=ztop,
            dt=30.0,
            t_end=0.0,
        )

        from geometry.cubed_sphere_3d import CubedSphere3D
        from geometry.metric3d import Metric3DTopo
        from geometry.operators import DFROperators

        geom = CubedSphere3D(nel_h, nel_v, num_solpts, 0.0, 0.0, 0.0, ztop, ptopo, param, dev)
        mtrx = DFROperators(geom, param, dev)
        metric = Metric3DTopo(geom, mtrx)

        from init.initialize import initialize_euler

        Q, _topo = initialize_euler(geom, metric, mtrx, param)

        from pde.pde_euler_cubesphere import PDEEulerCubesphere
        from rhs.rhs_dfr import RHSDirecFluxReconstruction_mpi

        pde = PDEEulerCubesphere(geom, param, metric)
        rhs_fn = RHSDirecFluxReconstruction_mpi(pde, geom, mtrx, metric, None, ptopo, param, Q.shape)
        dQ = rhs_fn(Q)

        out = {
            "Q": np.asarray(Q),
            "dQ": np.asarray(dQ),
            "sqrtG": np.asarray(metric.sqrtG_new),
            "inv_dzdeta": np.asarray(metric.inv_dzdeta_new),
            "h_contra": np.asarray(metric.h_contra_new),
            "christoffel": np.asarray(metric.christoffel),
            "sqrtG_itf_i": np.asarray(metric.sqrtG_itf_i_new),
            "sqrtG_itf_j": np.asarray(metric.sqrtG_itf_j_new),
            "sqrtG_itf_k": np.asarray(metric.sqrtG_itf_k_new),
            "h_contra_itf_i": np.asarray(metric.h_contra_itf_i_new),
            "h_contra_itf_j": np.asarray(metric.h_contra_itf_j_new),
            "h_contra_itf_k": np.asarray(metric.h_contra_itf_k_new),
        }
        return out

    results = run_lockstep(6, tile_run)

    def stack(key, var_axes):
        """Stack the per-panel arrays, inserting the panel axis after any
        leading variable axes."""
        arrs = [r[key] for r in results]
        return np.stack(arrs, axis=var_axes)

    return {
        "Q": stack("Q", 1),
        "dQ": stack("dQ", 1),
        "sqrtG": stack("sqrtG", 0),
        "inv_dzdeta": stack("inv_dzdeta", 0),
        "h_contra": stack("h_contra", 2),
        "christoffel": stack("christoffel", 2),
        "sqrtG_itf_i": stack("sqrtG_itf_i", 0),
        "sqrtG_itf_j": stack("sqrtG_itf_j", 0),
        "sqrtG_itf_k": stack("sqrtG_itf_k", 0),
        "h_contra_itf_i": stack("h_contra_itf_i", 2),
        "h_contra_itf_j": stack("h_contra_itf_j", 2),
        "h_contra_itf_k": stack("h_contra_itf_k", 2),
    }
