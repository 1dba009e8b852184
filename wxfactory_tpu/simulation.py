"""Simulation driver: configuration -> geometry -> state -> integrator -> run.

Capability parity with the reference's simulation/simulation.py
(Simulation): builds every layer from a Configuration, dispatches the time
integrator by name, runs the step loop with the end-time clamp and the
global NaN check, and drives the output manager.
"""

import math
import time
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp

from .config import Configuration, load_configuration
from .geometry import (
    make_cartesian_2d,
    make_cubed_sphere_2d,
    make_cubed_sphere_3d,
    make_metric_2d,
    make_metric_3d,
)
from .integrators import BackwardEuler, Bdf2, CrankNicolson, Epi, EpiStiff, Euler1, Ros2, Srerk, Tvdrk3
from .models import make_rhs_euler_cartesian, make_rhs_euler_cubesphere, make_rhs_shallow_water
from .ops.dfr import make_dfr_operators
from .output import OutputManager
from .parallel import CubedSphereTopology
from .runtime import platform_devices


def _dcmip_planet_params(case_number: int) -> Tuple[float, bool]:
    """Reduced-planet configuration per DCMIP case
    (reference cubed_sphere_3d.py:408-432)."""
    if case_number == 31:
        return 125.0, False
    if case_number == 20:
        return 1.0, False
    if case_number in (21, 22):
        return 500.0, False
    return 1.0, True


class Simulation:
    def __init__(self, config: Configuration | str):
        if isinstance(config, str):
            config = load_configuration(config)
        self.config = config
        # The platform named by System.desired_device (raises when absent),
        # else JAX's default one; construction and the run are placed on its
        # devices.
        self.devices = platform_devices(config.desired_device)
        self.device = next(d for d in self.devices if d.process_index == jax.process_index())
        with jax.default_device(self.device):
            self._build()

    def _build(self):
        c = self.config

        self.ops = make_dfr_operators(c.num_solpts, three_d=(c.equations == "euler" and c.grid_type == "cubed_sphere"))
        self.topo = None
        self.topology = None
        self.metric = None
        self.post_step_hook = None

        # float64 (default) matches the reference bit-for-bit.
        self.dtype = jnp.float32 if getattr(c, "precision", "float64") == "float32" else jnp.float64

        if c.grid_type == "cubed_sphere" and c.equations == "shallow_water":
            self.geom = make_cubed_sphere_2d(c.num_elements_horizontal, c.num_solpts, c.lambda0, c.phi0, c.alpha0)
            self.metric = make_metric_2d(self.geom)
            self.topology = CubedSphereTopology(self.geom)
            q0, self.topo = self._init_sw()
            self.rhs = make_rhs_shallow_water(
                self.geom, self.ops, self.metric, topo=self.topo, dtype=self.dtype
            )
        elif c.grid_type == "cubed_sphere" and c.equations == "euler":
            scale, rotating = _dcmip_planet_params(c.case_number)
            self.geom = make_cubed_sphere_3d(
                c.num_elements_horizontal, c.num_elements_vertical, c.num_solpts, c.ztop,
                c.lambda0, c.phi0, c.alpha0, deep=(c.depth_approx == "deep"),
                planet_scaling_factor=scale, planet_is_rotating=rotating,
            )
            self.topology = CubedSphereTopology(self.geom)
            q0, extra_forcing = self._init_euler3d()
            self.extra_forcing = extra_forcing
            if self.metric is None:
                self.metric = make_metric_3d(self.geom, self.ops, self.topology)
            self.rhs = make_rhs_euler_cubesphere(
                self.geom, self.ops, self.metric, self.topology,
                advection_only=(c.case_number < 13), extra_forcing=extra_forcing,
                dtype=self.dtype,
            )
            if c.case_number in (11, 12):
                # Prescribed time-dependent winds: overwrite the momentum after
                # every step (reference simulation.py:159-172).
                from .testcases.dcmip import dcmip_T11_update_winds, dcmip_T12_update_winds

                update = dcmip_T11_update_winds if c.case_number == 11 else dcmip_T12_update_winds

                def wind_overwrite(q, t):
                    u1, u2, w = update(self.geom, t)
                    rho = q[0]
                    return (
                        q.at[1].set(rho * jnp.asarray(u1))
                        .at[2].set(rho * jnp.asarray(u2))
                        .at[3].set(rho * jnp.asarray(w))
                    )

                self.post_step_hook = wind_overwrite
        elif c.grid_type == "cartesian2d":
            self.geom = make_cartesian_2d(
                (c.x0, c.x1), (c.z0, c.z1), c.num_elements_horizontal, c.num_elements_vertical, c.num_solpts
            )
            self.metric = None
            from .testcases import initialize_cartesian2d

            q0 = initialize_cartesian2d(self.geom, c.case_number, c.bubble_theta, c.bubble_rad)
            self.rhs = make_rhs_euler_cartesian(self.geom, self.ops, dtype=self.dtype)
        else:
            raise ValueError(f"Unsupported grid/equations: {c.grid_type}/{c.equations}")

        # Optional f32 companion RHS for the Epi/Ros2 Krylov hot loop
        # (mixed_precision_krylov): perturbation (base-state-split) form
        # around the initial state, so the f32 matvec resolves the
        # tendency-scale physics (see models/*.py perturbation_base); the
        # Krylov matvec is a jax.jvp of it.
        self.rhs32 = None
        if getattr(c, "mixed_precision_krylov", False) and self.dtype == jnp.float64:
            if c.grid_type == "cubed_sphere" and c.equations == "shallow_water":
                self.rhs32 = make_rhs_shallow_water(
                    self.geom, self.ops, self.metric, topo=self.topo,
                    dtype=jnp.float32, perturbation_base=jnp.asarray(q0),
                )
            elif (
                c.grid_type == "cubed_sphere" and c.equations == "euler"
                and c.case_number >= 13 and extra_forcing is None
            ):
                self.rhs32 = make_rhs_euler_cubesphere(
                    self.geom, self.ops, self.metric, self.topology,
                    dtype=jnp.float32, perturbation_base=jnp.asarray(q0),
                )

        self.output = OutputManager(c, self.geom, self.ops, self.metric, self.topo)

        self.initial_q = jnp.asarray(q0, dtype=self.dtype)
        self.starting_step = 0
        self._rhs_probes = None  # built lazily on first rhs_timing sample
        if c.starting_step > 0:
            try:
                self.initial_q = jnp.asarray(
                    self.output.load_state_from_file(c.starting_step, self.initial_q.shape),
                    dtype=self.dtype,
                )
                self.starting_step = c.starting_step
            except (FileNotFoundError, ValueError) as e:
                print(f"WARNING: Could not load state for step {c.starting_step} ({e}); starting from step 0")

        self._setup_distribution()
        self.integrator = self._create_integrator()

        if getattr(c, "mixed_precision_krylov", False):
            # The f32 companion only feeds the DEVICE-resident Krylov
            # solvers; flag the knob as a no-op otherwise so users don't
            # flip it and silently measure the f64 path.
            name = c.time_integrator.lower()
            consumes = (
                (name.startswith("epi") and c.exponential_solver == "kiops_jit")
                or (name == "ros2" and c.linear_solver.startswith("fgmres_jit"))
            )
            if self.rhs32 is None:
                print(
                    "WARNING: mixed_precision_krylov is set but no f32 companion RHS "
                    "is available for this model/case; the knob has no effect"
                )
            elif not consumes:
                print(
                    f"WARNING: mixed_precision_krylov is set but {c.time_integrator} with "
                    f"exponential_solver={c.exponential_solver!r}/linear_solver={c.linear_solver!r} "
                    "cannot consume it — use kiops_jit (Epi/Srerk) or fgmres_jit (Ros2)"
                )

        from .ops.filters import make_apply_filters

        self.apply_filters = make_apply_filters(c, self.ops, self.metric, self.geom)

    # ------------------------------------------------------------------
    def _init_sw(self):
        from .testcases import (
            case_galewsky,
            case_unsteady_zonal,
            williamson_case1,
            williamson_case2,
            williamson_case5,
            williamson_case6,
        )

        from .testcases import case_matsuno, circular_vortex

        c = self.config
        topo = None
        if c.case_number == 0:
            q = circular_vortex(self.geom)
        elif c.case_number == 9:
            q = case_matsuno(self.geom, c.matsuno_wave_type, c.matsuno_amp)
        elif c.case_number == 1:
            q = williamson_case1(self.geom)
        elif c.case_number == 2:
            q = williamson_case2(self.geom)
        elif c.case_number == 5:
            q, topo = williamson_case5(self.geom, self.ops)
        elif c.case_number == 6:
            q = williamson_case6(self.geom)
        elif c.case_number == 8:
            q = case_galewsky(self.geom)
        elif c.case_number == 10:
            q, topo = case_unsteady_zonal(self.geom, self.ops)
        else:
            raise ValueError(f"Unsupported shallow-water case {c.case_number}")
        return q, topo

    def _init_euler3d(self):
        """Build the 3D Euler initial state; may replace self.geom (cases with
        topography) and set self.metric. Returns (Q, extra_forcing)."""
        from .testcases.dcmip import (
            acoustic_wave,
            dcmip_advection_deformation,
            dcmip_advection_hadley,
            dcmip_gravity_wave,
            dcmip_schar_waves,
            dcmip_steady_state_mountain,
            make_schar_damping,
        )

        c = self.config
        builder = lambda g: make_metric_3d(g, self.ops, self.topology)
        if c.case_number == 11:
            return dcmip_advection_deformation(self.geom), None
        if c.case_number == 12:
            return dcmip_advection_hadley(self.geom), None
        if c.case_number == 20:
            q0, self.geom = dcmip_steady_state_mountain(self.geom)
            return q0, None
        if c.case_number in (21, 22):
            shear = c.case_number == 22
            q0, self.geom, self.metric = dcmip_schar_waves(self.geom, builder, shear=shear)
            return q0, make_schar_damping(self.geom, self.metric, shear)
        if c.case_number == 31:
            return dcmip_gravity_wave(self.geom), None
        if c.case_number == 77:
            return acoustic_wave(self.geom), None
        raise ValueError(f"Unsupported 3D Euler case {c.case_number}")

    def _setup_distribution(self):
        """Build the production device mesh and shard the state over it
        (the analogue of the reference's
        ``mpirun -n 6N^2 ./WxFactory`` launch, WxFactory:102-105 +
        process_topology.py:69-94 there). With >1 visible device (or
        multi-controller processes) the initial state is placed with a
        (panel, y, x) NamedSharding, so EVERY jitted step program — the
        explicit chains and the device-resident Krylov hot loops alike —
        partitions over the mesh; explicit cubed-sphere runs on
        6*N^2-device meshes additionally select the hand-scheduled
        shard_map tile step (``distribute`` config knob, default auto)."""
        from jax.sharding import NamedSharding

        from .parallel.mesh import build_mesh, divisible, is_tile_mesh, shard_state, state_spec

        c = self.config
        knob = getattr(c, "distribute", "auto")
        self.mesh = None
        self.sharding = None
        self._shard_maker = None
        mesh = None if knob == "off" else build_mesh(devices=self.devices)
        if mesh is None:
            if knob in ("gspmd", "shard_map"):
                raise ValueError(f"distribute={knob!r} requires more than one device")
            self.initial_q = jax.device_put(self.initial_q, self.device)
            return
        spec = state_spec(c.grid_type, c.equations)
        if not divisible(self.initial_q.shape, mesh, spec):
            if knob != "auto":
                raise ValueError(
                    f"distribute={knob!r}: state shape {tuple(self.initial_q.shape)} does not "
                    f"divide over the {dict(mesh.shape)} mesh with spec {spec}"
                )
            from .parallel.distributed import primary_print

            primary_print(
                f"distribute=auto: state shape {tuple(self.initial_q.shape)} does not divide "
                f"over the {dict(mesh.shape)} mesh; running on one device"
            )
            self.initial_q = jax.device_put(self.initial_q, self.device)
            return
        self.mesh = mesh
        self.sharding = NamedSharding(mesh, spec)
        self.initial_q = shard_state(self.initial_q, self.sharding)
        if knob != "gspmd":
            self._shard_maker = self._build_shard_maker(mesh, is_tile_mesh(mesh))
            if self._shard_maker is None and knob == "shard_map":
                raise ValueError(
                    "distribute='shard_map' needs an explicit cubed-sphere run (tvdrk3 "
                    "without topography/forcing hooks) on a 6*N^2-device mesh with N | nel"
                )

    def _build_shard_maker(self, mesh, tile_mesh: bool):
        """dt -> (step, sharding) factory for the hand-scheduled shard_map
        tile step, or None when this run can't use it (non-explicit
        integrator, topography/forcing hooks, non-tile mesh, N∤nel)."""
        c = self.config
        if (
            not tile_mesh
            or c.time_integrator.lower() != "tvdrk3"
            or c.grid_type != "cubed_sphere"
            or self.post_step_hook is not None
            or c.num_elements_horizontal % mesh.shape["y"]
        ):
            return None
        if c.equations == "shallow_water" and self.topo is not None:
            return None  # tile step has no topography source term
        if c.equations == "euler" and (
            c.case_number < 13 or getattr(self, "extra_forcing", None) is not None
        ):
            return None  # tile step builds the full Euler RHS (no advection/damping hooks)

        geom, ops, metric = self.geom, self.ops, self.metric
        dtype = self.dtype

        def maker(dt):
            if c.equations == "shallow_water":
                from .parallel.shard_map_sw import make_shard_map_sw_step_general

                return make_shard_map_sw_step_general(geom, ops, metric, mesh, dt, dtype=dtype)

            from .parallel.shard_map_euler3d import make_shard_map_euler3d_step

            return make_shard_map_euler3d_step(geom, ops, metric, mesh, dt, dtype=dtype)

        return maker

    def _create_preconditioner(self):
        """lu/ilu -> Factorization (practical for small problems); the
        multigrid slots are gated off exactly like the reference
        (simulation.py:274-275 there raises for anything != none)."""
        c = self.config
        if c.preconditioner == "none":
            return None
        if c.preconditioner in ("lu", "ilu"):
            from .precondition import Factorization

            return Factorization(self.rhs, c.preconditioner)
        if c.preconditioner in ("p-mg", "fv-mg"):
            from .precondition import Multigrid

            return Multigrid.for_geometry(
                self.geom,
                kind=c.preconditioner,
                num_levels=c.num_mg_levels,
                num_pre_smoothe=c.num_pre_smoothe,
                num_post_smoothe=c.num_post_smoothe,
                pseudo_cfl=c.pseudo_cfl,
                smoother=c.mg_smoother,
                solve_coarsest=c.mg_solve_coarsest,
                spectral_radii=c.exp_smoothe_spectral_radii,
            )
        raise ValueError(
            f"Preconditioner '{c.preconditioner}' is not available for this configuration "
            "(the reference gates all preconditioning off; here none/lu/ilu work everywhere "
            "and p-mg/fv-mg on every model family)"
        )

    def _create_integrator(self):
        c = self.config
        name = c.time_integrator.lower()
        common = dict(verbose=c.verbose_solver, preconditioner=self._create_preconditioner())
        if name == "euler1":
            return Euler1(self.rhs, **common)
        if name == "tvdrk3":
            if self._shard_maker is not None:
                from .parallel.mesh import ShardMapTvdrk3

                return ShardMapTvdrk3(self._shard_maker, **common)
            return Tvdrk3(self.rhs, **common)
        if name.startswith("epi_stiff"):
            order = int(name.removeprefix("epi_stiff"))
            return EpiStiff(self.rhs, order, tolerance=c.tolerance,
                            exponential_solver=c.exponential_solver,
                            krylov_size=max(c.krylov_size, 1), **common)
        if name.startswith("srerk"):
            order = int(name.removeprefix("srerk"))
            return Srerk(self.rhs, order, tolerance=c.tolerance,
                         exponential_solver=c.exponential_solver,
                         krylov_size=max(c.krylov_size, 1), **common)
        if name.startswith("epi"):
            order = int(name.removeprefix("epi"))
            # Reference simulation.py:345 bootstraps multistep EPI with 10
            # Epi2 substeps for the first step(s).
            return Epi(self.rhs, order, tolerance=c.tolerance,
                       exponential_solver=c.exponential_solver,
                       krylov_size=max(c.krylov_size, 1),
                       init_substeps=(10 if order >= 3 else 1),
                       rhs32=self.rhs32, **common)
        if name == "ros2":
            return Ros2(self.rhs, tolerance=c.tolerance, gmres_restart=c.gmres_restart,
                        linear_solver=c.linear_solver, rhs32=self.rhs32, **common)
        if name == "rosexp2":
            from .integrators import RosExp2

            return RosExp2(self.rhs, self.rhs, tolerance=c.tolerance, restart=c.gmres_restart, **common)
        if name == "sdirk":
            from .integrators import SdirkLstable

            return SdirkLstable(self.rhs, tolerance=c.tolerance, **common)
        if name in ("imex2", "partrosexp2") or name.startswith("strang_"):
            # These need a stiff/nonstiff RHS split; the reference's split SW
            # RHS (rhs_sw_stiff/nonstiff) is legacy-layout dead code not wired
            # into its selector either (rhs_selector.py:36-37 raises there).
            # The integrators themselves (integrators/hybrid.py, splitting.py)
            # are available for user-provided splits.
            raise ValueError(
                f"Integrator {name} requires a partitioned (implicit/explicit) RHS, "
                "which is not available for the built-in models"
            )
        if name == "crank_nicolson":
            return CrankNicolson(self.rhs, tolerance=c.tolerance, **common)
        if name == "bdf2":
            return Bdf2(self.rhs, tolerance=c.tolerance, **common)
        if name == "backward_euler":
            return BackwardEuler(self.rhs, tolerance=c.tolerance, **common)
        raise ValueError(f"Unrecognized time integrator: {c.time_integrator}")

    # ------------------------------------------------------------------
    def step(self, q, step_id: int, t: float):
        """One step: dt clamp near t_end, integrator, NaN guard, outputs.
        Returns (q_new, new_time)."""
        c = self.config
        dt = min(c.dt, c.t_end - t) if c.t_end > t else c.dt
        t0 = time.time()
        q = self.integrator.step(q, dt)
        solve_time = time.time() - t0
        if self.apply_filters is not None:
            q = self.apply_filters(q, dt)

        if self.post_step_hook is not None:
            q = self.post_step_hook(q, t + dt)

        if not bool(jnp.all(jnp.isfinite(q))):
            raise RuntimeError(f"NaN/Inf detected in state after step {step_id}")

        self.output.step(q, step_id, t + dt)
        self.output.store_solver_stats(step_id, self.integrator.solver_info, solve_time)
        self._maybe_sample_rhs_timing(q, step_id)
        return q, t + dt

    def _maybe_sample_rhs_timing(self, q, step_id: int) -> None:
        c = self.config
        if (
            c.rhs_timing_freq > 0
            and c.store_solver_stats
            and step_id % c.rhs_timing_freq == 0
        ):
            from .output.rhs_timing import make_stage_probes, sample

            if self._rhs_probes is None:
                self._rhs_probes = make_stage_probes(
                    self.geom, self.ops, self.topology, self.rhs, q, c.equations
                )
            self.output.store_rhs_timing(step_id, sample(self._rhs_probes))

    def _chunk_len(self, step_id: int, t: float) -> int:
        """How many equal-dt steps may run as one device chunk from
        ``step_id``: bounded by `device_step_chunk`, the next step that owes
        an output/checkpoint/stats event, and the last full-dt step before
        the t_end clamp. Returns 1 when chunking is off or unusable."""
        c = self.config
        chunk = getattr(c, "device_step_chunk", 1)
        if (
            chunk <= 1
            or self.apply_filters is not None
            or self.post_step_hook is not None
            or not hasattr(self.integrator, "steps_device")
        ):
            return 1
        full_dt_steps = int(math.floor((c.t_end - t) / c.dt + 1e-10))
        n = min(chunk, max(full_dt_steps, 1))
        freqs = [c.output_freq, c.save_state_freq, c.stat_freq]
        if c.store_solver_stats and c.rhs_timing_freq > 0:
            freqs.append(c.rhs_timing_freq)
        for f in freqs:
            if f > 0:
                n = min(n, (step_id // f + 1) * f - step_id)
        return max(n, 1)

    def run(self):
        c = self.config
        q = self.initial_q
        t = self.starting_step * c.dt
        step_id = self.starting_step
        num_steps = int(math.ceil((c.t_end - t) / c.dt)) if c.t_end > t else 0

        from .parallel.distributed import primary_print

        t_start = time.time()
        self.output.step(q, step_id, t)  # initial output
        while t < c.t_end - 1e-10:
            n = self._chunk_len(step_id, t)
            if n > 1:
                # Chunked device stepping (device_step_chunk): n equal steps
                # per dispatch; the NaN guard/outputs/stats land at the
                # chunk boundary (chosen so no configured event is skipped).
                t0 = time.time()
                q = self.integrator.steps_device(q, c.dt, n)
                solve_time = time.time() - t0
                step_id += n
                t += n * c.dt
                if not bool(jnp.all(jnp.isfinite(q))):
                    raise RuntimeError(f"NaN/Inf detected in state after step {step_id}")
                self.output.step(q, step_id, t)
                self.output.store_solver_stats(step_id, self.integrator.solver_info, solve_time)
                self._maybe_sample_rhs_timing(q, step_id)
            else:
                step_id += 1
                q, t = self.step(q, step_id, t)
            if c.verbose_solver > 0 or step_id % max(1, num_steps // 10) == 0:
                primary_print(f"Step {step_id}/{self.starting_step + num_steps} (t = {t:.1f} s)", flush=True)
        self.output.finalize(total_time=time.time() - t_start)
        return q
