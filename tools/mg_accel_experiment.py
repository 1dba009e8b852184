"""Hunt for an MG configuration that STRICTLY accelerates FGMRES on a
canonical stiff solve: case5/case6 SW rational system
A = I - dt/2 J at the canonical shape, iterations-to-tol with and without
the V-cycle preconditioner, over smoother / pseudo_cfl / level settings."""

import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from wxfactory_tpu.geometry import make_cubed_sphere_2d, make_metric_2d
from wxfactory_tpu.models import make_rhs_shallow_water
from wxfactory_tpu.ops.dfr import make_dfr_operators
from wxfactory_tpu.precondition import Multigrid
from wxfactory_tpu.solvers import fgmres
from wxfactory_tpu.testcases import williamson_case5, williamson_case6


def setup(case, nel, s):
    geom = make_cubed_sphere_2d(nel, s)
    ops = make_dfr_operators(s)
    metric = make_metric_2d(geom)
    if case == 5:
        q0, topo = williamson_case5(geom, ops)
        rhs = make_rhs_shallow_water(geom, ops, metric, topo=topo)
        q = jnp.asarray(q0)
    else:
        rhs = make_rhs_shallow_water(geom, ops, metric)
        q = jnp.asarray(williamson_case6(geom))
    return geom, rhs, q


def solve_iters(rhs, q, dt, tol, mg=None, restart=100, maxiter=3):
    shape = q.shape
    jvp = jax.jit(lambda v: jax.jvp(rhs, (q,), (v,))[1])

    def apply_A(v):
        vq = jnp.asarray(v.reshape(shape))
        return np.asarray(vq - 0.5 * dt * jvp(vq)).ravel()

    b = np.asarray(rhs(q)).ravel() * dt
    t0 = time.perf_counter()
    _, r, _, it, _, _ = fgmres(apply_A, b, tol=tol, restart=restart, maxiter=maxiter,
                               preconditioner=mg)
    return it, r, time.perf_counter() - t0


def main():
    case = int(sys.argv[1]) if len(sys.argv) > 1 else 5
    nel = int(sys.argv[2]) if len(sys.argv) > 2 else 10
    s = int(sys.argv[3]) if len(sys.argv) > 3 else 3
    dt = float(sys.argv[4]) if len(sys.argv) > 4 else 3600.0
    tol = 1e-7

    geom, rhs, q = setup(case, nel, s)
    it0, r0, t0 = solve_iters(rhs, q, dt, tol)
    print(f"plain: iters={it0} res={r0:.3e} t={t0:.1f}s", flush=True)

    for kind in ("fv-mg", "p-mg"):
        for smoother in ("erk3", "erk1"):
            for cfl in (1.0, 3.0, 7.0):
                for npre, npost in ((2, 2), (4, 4)):
                    try:
                        mg = Multigrid.for_geometry(
                            geom, kind=kind, num_levels=3,
                            num_pre_smoothe=npre, num_post_smoothe=npost,
                            pseudo_cfl=cfl, smoother=smoother)
                        mg.prepare(dt, q)
                        it, r, t = solve_iters(rhs, q, dt, tol, mg=mg)
                        mark = " <<<" if it < it0 and r <= max(r0, tol * np.linalg.norm(np.asarray(rhs(q)).ravel() * dt)) else ""
                        print(f"{kind} {smoother} cfl={cfl} pre/post={npre}/{npost}: "
                              f"iters={it} res={r:.3e} t={t:.1f}s{mark}", flush=True)
                    except Exception as e:
                        print(f"{kind} {smoother} cfl={cfl} {npre}/{npost}: FAILED {type(e).__name__}: {e}",
                              flush=True)


if __name__ == "__main__":
    main()
