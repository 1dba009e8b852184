"""wxfactory_tpu: a JAX numerical weather prediction dynamical core.

A ground-up JAX/XLA re-design of the capabilities of
Wx-Alliance-Meteo/WxFactory (the reference): Direct Flux
Reconstruction (DFR) discretization of the shallow-water and 3D Euler
equations on the rotated equiangular cubed sphere (plus a 2D Cartesian test
plane), driven by exponential (EPI/SRERK) and implicit (Ros2/CN/BDF2) time
integrators built on matrix-free Krylov methods (KIOPS, PMEX, FGMRES).

Design principles (a re-design, not a port):
  * All spatial operators are batched dense matmuls.
  * The state is a single array ``Q[num_var, ...element dims..., solpts^d]``
    and every RHS is a pure jittable function ``q -> dq/dt``.
  * Distribution = sharding the (panel, row, col) element grid over a
    ``jax.sharding.Mesh``; halo exchange with panel-edge flips and vector
    basis rotation is expressed as static gathers that XLA lowers to
    collectives (explicit shard_map/ppermute path for the hot configuration).
  * Jacobian action = ``jax.jvp`` (exact forward-mode) instead of the
    reference's complex-step trick (solvers/matvec.py:36-68 there).
  * Operator matrices are built on host (exact rational arithmetic + numpy)
    at setup time and closed over as compile-time constants.
"""

import os

import jax

# The reference framework is float64 throughout (see SURVEY.md); scientific
# parity requires x64. Opt out with WXF_DISABLE_X64=1 (e.g. for bf16 perf
# experiments driven through explicit dtype arguments).
if not os.environ.get("WXF_DISABLE_X64"):
    jax.config.update("jax_enable_x64", True)

# A GPU may run DEFAULT-precision f32 matmuls in TF32 (10-bit mantissa,
# ~1e-3 relative input rounding), which at Williamson case 6 turns the f32
# RHS into tendency-scale noise. "highest" keeps f32 products in full f32
# and is the only numerically defensible default for a weather model (f64
# products are unaffected). Override with WXF_MM_PRECISION=default/high for
# speed experiments.
jax.config.update(
    "jax_default_matmul_precision", os.environ.get("WXF_MM_PRECISION", "highest")
)

__version__ = "0.1.0"
