"""Explicit shard_map + ppermute shallow-water step (panel-per-device).

The GSPMD path (models/shallow_water.py under jit-with-sharding) is the
general, correctness-first distribution: halo gathers lower to whatever
collectives XLA picks. This module is the hand-scheduled hot path for the
canonical 6-device layout (one cubed-sphere panel per device, the
reference's one-rank-per-panel configuration): the whole RHS runs inside
``jax.shard_map`` over a ``('panel',)`` mesh and the halo exchange is FOUR
``lax.ppermute`` collectives — one per *send side*, which makes each
transfer a true permutation (a receive-side organization would not be:
four panels all receive their south halo from panel 5).

Panel-edge geometry (which neighbor, flipped or not, which 2x2 basis
rotation) is baked into per-panel constant arrays sharded over the panel
axis, so the kernel body is uniform code with branchless masked selects —
no data-dependent control flow under jit.

Issued before the interior flux GEMMs, the ppermutes overlap with interior
compute under XLA's latency-hiding scheduler — the reference's
start_communication / interior / end_communication overlap
(rhs/rhs.py:94-105) expressed with JAX collectives.
"""

from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..common.constants import GRAVITY
from ..geometry.cubed_sphere import CubedSphere2D
from ..geometry.metric import Metric2D
from ..ops.dfr import DFROperators
from .topology import EAST, NORTH, SOUTH, WEST, CubedSphereTopology

IDX_H, IDX_HU1, IDX_HU2 = 0, 1, 2


def _edge_coloring(edges):
    """Proper 4-edge-coloring of the (4-regular, octahedral) panel adjacency
    graph: 12 undirected panel-edges into 4 perfect matchings, so each
    exchange round is an involutive permutation over the 'panel' axis."""
    undirected = []
    seen = set()
    for p in range(6):
        for d in range(4):
            q, e = edges[p][d].neighbor, edges[p][d].neighbor_side
            key = frozenset([(p, d), (q, e)])
            if key not in seen:
                seen.add(key)
                undirected.append(((p, d), (q, e)))
    assert len(undirected) == 12

    colors = {}

    def free(p, c):
        return all(colors.get(i) != c for i, ((a, _), (b, _)) in enumerate(undirected) if p in (a, b))

    def solve(i):
        if i == len(undirected):
            return True
        (a, _), (b, _) = undirected[i]
        for c in range(4):
            if free(a, c) and free(b, c):
                colors[i] = c
                if solve(i + 1):
                    return True
                del colors[i]
        return False

    assert solve(0), "edge coloring failed"
    return undirected, colors


def _build_edge_tables(topology: CubedSphereTopology):
    """Static per-panel tables driving the uniform shard kernel.

    perms[c]            : ppermute pairs of exchange round (color) c
    side_onehot[p,c,d]  : 1.0 if p's color-c edge uses its side d
    flip[p, d]          : 1.0 if the incoming side-d trace must be reversed
    conv[p, d]          : (npts, 2, 2) basis rotation for incoming vectors
    """
    edges = topology.edges
    npts = topology.num_points
    undirected, colors = _edge_coloring(edges)

    partner = [[None] * 4 for _ in range(6)]  # partner[p][c] = q
    side_onehot = np.zeros((6, 4, 4))
    for i, ((p, d), (q, e)) in enumerate(undirected):
        c = colors[i]
        partner[p][c] = q
        partner[q][c] = p
        side_onehot[p, c, d] = 1.0
        side_onehot[q, c, e] = 1.0
    perms = [[(p, partner[p][c]) for p in range(6)] for c in range(4)]

    flip = np.zeros((6, 4))
    conv = np.zeros((6, 4, npts, 2, 2))
    for p in range(6):
        for d in range(4):
            flip[p, d] = 1.0 if edges[p][d].flip else 0.0
            conv[p, d] = edges[p][d].conv_contra
    return perms, side_onehot, flip, conv


def make_shard_map_sw_step(
    geom: CubedSphere2D,
    ops: DFROperators,
    metric: Metric2D,
    mesh: Mesh,
    dt: float,
    dtype=jnp.float64,
) -> Callable:
    """Jitted TVD-RK3 step with the RHS fully inside shard_map.

    `mesh` must have a 'panel' axis of size 6 (panel-per-device). Returns
    (step, sharding): call `step(q_sharded)`; q has the usual global layout
    (3, 6, ny, nx, s^2) placed with the returned NamedSharding.
    """
    if mesh.shape["panel"] != 6:
        raise ValueError("shard_map SW path requires a 6-way 'panel' mesh axis")

    s = ops.num_solpts
    nel = geom.num_elements
    npts = nel * s
    topology = CubedSphereTopology(geom)
    perms, side_onehot_t, flip_t, conv_t = _build_edge_tables(topology)

    c = lambda a: jnp.asarray(a, dtype=dtype)

    consts = dict(
        extrap_x=c(ops.extrap_x),
        extrap_y=c(ops.extrap_z),
        derivative_x=c(ops.derivative_x),
        derivative_y=c(ops.derivative_z),
        correction_we=c(ops.correction_WE),
        correction_sn=c(ops.correction_DU),
    )

    # Per-panel fields, passed through shard_map with P('panel', ...).
    panel_fields = dict(
        sqrtG=c(metric.sqrtG),
        inv_sqrtG=c(metric.inv_sqrtG),
        h11=c(metric.H_contra_11),
        h12=c(metric.H_contra_12),
        h21=c(metric.H_contra_21),
        h22=c(metric.H_contra_22),
        sqrtG_ix=c(metric.sqrtG_itf_i[:, :, 1:, :s]),
        h11_ix=c(metric.H_contra_11_itf_i[:, :, 1:, :s]),
        h21_ix=c(metric.H_contra_21_itf_i[:, :, 1:, :s]),
        sqrtG_jx=c(metric.sqrtG_itf_j[:, 1:, :, :s]),
        h12_jx=c(metric.H_contra_12_itf_j[:, 1:, :, :s]),
        h22_jx=c(metric.H_contra_22_itf_j[:, 1:, :, :s]),
        chr_1_01=c(metric.christoffel_1_01),
        chr_1_02=c(metric.christoffel_1_02),
        chr_2_01=c(metric.christoffel_2_01),
        chr_2_02=c(metric.christoffel_2_02),
        chr_1_11=c(metric.christoffel_1_11),
        chr_1_12=c(metric.christoffel_1_12),
        chr_2_12=c(metric.christoffel_2_12),
        chr_2_22=c(metric.christoffel_2_22),
        side_onehot=jnp.asarray(side_onehot_t, dtype=dtype),
        flip=jnp.asarray(flip_t, dtype=dtype),
        conv=jnp.asarray(conv_t, dtype=dtype),
    )

    def ausm_flux(qL, qR, sqrtG_itf, h_diag, h_off, normal):
        hL, hR = qL[IDX_H], qR[IDX_H]
        aL = jnp.sqrt(GRAVITY * hL * h_diag)
        aR = jnp.sqrt(GRAVITY * hR * h_diag)
        mL = jnp.where(hL * aL != 0.0, qL[normal] / (hL * aL), 0.0)
        mR = jnp.where(hR * aR != 0.0, qR[normal] / (hR * aR), 0.0)
        big_m = 0.25 * ((mL + 1.0) ** 2 - (mR - 1.0) ** 2)
        flux = sqrtG_itf * (jnp.maximum(0.0, big_m) * aL * qL + jnp.minimum(0.0, big_m) * aR * qR)
        half_g = 0.5 * GRAVITY
        pd = 0.5 * ((1.0 + mL) * sqrtG_itf * half_g * h_diag * hL**2 + (1.0 - mR) * sqrtG_itf * half_g * h_diag * hR**2)
        po = 0.5 * ((1.0 + mL) * sqrtG_itf * half_g * h_off * hL**2 + (1.0 - mR) * sqrtG_itf * half_g * h_off * hR**2)
        rows = (IDX_HU1, IDX_HU2) if normal == IDX_HU1 else (IDX_HU2, IDX_HU1)
        flux = flux.at[rows[0]].add(pd)
        flux = flux.at[rows[1]].add(po)
        return flux

    def local_rhs(q, f):
        """RHS body for ONE panel. q: (3, ny, nx, s^2); f: per-panel consts."""
        h = q[IDX_H]
        hu1 = q[IDX_HU1]
        hu2 = q[IDX_HU2]
        u1 = hu1 / h
        u2 = hu2 / h

        itf_x = q @ consts["extrap_x"]  # (3, ny, nx, 2s)
        itf_y = q @ consts["extrap_y"]

        # ---- Halo exchange: four edge-colored ppermute rounds (each an
        # involutive permutation), issued first so the transfers overlap the
        # interior GEMMs below. Each round, a panel exchanges across the one
        # edge of that color; the per-panel one-hot picks which side.
        traces = jnp.stack(
            [
                itf_y[..., 0, :, :s].reshape(3, npts),  # SOUTH
                itf_y[..., -1, :, s:].reshape(3, npts),  # NORTH
                itf_x[..., :, 0, :s].reshape(3, npts),  # WEST
                itf_x[..., :, -1, s:].reshape(3, npts),  # EAST
            ]
        )  # (4, 3, npts)
        received = [
            jax.lax.ppermute(
                jnp.tensordot(f["side_onehot"][c], traces, axes=1), "panel", perms[c]
            )
            for c in range(4)
        ]

        # ---- Interior pointwise fluxes + derivative GEMMs (overlap window).
        hsq = h * h
        fx = jnp.stack([
            f["sqrtG"] * hu1,
            f["sqrtG"] * (hu1 * u1 + 0.5 * GRAVITY * f["h11"] * hsq),
            f["sqrtG"] * (hu2 * u1 + 0.5 * GRAVITY * f["h21"] * hsq),
        ])
        fy = jnp.stack([
            f["sqrtG"] * hu2,
            f["sqrtG"] * (hu1 * u2 + 0.5 * GRAVITY * f["h12"] * hsq),
            f["sqrtG"] * (hu2 * u2 + 0.5 * GRAVITY * f["h22"] * hsq),
        ])
        df1 = fx @ consts["derivative_x"]
        df2 = fy @ consts["derivative_y"]

        # ---- Route received buffers to local sides, flip, rotate.
        def halo_for(d):
            buf = sum(f["side_onehot"][c, d] * received[c] for c in range(4))
            flipped = jnp.where(f["flip"][d] > 0.5, buf[:, ::-1], buf)
            cmat = f["conv"][d]  # (npts, 2, 2)
            b1 = cmat[:, 0, 0] * flipped[IDX_HU1] + cmat[:, 0, 1] * flipped[IDX_HU2]
            b2 = cmat[:, 1, 0] * flipped[IDX_HU1] + cmat[:, 1, 1] * flipped[IDX_HU2]
            return jnp.stack([flipped[IDX_H], b1, b2])

        halo_w = halo_for(WEST).reshape(3, nel, 1, s)
        halo_e = halo_for(EAST).reshape(3, nel, 1, s)
        halo_s = halo_for(SOUTH).reshape(3, 1, nel, s)
        halo_n = halo_for(NORTH).reshape(3, 1, nel, s)

        # ---- Per-interface AUSM fluxes + correction GEMMs.
        qL_x = jnp.concatenate([halo_w, itf_x[..., s:]], axis=-2)
        qR_x = jnp.concatenate([itf_x[..., :s], halo_e], axis=-2)
        qL_y = jnp.concatenate([halo_s, itf_y[..., s:]], axis=-3)
        qR_y = jnp.concatenate([itf_y[..., :s], halo_n], axis=-3)

        f_x = ausm_flux(qL_x, qR_x, f["sqrtG_ix"], f["h11_ix"], f["h21_ix"], IDX_HU1)
        f_y = ausm_flux(qL_y, qR_y, f["sqrtG_jx"], f["h22_jx"], f["h12_jx"], IDX_HU2)

        faces_x = jnp.concatenate([f_x[..., :-1, :], f_x[..., 1:, :]], axis=-1)
        faces_y = jnp.concatenate([f_y[..., :-1, :, :], f_y[..., 1:, :, :]], axis=-1)
        df1 = df1 + faces_x @ consts["correction_we"]
        df2 = df2 + faces_y @ consts["correction_sn"]

        forcing_1 = (
            2.0 * (f["chr_1_01"] * hu1 + f["chr_1_02"] * hu2)
            + f["chr_1_11"] * hu1 * u1
            + 2.0 * f["chr_1_12"] * hu1 * u2
        )
        forcing_2 = (
            2.0 * (f["chr_2_01"] * hu1 + f["chr_2_02"] * hu2)
            + 2.0 * f["chr_2_12"] * hu1 * u2
            + f["chr_2_22"] * hu2 * u2
        )
        forcing = jnp.stack([jnp.zeros_like(forcing_1), forcing_1, forcing_2])
        return f["inv_sqrtG"] * (-df1 - df2) - forcing

    field_names = list(panel_fields.keys())
    field_values = [panel_fields[k] for k in field_names]
    # Metric/routing constants are per-panel: shard their leading axis.
    field_specs = [P("panel") for _ in field_names]

    state_spec = P(None, "panel", None, None, None)

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(state_spec, *field_specs),
        out_specs=state_spec,
    )
    def shard_step(q, *fields):
        f = dict(zip(field_names, [x[0] for x in fields]))  # drop the local panel axis
        q = q[:, 0]  # (3, ny, nx, s^2) local panel

        def rhs(qq):
            return local_rhs(qq, f)

        dt_ = jnp.asarray(dt, dtype=dtype)
        q1 = q + rhs(q) * dt_
        q2 = 0.75 * q + 0.25 * (q1 + rhs(q1) * dt_)
        q3 = q / 3.0 + 2.0 / 3.0 * (q2 + rhs(q2) * dt_)
        return q3[:, None]

    sharding = NamedSharding(mesh, state_spec)

    @jax.jit
    def step(q):
        return shard_step(q, *field_values)

    return step, sharding


# ---------------------------------------------------------------------------
# General 6*N^2 decomposition: mesh ('panel', 'y', 'x') with y == x == N,
# each device owning an (nel/N, nel/N)-element tile — the reference's
# one-rank-per-tile strategy (process_topology.py:69-94) as a device mesh.
#
# Halo exchange = EIGHT lax.ppermute rounds over the flattened mesh:
#   * four interior rounds, one per send side — cyclic shifts along the
#     'y'/'x' mesh axes (a tile receives, in round d, the side-d trace of
#     its opposite-d neighbour = its opp(d) halo). Panel-edge tiles receive
#     an in-panel wrap value that the masks below discard.
#   * four panel-edge rounds, one per color of the octahedral panel-edge
#     coloring (reused from the 6-device path): the tiles along panel p's
#     color-c edge pair 1:1 with the tiles along the partner edge (index
#     order reversed when the edge is flipped) — a partial permutation.
# Per-tile one-hot route/flip tables make the assembly branchless.


def _tile_index(p, ty, tx, n):
    return (p * n + ty) * n + tx


def _build_tile_tables(topology: CubedSphereTopology, n: int, s: int):
    """Permutations + per-tile routing tables for the 6*N^2 decomposition."""
    edges = topology.edges
    undirected, colors = _edge_coloring(edges)
    partner = {}
    for i, ((p, d), (q, e)) in enumerate(undirected):
        c = colors[i]
        partner[(p, c)] = (q, e, d)
        partner[(q, c)] = (p, d, e)

    ntile = 6 * n * n

    # Interior shift rounds (send side d): full cyclic permutations.
    # Order matches SOUTH, NORTH, WEST, EAST = 0..3.
    shift_perms = []
    for _d, (dy, dx) in ((SOUTH, (-1, 0)), (NORTH, (1, 0)), (WEST, (0, -1)), (EAST, (0, 1))):
        perm = []
        for p in range(6):
            for ty in range(n):
                for tx in range(n):
                    perm.append((
                        _tile_index(p, ty, tx, n),
                        _tile_index(p, (ty + dy) % n, (tx + dx) % n, n),
                    ))
        shift_perms.append(perm)

    # Which tiles sit on a panel edge of side d.
    def edge_tiles(p, d):
        if d == SOUTH:
            return [(p, 0, tx) for tx in range(n)]
        if d == NORTH:
            return [(p, n - 1, tx) for tx in range(n)]
        if d == WEST:
            return [(p, ty, 0) for ty in range(n)]
        return [(p, ty, n - 1) for ty in range(n)]

    # Panel-edge color rounds: partial permutations (non-edge tiles excluded).
    color_perms = [[] for _ in range(4)]
    # onehot_send[p, ty, tx, c, d]: tile sends its side-d trace in round c.
    onehot_send = np.zeros((6, n, n, 4, 4))
    # route[p, ty, tx, d] in {0..7}: which round supplies the side-d halo
    # (0..3 = interior round for the OPPOSITE side; 4+c = edge round c).
    opp = {SOUTH: NORTH, NORTH: SOUTH, WEST: EAST, EAST: WEST}
    route = np.zeros((6, n, n, 4), np.int64)
    for p in range(6):
        for ty in range(n):
            for tx in range(n):
                for d in range(4):
                    route[p, ty, tx, d] = opp[d]
    for c in range(4):
        seen_pairs = set()
        for p in range(6):
            q, e, d = partner[(p, c)]
            mine = edge_tiles(p, d)
            theirs = edge_tiles(q, e)
            if edges[p][d].flip:
                theirs = theirs[::-1]
            for (pp, ty, tx), (qq, uy, ux) in zip(mine, theirs):
                onehot_send[pp, ty, tx, c, d] = 1.0
                route[pp, ty, tx, d] = 4 + c
                key = (min((pp, ty, tx), (qq, uy, ux)), max((pp, ty, tx), (qq, uy, ux)))
                if key not in seen_pairs:
                    seen_pairs.add(key)
                    a = _tile_index(pp, ty, tx, n)
                    b = _tile_index(qq, uy, ux, n)
                    color_perms[c].append((a, b))
                    if a != b:
                        color_perms[c].append((b, a))

    # Flip + basis-rotation tables, sliced to each tile's boundary segment.
    npts_t = (topology.num_points // n)
    flip = np.zeros((6, n, n, 4))
    conv = np.zeros((6, n, n, 4, npts_t, 2, 2))
    conv[..., 0, 0] = 1.0
    conv[..., 1, 1] = 1.0
    for p in range(6):
        for d in range(4):
            for i, (pp, ty, tx) in enumerate(edge_tiles(p, d)):
                flip[pp, ty, tx, d] = 1.0 if edges[p][d].flip else 0.0
                conv[pp, ty, tx, d] = edges[p][d].conv_contra[i * npts_t : (i + 1) * npts_t]
    return shift_perms, color_perms, onehot_send, route, flip, conv


def make_shard_map_sw_step_general(
    geom: CubedSphere2D,
    ops: DFROperators,
    metric: Metric2D,
    mesh: Mesh,
    dt: float,
    dtype=jnp.float64,
) -> Callable:
    """Jitted TVD-RK3 step over a ('panel', 'y', 'x') mesh of 6*N*N devices
    (N = mesh.shape['y'] == mesh.shape['x'], N | nel). Returns
    (step, sharding) like make_shard_map_sw_step."""
    n = mesh.shape["y"]
    if mesh.shape["panel"] != 6 or mesh.shape["x"] != n:
        raise ValueError("general shard_map SW path needs a (6, N, N) mesh")
    s = ops.num_solpts
    nel = geom.num_elements
    if nel % n:
        raise ValueError(f"nel={nel} not divisible by mesh N={n}")
    nt = nel // n  # elements per tile per direction
    npts_t = nt * s
    topology = CubedSphereTopology(geom)
    shift_perms, color_perms, onehot_send, route, flip_t, conv_t = _build_tile_tables(
        topology, n, s
    )
    axes = ("panel", "y", "x")

    c = lambda a: jnp.asarray(a, dtype=dtype)
    consts = dict(
        extrap_x=c(ops.extrap_x), extrap_y=c(ops.extrap_z),
        derivative_x=c(ops.derivative_x), derivative_y=c(ops.derivative_z),
        correction_we=c(ops.correction_WE), correction_sn=c(ops.correction_DU),
    )

    def tiled(a):
        """(6, nel, nel, ...) -> (6, n, nt, n, nt, ...) tile-blocked view."""
        a = np.asarray(a, np.float64)
        return a.reshape((6, n, nt, n, nt) + a.shape[3:])

    def tiled_itf_i(a):
        """(6, nel, nel+1, s) x1-interface field -> per-tile (nt, nt+1, s)
        with shared interface columns duplicated."""
        a = np.asarray(a, np.float64)
        out = np.zeros((6, n, n, nt, nt + 1, s))
        for ty in range(n):
            for tx in range(n):
                out[:, ty, tx] = a[:, ty * nt : (ty + 1) * nt, tx * nt : tx * nt + nt + 1]
        return out

    def tiled_itf_j(a):
        a = np.asarray(a, np.float64)
        out = np.zeros((6, n, n, nt + 1, nt, s))
        for ty in range(n):
            for tx in range(n):
                out[:, ty, tx] = a[:, ty * nt : ty * nt + nt + 1, tx * nt : (tx + 1) * nt]
        return out

    bulk = lambda name: c(np.moveaxis(tiled(getattr(metric, name)), 3, 2))  # (6,n,n,nt,nt,s2)
    panel_fields = dict(
        sqrtG=bulk("sqrtG"), inv_sqrtG=bulk("inv_sqrtG"),
        h11=bulk("H_contra_11"), h12=bulk("H_contra_12"),
        h21=bulk("H_contra_21"), h22=bulk("H_contra_22"),
        chr_1_01=bulk("christoffel_1_01"), chr_1_02=bulk("christoffel_1_02"),
        chr_2_01=bulk("christoffel_2_01"), chr_2_02=bulk("christoffel_2_02"),
        chr_1_11=bulk("christoffel_1_11"), chr_1_12=bulk("christoffel_1_12"),
        chr_2_12=bulk("christoffel_2_12"), chr_2_22=bulk("christoffel_2_22"),
        sqrtG_ix=c(tiled_itf_i(np.asarray(metric.sqrtG_itf_i)[:, :, 1:, :s])),
        h11_ix=c(tiled_itf_i(np.asarray(metric.H_contra_11_itf_i)[:, :, 1:, :s])),
        h21_ix=c(tiled_itf_i(np.asarray(metric.H_contra_21_itf_i)[:, :, 1:, :s])),
        sqrtG_jx=c(tiled_itf_j(np.asarray(metric.sqrtG_itf_j)[:, 1:, :, :s])),
        h12_jx=c(tiled_itf_j(np.asarray(metric.H_contra_12_itf_j)[:, 1:, :, :s])),
        h22_jx=c(tiled_itf_j(np.asarray(metric.H_contra_22_itf_j)[:, 1:, :, :s])),
        onehot_send=jnp.asarray(onehot_send, dtype=dtype),
        route=jnp.asarray(
            np.eye(8)[route], dtype=dtype
        ),  # (6, n, n, 4, 8) one-hot round selector
        flip=jnp.asarray(flip_t, dtype=dtype),
        conv=jnp.asarray(conv_t, dtype=dtype),
    )

    def ausm_flux(qL, qR, sqrtG_itf, h_diag, h_off, normal):
        hL, hR = qL[IDX_H], qR[IDX_H]
        aL = jnp.sqrt(GRAVITY * hL * h_diag)
        aR = jnp.sqrt(GRAVITY * hR * h_diag)
        mL = jnp.where(hL * aL != 0.0, qL[normal] / (hL * aL), 0.0)
        mR = jnp.where(hR * aR != 0.0, qR[normal] / (hR * aR), 0.0)
        big_m = 0.25 * ((mL + 1.0) ** 2 - (mR - 1.0) ** 2)
        flux = sqrtG_itf * (jnp.maximum(0.0, big_m) * aL * qL + jnp.minimum(0.0, big_m) * aR * qR)
        half_g = 0.5 * GRAVITY
        pd = 0.5 * ((1.0 + mL) * sqrtG_itf * half_g * h_diag * hL**2
                    + (1.0 - mR) * sqrtG_itf * half_g * h_diag * hR**2)
        po = 0.5 * ((1.0 + mL) * sqrtG_itf * half_g * h_off * hL**2
                    + (1.0 - mR) * sqrtG_itf * half_g * h_off * hR**2)
        rows = (IDX_HU1, IDX_HU2) if normal == IDX_HU1 else (IDX_HU2, IDX_HU1)
        return flux.at[rows[0]].add(pd).at[rows[1]].add(po)

    def local_rhs(q, f):
        """RHS body for ONE tile. q: (3, nt, nt, s^2)."""
        h, hu1, hu2 = q[IDX_H], q[IDX_HU1], q[IDX_HU2]
        u1, u2 = hu1 / h, hu2 / h

        itf_x = q @ consts["extrap_x"]
        itf_y = q @ consts["extrap_y"]

        traces = jnp.stack(
            [
                itf_y[..., 0, :, :s].reshape(3, npts_t),  # SOUTH
                itf_y[..., -1, :, s:].reshape(3, npts_t),  # NORTH
                itf_x[..., :, 0, :s].reshape(3, npts_t),  # WEST
                itf_x[..., :, -1, s:].reshape(3, npts_t),  # EAST
            ]
        )  # (4, 3, npts_t)

        # Eight rounds, issued before the interior GEMMs (overlap window).
        rounds = [jax.lax.ppermute(traces[d], axes, shift_perms[d]) for d in range(4)]
        rounds += [
            jax.lax.ppermute(
                jnp.tensordot(f["onehot_send"][c], traces, axes=1), axes, color_perms[c]
            )
            for c in range(4)
        ]
        received = jnp.stack(rounds)  # (8, 3, npts_t)

        hsq = h * h
        fx = jnp.stack([
            f["sqrtG"] * hu1,
            f["sqrtG"] * (hu1 * u1 + 0.5 * GRAVITY * f["h11"] * hsq),
            f["sqrtG"] * (hu2 * u1 + 0.5 * GRAVITY * f["h21"] * hsq),
        ])
        fy = jnp.stack([
            f["sqrtG"] * hu2,
            f["sqrtG"] * (hu1 * u2 + 0.5 * GRAVITY * f["h12"] * hsq),
            f["sqrtG"] * (hu2 * u2 + 0.5 * GRAVITY * f["h22"] * hsq),
        ])
        df1 = fx @ consts["derivative_x"]
        df2 = fy @ consts["derivative_y"]

        def halo_for(d):
            buf = jnp.tensordot(f["route"][d], received, axes=1)  # (3, npts_t)
            flipped = jnp.where(f["flip"][d] > 0.5, buf[:, ::-1], buf)
            cmat = f["conv"][d]
            b1 = cmat[:, 0, 0] * flipped[IDX_HU1] + cmat[:, 0, 1] * flipped[IDX_HU2]
            b2 = cmat[:, 1, 0] * flipped[IDX_HU1] + cmat[:, 1, 1] * flipped[IDX_HU2]
            return jnp.stack([flipped[IDX_H], b1, b2])

        halo_w = halo_for(WEST).reshape(3, nt, 1, s)
        halo_e = halo_for(EAST).reshape(3, nt, 1, s)
        halo_s = halo_for(SOUTH).reshape(3, 1, nt, s)
        halo_n = halo_for(NORTH).reshape(3, 1, nt, s)

        qL_x = jnp.concatenate([halo_w, itf_x[..., s:]], axis=-2)
        qR_x = jnp.concatenate([itf_x[..., :s], halo_e], axis=-2)
        qL_y = jnp.concatenate([halo_s, itf_y[..., s:]], axis=-3)
        qR_y = jnp.concatenate([itf_y[..., :s], halo_n], axis=-3)

        f_x = ausm_flux(qL_x, qR_x, f["sqrtG_ix"], f["h11_ix"], f["h21_ix"], IDX_HU1)
        f_y = ausm_flux(qL_y, qR_y, f["sqrtG_jx"], f["h22_jx"], f["h12_jx"], IDX_HU2)

        faces_x = jnp.concatenate([f_x[..., :-1, :], f_x[..., 1:, :]], axis=-1)
        faces_y = jnp.concatenate([f_y[..., :-1, :, :], f_y[..., 1:, :, :]], axis=-1)
        df1 = df1 + faces_x @ consts["correction_we"]
        df2 = df2 + faces_y @ consts["correction_sn"]

        forcing_1 = (
            2.0 * (f["chr_1_01"] * hu1 + f["chr_1_02"] * hu2)
            + f["chr_1_11"] * hu1 * u1 + 2.0 * f["chr_1_12"] * hu1 * u2
        )
        forcing_2 = (
            2.0 * (f["chr_2_01"] * hu1 + f["chr_2_02"] * hu2)
            + 2.0 * f["chr_2_12"] * hu1 * u2 + f["chr_2_22"] * hu2 * u2
        )
        forcing = jnp.stack([jnp.zeros_like(forcing_1), forcing_1, forcing_2])
        return f["inv_sqrtG"] * (-df1 - df2) - forcing

    field_names = list(panel_fields.keys())
    field_values = [panel_fields[k] for k in field_names]
    field_specs = [P("panel", "y", "x") for _ in field_names]

    # State layout: the usual global (3, 6, ny, nx, s^2), sharded by element
    # blocks over (panel, y, x).
    state_spec = P(None, "panel", "y", "x", None)

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(state_spec, *field_specs),
        out_specs=state_spec,
    )
    def shard_step(q, *fields):
        f = dict(zip(field_names, [x[0, 0, 0] for x in fields]))
        q = q[:, 0]  # (3, nt, nt, s^2) local tile

        def rhs(qq):
            return local_rhs(qq, f)

        dt_ = jnp.asarray(dt, dtype=dtype)
        q1 = q + rhs(q) * dt_
        q2 = 0.75 * q + 0.25 * (q1 + rhs(q1) * dt_)
        q3 = q / 3.0 + 2.0 / 3.0 * (q2 + rhs(q2) * dt_)
        return q3[:, None]

    sharding = NamedSharding(mesh, state_spec)

    @jax.jit
    def step(q):
        return shard_step(q, *field_values)

    return step, sharding
