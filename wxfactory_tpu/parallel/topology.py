"""Cubed-sphere panel topology and halo exchange.

Capability parity with the reference's process_topology.py (ProcessTopology:
panel adjacency, edge flips, contravariant/covariant vector conversion at
panel edges, halo exchange of interface traces).

Design — two departures from the reference:

1. **No ranks.** State is global, ``(nvar, 6, ny, nx, ...)``. The "exchange"
   is a pure function: for each of the 24 (panel, side) pairs it gathers the
   neighbor panel's boundary trace, flips it if the coordinate runs opposite,
   and rotates vector components into the local panel basis. Under ``jit``
   with the state sharded over (panel, y, x), XLA GSPMD lowers these static
   gathers to collective-permutes; on one device they are cheap
   copies. The reference's ``Ineighbor_alltoall`` + rank bookkeeping
   (process_topology.py:258-320) disappears entirely, as do gather_cube /
   distribute_cube (the global array IS the cube).

2. **Derived, not transcribed, edge tables.** The reference hand-writes the
   panel-neighbor table, the flip table and 48 per-edge conversion lambdas
   (process_topology.py:105-214). Here all of it is *derived at setup*:
   adjacency and flips by matching physical edge-point coordinates, and the
   2x2 vector-conversion matrices exactly as J_local @ J_neighbor^-1 from
   the closed-form panel Jacobians (geometry.cubed_sphere.wind_jacobian).
   This is exact (same closed forms, no finite differences) and
   self-validating: construction asserts that both panels' edge points
   coincide physically.
"""

from dataclasses import dataclass
from typing import Dict, List, Tuple

import jax.numpy as jnp
import numpy as np

from ..geometry.cubed_sphere import CubedSphere2D, gnomonic_to_cartesian, wind_jacobian

SOUTH, NORTH, WEST, EAST = 0, 1, 2, 3
_SIDE_NAMES = ("south", "north", "west", "east")


def _edge_gnomonic(geom: CubedSphere2D, side: int) -> Tuple[np.ndarray, np.ndarray]:
    """Panel-local gnomonic (X, Y) of the boundary solution points along the
    given panel side, ordered along the local edge coordinate."""
    along = np.tan(geom.x1)  # (nel * s,)
    ones = np.ones_like(along)
    if side == SOUTH:
        return along, -ones
    if side == NORTH:
        return along, ones
    if side == WEST:
        return -ones, along
    return ones, along


def _edge_xyz(geom: CubedSphere2D, panel: int, side: int) -> np.ndarray:
    """Physical unit-sphere coordinates (npts, 3) of a panel edge's boundary
    solution points, in local edge ordering."""
    X, Y = _edge_gnomonic(geom, side)
    x, y, z = gnomonic_to_cartesian(X, Y, geom.lon_p[panel], geom.lat_p[panel], geom.angle_p[panel])
    return np.stack([x, y, z], axis=-1)


def _edge_mid_xyz(geom: CubedSphere2D, panel: int, side: int) -> np.ndarray:
    """Physical coordinates of the continuous midpoint of a panel edge."""
    mids = {SOUTH: (0.0, -1.0), NORTH: (0.0, 1.0), WEST: (-1.0, 0.0), EAST: (1.0, 0.0)}
    X, Y = mids[side]
    x, y, z = gnomonic_to_cartesian(
        np.array(X), np.array(Y), geom.lon_p[panel], geom.lat_p[panel], geom.angle_p[panel]
    )
    return np.stack([x, y, z], axis=-1)


def _scaled_jacobian(X, Y, lat_p, angle_p, dx1, dx2) -> np.ndarray:
    """(npts, 2, 2) Jacobian mapping (lambda_dot, phi_dot) to reference-element
    contravariant components (u1, u2) at the given gnomonic points."""
    dx1dlon, dx1dlat, dx2dlon, dx2dlat = wind_jacobian(X, Y, lat_p, angle_p)
    row1 = np.stack([dx1dlon * 2.0 / dx1, dx1dlat * 2.0 / dx1], axis=-1)
    row2 = np.stack([dx2dlon * 2.0 / dx2, dx2dlat * 2.0 / dx2], axis=-1)
    return np.stack([row1, row2], axis=-2)


@dataclass(frozen=True)
class PanelEdge:
    """One side of one panel: who is on the other side and how their data
    maps into our coordinates."""

    neighbor: int  # neighbor panel index
    neighbor_side: int  # the neighbor's side that faces us
    flip: bool  # neighbor's edge coordinate runs opposite to ours
    conv_contra: np.ndarray  # (npts, 2, 2): neighbor contravariant -> local
    conv_cov: np.ndarray  # (npts, 2, 2): neighbor covariant -> local


class CubedSphereTopology:
    """Static panel-edge tables + the jittable halo-exchange functions."""

    def __init__(self, geom):
        """geom: CubedSphere2D or CubedSphere3D (only the horizontal panel
        structure — x1, panel rotations, delta_x — is used)."""
        self.geom = geom
        self.nel_h = getattr(geom, "num_elements", None) or geom.nel_h
        self.num_points = self.nel_h * geom.num_solpts

        # --- Derive adjacency from edge-midpoint coincidence.
        mids = np.array([[_edge_mid_xyz(geom, p, d) for d in range(4)] for p in range(6)])
        self.edges: List[List[PanelEdge]] = []
        for p in range(6):
            row = []
            for d in range(4):
                matches = [
                    (q, e)
                    for q in range(6)
                    for e in range(4)
                    if (q, e) != (p, d) and np.allclose(mids[p, d], mids[q, e], atol=1e-12)
                ]
                if len(matches) != 1:
                    raise RuntimeError(f"Panel {p} side {_SIDE_NAMES[d]}: ambiguous neighbors {matches}")
                q, e = matches[0]

                # --- Derive flip by comparing physical edge-point orderings.
                my_xyz = _edge_xyz(geom, p, d)
                nb_xyz = _edge_xyz(geom, q, e)
                if np.allclose(my_xyz, nb_xyz, atol=1e-10):
                    flip = False
                elif np.allclose(my_xyz, nb_xyz[::-1], atol=1e-10):
                    flip = True
                else:
                    raise RuntimeError(f"Panel {p}/{_SIDE_NAMES[d]} and {q}/{_SIDE_NAMES[e]} edges do not align")

                # --- Exact vector conversion: A = J_local @ J_neighbor^-1,
                # evaluated at the edge points in LOCAL ordering.
                Xl, Yl = _edge_gnomonic(geom, d)
                Xn, Yn = _edge_gnomonic(geom, e)
                if flip:
                    Xn, Yn = Xn[::-1], Yn[::-1]
                j_loc = _scaled_jacobian(Xl, Yl, geom.lat_p[p], geom.angle_p[p], geom.delta_x1, geom.delta_x2)
                j_nb = _scaled_jacobian(Xn, Yn, geom.lat_p[q], geom.angle_p[q], geom.delta_x1, geom.delta_x2)
                conv = j_loc @ np.linalg.inv(j_nb)
                conv_cov = np.linalg.inv(conv).transpose(0, 2, 1)
                row.append(PanelEdge(neighbor=q, neighbor_side=e, flip=flip, conv_contra=conv, conv_cov=conv_cov))
            self.edges.append(row)

        # --- Batched exchange tables: the 24 per-edge gathers collapse into
        # ONE take() on a stacked trace pool (sides x panels x npts), with
        # edge flips folded into the index table and the 2x2 vector
        # rotations stacked for a single vectorized multiply. This keeps the
        # halo at ~10 HLO ops instead of ~150 tiny ones (each op has a
        # fixed launch cost).
        npts = self.num_points
        src = np.empty((4, 6), dtype=np.int32)
        flips = np.empty((4, 6), dtype=bool)
        conv_c = np.empty((4, 6, npts, 2, 2))
        conv_v = np.empty((4, 6, npts, 2, 2))
        for d in range(4):
            for p in range(6):
                edge = self.edges[p][d]
                src[d, p] = edge.neighbor_side * 6 + edge.neighbor
                flips[d, p] = edge.flip
                conv_c[d, p] = edge.conv_contra
                conv_v[d, p] = edge.conv_cov
        self._edge_src = src.reshape(-1)
        self._flip_mask = flips.reshape(-1)
        self._conv_contra_all = conv_c
        self._conv_cov_all = conv_v

    def _trace_pool(self, itf_i: jnp.ndarray, itf_j: jnp.ndarray) -> jnp.ndarray:
        """All 24 outgoing boundary traces, stacked (..., 4, 6, npts) in
        (side, panel) order with sides (S, N, W, E)."""
        s = self.geom.num_solpts
        lead = itf_i.shape[:-4]
        shp = lead + (6, self.num_points)
        south = itf_j[..., :, 0, :, :s].reshape(shp)
        north = itf_j[..., :, -1, :, s:].reshape(shp)
        west = itf_i[..., :, :, 0, :s].reshape(shp)
        east = itf_i[..., :, :, -1, s:].reshape(shp)
        return jnp.stack([south, north, west, east], axis=-3)

    def exchange_pool(self, pool: jnp.ndarray) -> jnp.ndarray:
        """Exchange a prebuilt outgoing-trace pool (..., 4, 6, npts) in
        (S, N, W, E) side order: returns, for each (side, panel), the
        neighbor's facing trace in local edge ordering (flips applied).

        Row-level take of 24 contiguous traces + a vectorized flip select.
        Callers that already hold the boundary traces in a custom layout
        build the pool themselves; `_gather_halo` builds it from interface
        arrays.
        """
        flat = pool.reshape(pool.shape[:-3] + (24, self.num_points))
        # Both the 24-row neighbor permutation and the edge reversal run as
        # one-hot matmuls, which are exact (each output sums a single 1.0*x
        # term) and avoid small gather/reverse ops.
        perm = np.zeros((24, 24))
        perm[np.arange(24), self._edge_src] = 1.0
        sel = jnp.asarray(perm, dtype=flat.dtype) @ flat
        rev = jnp.asarray(np.eye(self.num_points)[::-1], dtype=sel.dtype)
        out = jnp.where(jnp.asarray(self._flip_mask)[:, None], sel @ rev, sel)
        return out.reshape(pool.shape)

    def exchange_pool_vectors(self, pool1: jnp.ndarray, pool2: jnp.ndarray, covariant: bool = False):
        """Exchange two vector-component pools and rotate the received
        components into the local panel basis (cf. halo_vectors)."""
        a1 = self.exchange_pool(pool1)
        a2 = self.exchange_pool(pool2)
        conv = self._conv_cov_all if covariant else self._conv_contra_all
        conv = jnp.asarray(conv, dtype=a1.dtype)
        b1 = conv[..., 0, 0] * a1 + conv[..., 0, 1] * a2
        b2 = conv[..., 1, 0] * a1 + conv[..., 1, 1] * a2
        return b1, b2

    def _gather_halo(self, itf_i: jnp.ndarray, itf_j: jnp.ndarray) -> jnp.ndarray:
        """(..., 4, 6, npts): for each (side, panel), the neighbor's facing
        trace in local edge ordering (flips applied)."""
        return self.exchange_pool(self._trace_pool(itf_i, itf_j))

    # ------------------------------------------------------------------
    # Trace extraction (jittable; static slicing only).

    def _outgoing_trace(self, itf_i: jnp.ndarray, itf_j: jnp.ndarray, panel: int, side: int) -> jnp.ndarray:
        """The boundary-face trace a panel presents on one side, flattened to
        (..., npts) in that panel's local edge ordering.

        itf_i: (..., 6, ny, nx, 2s) west|east element-face values.
        itf_j: (..., 6, ny, nx, 2s) south|north element-face values.
        """
        s = self.geom.num_solpts
        lead = itf_i.shape[:-4]
        if side == SOUTH:
            t = itf_j[..., panel, 0, :, :s]
        elif side == NORTH:
            t = itf_j[..., panel, -1, :, s:]
        elif side == WEST:
            t = itf_i[..., panel, :, 0, :s]
        else:
            t = itf_i[..., panel, :, -1, s:]
        return t.reshape(lead + (self.num_points,))

    def halo_scalars(self, itf_i: jnp.ndarray, itf_j: jnp.ndarray) -> Dict[int, jnp.ndarray]:
        """Halo traces of a scalar field for every panel and side.

        Returns {side: array (..., 6, npts)} — the neighbor's facing trace in
        local edge ordering. Mirrors start_exchange_scalars + wait
        (reference process_topology.py:269-320), minus the MPI.
        """
        g = self._gather_halo(itf_i, itf_j)
        return {d: g[..., d, :, :] for d in range(4)}

    # ------------------------------------------------------------------
    # 3D variants: traces carry a vertical element axis (nk) and s^2 faces
    # where only the horizontal half flips / rotates. Mirrors the reference's
    # flip_dim=(-3, -1) exchanges with halo_side_shape (nel_h, s, s)
    # (rhs_dfr.py:141-172, cubed_sphere_3d.py:197).

    def _outgoing_trace_3d(self, itf_i: jnp.ndarray, itf_j: jnp.ndarray, panel: int, side: int) -> jnp.ndarray:
        """Boundary-face trace, 3D: returns (..., nk, nh, s, s) with axes
        (vertical element, horizontal element, kz, k_horizontal) in the
        sending panel's local ordering.

        itf_i: (..., 6, nk, ny, nx, 2s^2) west|east faces (face idx kz*s+ky).
        itf_j: (..., 6, nk, ny, nx, 2s^2) south|north faces (face idx kz*s+kx).
        """
        s = self.geom.num_solpts
        ss = s * s
        if side == SOUTH:
            t = itf_j[..., panel, :, 0, :, :ss]
        elif side == NORTH:
            t = itf_j[..., panel, :, -1, :, ss:]
        elif side == WEST:
            t = itf_i[..., panel, :, :, 0, :ss]
        else:
            t = itf_i[..., panel, :, :, -1, ss:]
        return t.reshape(t.shape[:-1] + (s, s))

    def _trace_pool_3d(self, itf_i: jnp.ndarray, itf_j: jnp.ndarray) -> jnp.ndarray:
        """All 24 outgoing boundary traces, 3D: (..., 4, 6, nk, nh, s^2) in
        (side, panel) order with sides (S, N, W, E)."""
        ss = self.geom.num_solpts ** 2
        south = itf_j[..., :, :, 0, :, :ss]
        north = itf_j[..., :, :, -1, :, ss:]
        west = itf_i[..., :, :, :, 0, :ss]
        east = itf_i[..., :, :, :, -1, ss:]
        return jnp.stack([south, north, west, east], axis=-5)

    def exchange_pool_3d(self, pool: jnp.ndarray) -> jnp.ndarray:
        """Exchange a 3D trace pool (..., 4, 6, nk, nh, s^2): returns, per
        (side, panel), the neighbor's facing trace in local ordering with
        the edge flip (horizontal element + k_horizontal reversal,
        reference's flip_dim=(-3, -1)) applied.

        Like `exchange_pool`, both the 24-row neighbor permutation and the
        flip run as one-hot matmuls; the batched leading dims let callers exchange all variables at once.
        """
        s = self.geom.num_solpts
        ss = s * s
        nh = self.nel_h
        m = nh * ss
        lead = pool.shape[:-5]
        nk = pool.shape[-3]
        flat = pool.reshape(lead + (24, nk, m))
        perm = np.zeros((24, 24))
        perm[np.arange(24), self._edge_src] = 1.0
        sel = jnp.einsum("ab,...bkm->...akm", jnp.asarray(perm, dtype=flat.dtype), flat)
        # Flip permutation on the flattened (nh, kz, kh) axis: reverse the
        # horizontal element and k_horizontal, keep kz.
        idx = np.arange(m).reshape(nh, s, s)[::-1, :, ::-1].reshape(m)
        fmat = np.zeros((m, m))
        fmat[idx, np.arange(m)] = 1.0
        flipped = sel @ jnp.asarray(fmat, dtype=sel.dtype)
        out = jnp.where(jnp.asarray(self._flip_mask)[:, None, None], flipped, sel)
        return out.reshape(pool.shape)

    def halo_scalars_3d(self, itf_i: jnp.ndarray, itf_j: jnp.ndarray) -> Dict[int, jnp.ndarray]:
        """{side: (..., 6, nk, nh, s^2)} halo traces of a scalar field."""
        g = self.exchange_pool_3d(self._trace_pool_3d(itf_i, itf_j))
        return {d: g[..., d, :, :, :, :] for d in range(4)}

    def halo_state_3d(
        self, itf_i: jnp.ndarray, itf_j: jnp.ndarray, vec_rows: Tuple[int, int], covariant: bool = False
    ) -> jnp.ndarray:
        """Exchange ALL state rows in one pooled pass: itf_i/itf_j are
        (nv, 6, nk, ny, nx, 2s^2) full interface arrays; rows `vec_rows`
        form the horizontal vector pair and get the 2x2 panel-basis rotation,
        every other row (scalars, vertical momentum, tracers) passes through
        like a scalar. Returns (nv, 4, 6, nk, nh, s^2) in (S, N, W, E) side
        order — one trace-pool extraction and one exchange for the whole
        state instead of one per variable group."""
        s = self.geom.num_solpts
        nh = self.nel_h
        a = self.exchange_pool_3d(self._trace_pool_3d(itf_i, itf_j))
        conv = self._conv_cov_all if covariant else self._conv_contra_all
        cc = np.asarray(conv).reshape(4, 6, nh, s, 2, 2)

        def coef(i, j):
            return jnp.asarray(cc[..., i, j][:, :, None, :, None, :], dtype=a.dtype)

        r1, r2 = vec_rows
        split = a.shape[1:-1] + (s, s)  # trailing s^2 split into (kz, kh)
        v1 = a[r1].reshape(split)
        v2 = a[r2].reshape(split)
        b1 = (coef(0, 0) * v1 + coef(0, 1) * v2).reshape(a.shape[1:])
        b2 = (coef(1, 0) * v1 + coef(1, 1) * v2).reshape(a.shape[1:])
        lo, hi = min(r1, r2), max(r1, r2)
        first, second = (b1, b2) if r1 < r2 else (b2, b1)
        return jnp.concatenate(
            [a[:lo], first[None], a[lo + 1 : hi], second[None], a[hi + 1 :]], axis=0
        )

    def halo_vectors_3d(
        self,
        itf_i_1,
        itf_j_1,
        itf_i_2,
        itf_j_2,
        itf_i_3,
        itf_j_3,
        covariant: bool = False,
    ) -> Dict[int, Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]]:
        """3-vector halo: components 1/2 rotate with the 2x2 edge matrices
        (broadcast over the vertical), component 3 (vertical) passes through
        unchanged (reference process_topology.py:377). One batched pooled
        exchange for all three components."""
        s = self.geom.num_solpts
        nh = self.nel_h
        pool = jnp.stack(
            [
                self._trace_pool_3d(itf_i_1, itf_j_1),
                self._trace_pool_3d(itf_i_2, itf_j_2),
                self._trace_pool_3d(itf_i_3, itf_j_3),
            ]
        )
        a = self.exchange_pool_3d(pool)  # (3, ..., 4, 6, nk, nh, ss)
        conv = self._conv_cov_all if covariant else self._conv_contra_all
        # Coefficients (4, 6, nh*s, 2, 2) indexed by horizontal edge point
        # -> (4, 6, 1, nh, 1, s), broadcast over nk and kz in the split view.
        cc = np.asarray(conv).reshape(4, 6, nh, s, 2, 2)

        def coef(i, j):
            return jnp.asarray(cc[..., i, j][:, :, None, :, None, :], dtype=a.dtype)

        split = a.shape[1:-1] + (s, s)  # trailing ss split into (kz, kh)
        v1 = a[0].reshape(split)
        v2 = a[1].reshape(split)
        b1 = (coef(0, 0) * v1 + coef(0, 1) * v2).reshape(a.shape[1:])
        b2 = (coef(1, 0) * v1 + coef(1, 1) * v2).reshape(a.shape[1:])
        return {
            d: (b1[..., d, :, :, :, :], b2[..., d, :, :, :, :], a[2][..., d, :, :, :, :])
            for d in range(4)
        }

    def halo_vectors(
        self, itf_i_1, itf_j_1, itf_i_2, itf_j_2, covariant: bool = False
    ) -> Dict[int, Tuple[jnp.ndarray, jnp.ndarray]]:
        """Halo traces of a 2-vector field (components given as separate
        itf_i/itf_j arrays), rotated into the local panel basis.

        Returns {side: (comp1, comp2)}, each (..., 6, npts). Mirrors
        start_exchange_vectors + wait (process_topology.py:322-386).
        """
        a1 = self._gather_halo(itf_i_1, itf_j_1)  # (..., 4, 6, npts)
        a2 = self._gather_halo(itf_i_2, itf_j_2)
        conv = self._conv_cov_all if covariant else self._conv_contra_all
        conv = jnp.asarray(conv, dtype=a1.dtype)
        b1 = conv[..., 0, 0] * a1 + conv[..., 0, 1] * a2
        b2 = conv[..., 1, 0] * a1 + conv[..., 1, 1] * a2
        return {d: (b1[..., d, :, :], b2[..., d, :, :]) for d in range(4)}
