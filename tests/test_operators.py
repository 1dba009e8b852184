"""Unit tests for quadrature and DFR operator matrices.

Modeled on the reference's operator correctness guards (skew-centrosymmetry
check, geometry/operators.py:836) plus exactness properties of Gauss-Legendre
collocation.
"""

import os

import numpy as np
import pytest
import scipy.special

from wxfactory_tpu.ops import (
    check_skew_centrosymmetry,
    gauss_legendre,
    make_dfr_operators,
    remesh_operator,
)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 6, 7, 8])
def test_gauss_legendre_matches_scipy(n):
    _, pts, wts = gauss_legendre(n)
    ref_pts, ref_wts = scipy.special.roots_legendre(n)
    assert np.allclose(pts, ref_pts, atol=1e-14)
    assert np.allclose(wts, ref_wts, atol=1e-14)
    assert abs(wts.sum() - 2.0) < 1e-14


@pytest.mark.parametrize("n", [2, 3, 5])
def test_gauss_legendre_integrates_polynomials_exactly(n):
    # Degree up to 2n-1 is integrated exactly on [-1, 1]
    _, pts, wts = gauss_legendre(n)
    for deg in range(2 * n):
        exact = 2.0 / (deg + 1) if deg % 2 == 0 else 0.0
        assert abs(wts @ pts**deg - exact) < 1e-12, deg


@pytest.mark.parametrize("s", [2, 3, 4, 5])
def test_diffmat_exact_on_polynomials(s):
    ops = make_dfr_operators(s)
    x = ops.solpts
    for deg in range(s):
        expected = deg * x ** (deg - 1) if deg > 0 else np.zeros_like(x)
        assert np.allclose(ops.diff @ (x**deg), expected, atol=1e-11)
    # Extension-point matrix is exact one degree higher
    xe = ops.extension
    for deg in range(s + 2):
        expected = deg * xe ** (deg - 1) if deg > 0 else np.zeros_like(xe)
        assert np.allclose(ops.diff_ext @ (xe**deg), expected, atol=1e-10)


@pytest.mark.parametrize("s", [2, 3, 4, 5, 7])
def test_diff_ext_skew_centrosymmetric(s):
    ops = make_dfr_operators(s)
    assert check_skew_centrosymmetry(ops.diff_ext)


@pytest.mark.parametrize("s", [2, 3, 4])
def test_extrapolation_exact_on_polynomials(s):
    ops = make_dfr_operators(s)
    x = ops.solpts
    for deg in range(s):
        f = x**deg
        assert abs(ops.extrap_neg @ f - (-1.0) ** deg) < 1e-12
        assert abs(ops.extrap_pos @ f - 1.0) < 1e-12


def test_2d_kron_lift_consistency():
    # Applying the lifted 2D operator == applying 1D operators per direction.
    s = 3
    ops = make_dfr_operators(s)
    rng = np.random.default_rng(42)
    q = rng.standard_normal((s, s))  # [z, x]
    flat = q.reshape(-1)

    itf_x = flat @ ops.extrap_x
    assert np.allclose(itf_x[:s], q @ ops.extrap_neg)  # west face, varying z
    assert np.allclose(itf_x[s:], q @ ops.extrap_pos)

    itf_z = flat @ ops.extrap_z
    assert np.allclose(itf_z[:s], ops.extrap_neg @ q)  # bottom face, varying x
    assert np.allclose(itf_z[s:], ops.extrap_pos @ q)

    dx = (flat @ ops.derivative_x).reshape(s, s)
    assert np.allclose(dx, q @ ops.diff_solpt.T)
    dz = (flat @ ops.derivative_z).reshape(s, s)
    assert np.allclose(dz, ops.diff_solpt @ q)


def test_3d_operators_shapes():
    s = 2
    ops = make_dfr_operators(s, three_d=True)
    assert ops.extrap_x3.shape == (s**3, 2 * s**2)
    assert ops.derivative_y3.shape == (s**3, s**3)
    assert ops.correction_DU3.shape == (2 * s**2, s**3)
    # 3D x-extrapolation of a function constant in y,z equals 1D extrapolation
    q1d = np.array([1.7, -0.3])
    q = np.tile(q1d, s * s)
    itf = q @ ops.extrap_x3
    assert np.allclose(itf[: s * s], ops.extrap_neg @ q1d)
    assert np.allclose(itf[s * s :], ops.extrap_pos @ q1d)


def test_remesh_operator_roundtrip_low_modes():
    # Projecting down then up must preserve polynomials representable at the
    # coarse order (up to the damped highest mode).
    _, pts_hi, _ = gauss_legendre(4)
    _, pts_lo, _ = gauss_legendre(3)
    down = remesh_operator(pts_hi, pts_lo)
    # The highest retained mode is damped by 1/2, so only degree <= order-2
    # transfers exactly.
    f = 1.0 + 2.0 * pts_hi  # degree 1 < 3 - 1
    assert np.allclose(down @ f, 1.0 + 2.0 * pts_lo, atol=1e-12)


PINNED = os.path.join(os.path.dirname(__file__), "data", "dfr_operators_n1_12.npz")


@pytest.mark.parametrize("n", range(1, 13))
def test_operators_match_pinned_float64(n):
    """Nodes, weights, derivative and extrapolation matrices are bit for bit
    the float64 values pinned in tests/data (built by the earlier symbolic
    construction at 34 digits), and the extension-point derivative matrix
    stays exactly skew-centrosymmetric."""
    ops = make_dfr_operators(n)
    with np.load(PINNED) as pinned:
        for name in ("solpts", "weights", "diff", "diff_ext", "extrap_neg", "extrap_pos"):
            want = pinned[f"{name}_{n}"]
            got = np.asarray(getattr(ops, name), dtype=np.float64)
            assert got.shape == want.shape, name
            assert np.array_equal(got.view(np.uint64), want.view(np.uint64)), name
    assert check_skew_centrosymmetry(ops.diff_ext)
    if n > 1:
        assert check_skew_centrosymmetry(ops.diff)
