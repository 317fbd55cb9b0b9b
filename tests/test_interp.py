"""Parity tests for the core N-d interpolation kernel.

Mirrors the reference's golden-parity pattern (``isochrones/tests/test_interp.py:11-46``):
DFInterpolator-vs-scipy RegularGridInterpolator on a synthetic dense grid —
exact equality at grid points, 1e-11 closeness off-grid, vectorized batch
equality — plus the NaN/out-of-bounds semantics of interp.py:208-338.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
from scipy.interpolate import RegularGridInterpolator

from isochrones_tpu.ops import GridData, GridInterpolator, interp_nd


def make_grid_df(seed=42):
    rng = np.random.RandomState(seed)
    xx = [np.arange(1, 4, 0.1), np.arange(-1, 1, 0.2), np.arange(0, 10, 0.5)]
    grid = rng.random(tuple(len(x) for x in xx) + (3,))
    index = pd.MultiIndex.from_product(xx, names=["x0", "x1", "x2"])
    df = pd.DataFrame(grid.reshape(-1, 3), index=index, columns=["a", "b", "c"])
    return df, xx, grid


def test_against_scipy_3d():
    df, xx, grid = make_grid_df()
    interp = GridInterpolator(df)
    scipy_interps = [RegularGridInterpolator(xx, grid[..., i]) for i in range(3)]

    # exact grid-point equality
    pt = [xx[0][3], xx[1][5], xx[2][2]]
    vals = interp(pt)
    expect = np.array([s(pt)[0] for s in scipy_interps])
    np.testing.assert_array_equal(vals, grid[3, 5, 2])
    np.testing.assert_allclose(vals, expect, rtol=1e-12)

    # off-grid closeness
    rng = np.random.RandomState(0)
    for _ in range(20):
        pt = [
            rng.uniform(xx[0][0], xx[0][-1]),
            rng.uniform(xx[1][0], xx[1][-1]),
            rng.uniform(xx[2][0], xx[2][-1]),
        ]
        vals = interp(pt)
        expect = np.array([s(pt).item() for s in scipy_interps])
        np.testing.assert_allclose(vals, expect, rtol=1e-11, atol=1e-13)


def test_vectorized_matches_scalar():
    df, xx, grid = make_grid_df()
    interp = GridInterpolator(df)
    rng = np.random.RandomState(1)
    N = 100
    pts = np.stack(
        [rng.uniform(x[0], x[-1], N) for x in xx], axis=0
    )
    batch = interp([pts[0], pts[1], pts[2]])
    assert batch.shape == (N, 3)
    for i in range(0, N, 17):
        single = interp([float(pts[0, i]), float(pts[1, i]), float(pts[2, i])])
        np.testing.assert_allclose(batch[i], single, rtol=1e-14)


def test_column_selection():
    df, xx, grid = make_grid_df()
    interp = GridInterpolator(df)
    pt = [1.25, 0.31, 4.77]
    all_vals = interp(pt)
    b_only = interp(pt, ["b"])
    np.testing.assert_allclose(b_only, all_vals[1:2], rtol=1e-15)
    ca = interp(pt, ["c", "a"])
    np.testing.assert_allclose(ca, [all_vals[2], all_vals[0]], rtol=1e-15)


def test_out_of_bounds_and_nan():
    df, xx, grid = make_grid_df()
    interp = GridInterpolator(df)
    # below lower bound / above upper bound / NaN input -> NaN out
    assert np.isnan(interp([0.5, 0.0, 5.0])).all()
    assert np.isnan(interp([2.0, 0.0, 99.0])).all()
    assert np.isnan(interp([np.nan, 0.0, 5.0])).all()
    # exactly on the boundary knots is in bounds
    assert np.isfinite(interp([xx[0][0], xx[1][0], xx[2][0]])).all()
    assert np.isfinite(interp([xx[0][-1], xx[1][-1], xx[2][-1]])).all()


def test_exact_top_knot():
    """Exact top-knot query returns the grid value (reference reads OOB memory
    with weight 0 here — numba UB; we clamp and return the exact value)."""
    df, xx, grid = make_grid_df()
    interp = GridInterpolator(df)
    vals = interp([xx[0][-1], xx[1][-1], xx[2][-1]])
    np.testing.assert_array_equal(vals, grid[-1, -1, -1])


def test_nan_hole_propagation():
    """NaN-padded grid holes poison any cell that touches them — including
    weight-0 corners at an exact interior knot (IEEE 0*NaN=NaN, matching the
    reference's accumulation at interp.py:247)."""
    df, xx, grid = make_grid_df()
    grid = grid.copy()
    grid[4, 5, 5, :] = np.nan
    gd = GridData(
        values=jnp.asarray(grid),
        knots=tuple(jnp.asarray(x) for x in xx),
        columns=("a", "b", "c"),
    )
    # query inside a cell adjacent to the hole
    pt = jnp.array([[(xx[0][3] + xx[0][4]) / 2, (xx[1][4] + xx[1][5]) / 2, (xx[2][4] + xx[2][5]) / 2]])
    out = interp_nd(gd.values, gd.knots, pt)
    assert np.isnan(np.asarray(out)).all()
    # far away cell unaffected
    pt2 = jnp.array([[xx[0][10], xx[1][2], xx[2][10]]])
    assert np.isfinite(np.asarray(interp_nd(gd.values, gd.knots, pt2))).all()


def test_2d_and_4d():
    rng = np.random.RandomState(3)
    for ndim in (2, 4):
        xx = [np.sort(rng.uniform(0, 10, 8 + 2 * d)) for d in range(ndim)]
        grid = rng.random(tuple(len(x) for x in xx) + (2,))
        scipy_interp = RegularGridInterpolator(xx, grid)
        gd_vals = jnp.asarray(grid)
        knots = tuple(jnp.asarray(x) for x in xx)
        pts = np.stack([rng.uniform(x[0], x[-1], 50) for x in xx], axis=-1)
        out = np.asarray(interp_nd(gd_vals, knots, jnp.asarray(pts)))
        np.testing.assert_allclose(out, scipy_interp(pts), rtol=1e-11, atol=1e-13)


def test_partial_index_densification():
    """Sparse MultiIndex (ragged grid) is NaN-padded (interp.py:598-604)."""
    xx = [np.array([0.0, 1.0]), np.array([0.0, 1.0, 2.0])]
    idx = pd.MultiIndex.from_tuples(
        [(0.0, 0.0), (0.0, 1.0), (0.0, 2.0), (1.0, 0.0), (1.0, 1.0)], names=["x0", "x1"]
    )
    df = pd.DataFrame({"v": [1.0, 2.0, 3.0, 4.0, 5.0]}, index=idx)
    interp = GridInterpolator(df)
    # (0.0, 2.0) is an exact grid point, but its weight-0 corner (1.0, 2.0) is a
    # NaN hole: IEEE 0*NaN=NaN — reference behaves the same (interp.py:247)
    assert np.isnan(interp([0.0, 2.0])).all()
    # cell (x0 in [0,1], x1 in [1,2]) touches the missing (1.0, 2.0) node
    assert np.isnan(interp([0.5, 1.5])).all()
    np.testing.assert_allclose(interp([0.5, 0.5]), [(1 + 2 + 4 + 5) / 4.0])


def test_add_column():
    df, xx, grid = make_grid_df()
    interp = GridInterpolator(df)
    interp.add_column(jnp.asarray(grid[..., 0] * 2), "d")
    pt = [1.25, 0.31, 4.77]
    np.testing.assert_allclose(interp(pt, ["d"]), 2 * interp(pt, ["a"]), rtol=1e-14)


def test_npz_cache_roundtrip(tmp_path):
    df, xx, grid = make_grid_df()
    fn = str(tmp_path / "grid.npz")
    interp1 = GridInterpolator(df, filename=fn)
    interp2 = GridInterpolator(df, filename=fn)
    pt = [1.77, -0.33, 8.2]
    np.testing.assert_array_equal(interp1(pt), interp2(pt))


class TestBlockGatherParity:
    """The block-gather path (one lax.gather of the (2,)*ndim corner
    neighborhood per point, an opt-in alternative) must be BITWISE identical to the row-gather path,
    which is itself oracle-pinned (tests/test_oracle_parity.py): NaN holes,
    weight-0 poisoning, exact interior knots, the top-knot clamp, OOB."""

    @pytest.mark.parametrize("ndim", [2, 3, 4])
    def test_randomized_with_nan_holes(self, ndim):
        rng = np.random.RandomState(10 + ndim)
        dims = [5, 7, 4, 6][:ndim]
        knots = [np.sort(rng.uniform(0, 10, n)) for n in dims]
        vals = rng.normal(size=tuple(dims) + (3,))
        vals[(rng.random(tuple(dims)) < 0.15)] = np.nan  # holes
        kn = tuple(jnp.asarray(k) for k in knots)
        v = jnp.asarray(vals)

        B = 500
        pts = np.stack([rng.uniform(k[0] - 1, k[-1] + 1, B) for k in knots], axis=-1)
        # adversarial coverage: exact interior knots, exact top knots, NaNs
        for b in range(0, 60, 3):
            d = b % ndim
            pts[b, d] = knots[d][rng.randint(len(knots[d]))]
            pts[b + 1, d] = knots[d][-1]
            pts[b + 2, d] = np.nan
        p = jnp.asarray(pts)

        row = np.asarray(interp_nd(v, kn, p, block=False))
        blk = np.asarray(interp_nd(v, kn, p, block=True))
        # identical NaN pattern (holes/OOB/weight-0 poisoning semantics);
        # values agree to contraction-order rounding (the block path lerps
        # per-dim sequentially; the row path sums weight products — a
        # ~1e-15 relative difference, far below f32 resolution)
        np.testing.assert_array_equal(np.isnan(row), np.isnan(blk))
        m = np.isfinite(row)
        np.testing.assert_allclose(blk[m], row[m], rtol=1e-12, atol=1e-14)

    def test_icols_and_axis_maps(self):
        from isochrones_tpu.ops.interp import compute_axis_maps

        rng = np.random.RandomState(3)
        knots = [np.arange(0.0, 15.0), np.linspace(-1, 1, 21)]  # exact_affine axes
        vals = rng.normal(size=(15, 21, 4))
        amaps = compute_axis_maps(knots)
        kn = tuple(jnp.asarray(k) for k in knots)
        v = jnp.asarray(vals)
        B = 200
        pts = np.stack([rng.uniform(k[0], k[-1], B) for k in knots], axis=-1)
        pts[0] = [knots[0][-1], knots[1][-1]]  # both-dim top corner
        p = jnp.asarray(pts)
        row = np.asarray(interp_nd(v, kn, p, icols=(2, 0), axis_maps=amaps, block=False))
        blk = np.asarray(interp_nd(v, kn, p, icols=(2, 0), axis_maps=amaps, block=True))
        np.testing.assert_allclose(blk, row, rtol=1e-12, atol=1e-14)
        # exact-value (not approximate) top-corner clamp
        np.testing.assert_array_equal(blk[0], vals[-1, -1][[2, 0]])


class TestPairedGatherParity:
    """The EEP-paired gather path (pair_innermost_columns + paired=True —
    an opt-in for the packed hot-kernel tables that halves the gather
    count) must match the row path:
    NaN pattern exactly, values to fp-association rounding."""

    @pytest.mark.parametrize("ndim", [2, 3, 4])
    def test_randomized_with_nan_holes(self, ndim):
        from isochrones_tpu.ops.interp import pair_innermost_columns

        rng = np.random.RandomState(20 + ndim)
        dims = [6, 5, 7, 9][:ndim]
        knots = [np.sort(rng.uniform(0, 10, n)) for n in dims]
        vals = rng.normal(size=tuple(dims) + (3,))
        vals[(rng.random(tuple(dims)) < 0.15)] = np.nan
        kn = tuple(jnp.asarray(k) for k in knots)
        v = jnp.asarray(vals)
        vp = jnp.asarray(pair_innermost_columns(vals))

        B = 400
        pts = np.stack([rng.uniform(k[0] - 1, k[-1] + 1, B) for k in knots], axis=-1)
        for b in range(0, 60, 3):  # exact knots / top knots / NaNs
            d = b % ndim
            pts[b, d] = knots[d][rng.randint(len(knots[d]))]
            pts[b + 1, d] = knots[d][-1]
            pts[b + 2, d] = np.nan
        pts[70] = [k[-1] for k in knots]  # all-top corner
        p = jnp.asarray(pts)

        row = np.asarray(interp_nd(v, kn, p, block=False))
        par = np.asarray(interp_nd(vp, kn, p, paired=True))
        np.testing.assert_array_equal(np.isnan(row), np.isnan(par))
        m = np.isfinite(row)
        np.testing.assert_allclose(par[m], row[m], rtol=1e-12, atol=1e-14)

    def test_icols_subset(self):
        from isochrones_tpu.ops.interp import compute_axis_maps, pair_innermost_columns

        rng = np.random.RandomState(5)
        knots = [np.linspace(0, 1, 8), np.arange(0.0, 30.0)]  # exact_affine inner
        vals = rng.normal(size=(8, 30, 5))
        amaps = compute_axis_maps(knots)
        kn = tuple(jnp.asarray(k) for k in knots)
        vp = jnp.asarray(pair_innermost_columns(vals))
        B = 300
        pts = np.stack([rng.uniform(k[0], k[-1], B) for k in knots], axis=-1)
        pts[0, 1] = knots[1][-1]  # top knot on the paired axis
        p = jnp.asarray(pts)
        row = np.asarray(interp_nd(jnp.asarray(vals), kn, p, icols=(4, 1), axis_maps=amaps, block=False))
        par = np.asarray(interp_nd(vp, kn, p, icols=(4, 1), axis_maps=amaps, paired=True))
        np.testing.assert_allclose(par, row, rtol=1e-12, atol=1e-14)
