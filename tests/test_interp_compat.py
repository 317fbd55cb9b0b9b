"""Reference-named compat API (isochrones_tpu.interp) vs the numpy
transliteration oracle of the reference's numba kernels.

The compat module exposes the reference's public names
(``/root/reference/isochrones/interp.py``: searchsorted, find_indices_*,
interp_value(s)_*, interp_eep(s), find_closest3, DFInterpolator) as thin
wrappers over the device ops; every wrapper must agree with the transliterated
loop oracle (tests/reference_oracle.py) on randomized + adversarial inputs.
"""

import numpy as np
import pandas as pd
import pytest

import reference_oracle as oracle
from isochrones_tpu import interp as compat


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(42)


def test_searchsorted_matches_oracle(rng):
    for _ in range(200):
        arr = np.sort(rng.uniform(0, 1, int(rng.integers(3, 15))))
        x = float(rng.uniform(-0.1, 1.1))
        assert compat.searchsorted(arr, x) == tuple(oracle.ref_searchsorted(arr, x))
    arr = np.sort(rng.uniform(0, 1, 9))
    for x in arr:  # exact knots
        assert compat.searchsorted(arr, float(x)) == tuple(oracle.ref_searchsorted(arr, float(x)))


def test_find_indices_2d_matches_oracle(rng):
    ii0 = np.sort(rng.uniform(0, 1, 6))
    ii1 = np.sort(rng.uniform(0, 1, 8))
    pts = [(float(rng.uniform(0, 1)), float(rng.uniform(0, 1))) for _ in range(100)]
    pts += [(float(ii0[2]), float(ii1[3])), (-1.0, 0.5), (0.5, 2.0)]
    for x0, x1 in pts:
        gi, gn, goob = compat.find_indices_2d(x0, x1, ii0, ii1)
        ri, rn, roob = oracle.ref_find_indices((x0, x1), (ii0, ii1))
        assert goob == roob
        if not roob:
            np.testing.assert_array_equal(gi, ri)
            np.testing.assert_allclose(gn, rn, rtol=1e-12)


@pytest.mark.parametrize("nd", [2, 3, 4])
def test_interp_values_match_oracle(rng, nd):
    shape = (5, 7, 9, 6)[:nd]
    iis = [np.sort(rng.uniform(0, 1, n)) for n in shape]
    grid = rng.normal(size=shape + (3,))
    grid[(1,) * nd] = np.nan  # NaN hole
    icols = np.array([0, 2])
    xs = [rng.uniform(-0.05, 1.05, 64) for _ in range(nd)]
    fn = getattr(compat, f"interp_values_{nd}d")
    got = fn(*xs, grid, icols, *iis)
    ref = oracle.ref_interp_values(np.stack(xs, axis=-1), grid, icols, iis)
    np.testing.assert_allclose(got, ref, rtol=1e-10, equal_nan=True)
    # scalar variants agree with their batched counterparts
    fn1 = getattr(compat, f"interp_value_{nd}d")
    one = fn1(*[float(x[0]) for x in xs], grid, icols, *iis)
    np.testing.assert_allclose(one, got[0], rtol=1e-12, equal_nan=True)


def test_interp_eeps_matches_oracle(rng):
    n0, n1, ne = 4, 6, 20
    ii0 = np.sort(rng.uniform(-1, 1, n0))
    ii1 = np.sort(rng.uniform(0.2, 3, n1))
    lengths = rng.integers(8, ne + 1, n0 * n1)
    arrays = np.full((n0 * n1, ne), np.inf)
    for i in range(n0 * n1):
        arrays[i, : lengths[i]] = np.sort(rng.uniform(6, 10, lengths[i]))
    weights = rng.uniform(0.1, 1, (n0 * n1, ne))
    xs = rng.uniform(6, 10, 300)
    x0s = rng.uniform(-1, 1, 300)
    x1s = rng.uniform(0.2, 3, 300)
    ref = oracle.ref_interp_eeps(xs, x0s, x1s, ii0, ii1, n1, arrays, weights, lengths)
    got = compat.interp_eeps(xs, x0s, x1s, ii0, ii1, n1, arrays, weights, lengths)
    m = np.isfinite(ref)
    assert np.array_equal(np.isfinite(got), m)
    np.testing.assert_allclose(got[m], ref[m], rtol=1e-10)
    # scalar wrapper
    one = compat.interp_eep(float(xs[0]), float(x0s[0]), float(x1s[0]), ii0, ii1, n1, arrays, weights, lengths)
    np.testing.assert_allclose(one, got[0], rtol=1e-12, equal_nan=True)


def test_dfinterpolator_alias_roundtrip(rng):
    idx = pd.MultiIndex.from_product([np.arange(3.0), np.arange(4.0)], names=["a", "b"])
    df = pd.DataFrame({"x": rng.normal(size=12), "y": rng.normal(size=12)}, index=idx)
    interp = compat.DFInterpolator(df)
    assert interp.columns == ["x", "y"]
    v = interp([1.5, 2.5], ["x"])
    lo = df.loc[(1.0, 2.0), "x"]
    hi = df.loc[(2.0, 3.0), "x"]
    assert min(df.loc[(1.0, 2.0):(2.0, 3.0), "x"].min(), lo, hi) - 1e-9 <= float(v[0])


def test_find_closest3(rng):
    # monotone column along axis 2 -> exact invertibility
    ii0 = np.linspace(0, 1, 4)
    ii1 = np.linspace(0, 1, 5)
    ii2 = np.linspace(0, 10, 30)
    grid = np.zeros((4, 5, 30, 2))
    grid[..., 0] = ii2[None, None, :] * 2.0 + 1.0
    target_x = 6.3
    val = target_x * 2.0 + 1.0
    got = compat.find_closest3(val, 0.0, 10.0, 0.5, 0.5, grid, 0, ii0, ii1, ii2)
    assert abs(got - target_x) < 0.02


def test_interp_values_true_broadcast(rng):
    """Genuinely 2-d broadcast inputs — (3,1) x (1,4) — must interpolate at
    the broadcasted point pairs, not cyclically repeated ones (ADVICE r2:
    np.resize filled cyclically)."""
    n0, n1 = 5, 7
    ii0 = np.sort(rng.uniform(0, 1, n0))
    ii1 = np.sort(rng.uniform(0, 1, n1))
    grid = rng.normal(size=(n0, n1, 2))
    icols = np.array([1])
    x0 = rng.uniform(0.1, 0.9, (3, 1))
    x1 = rng.uniform(0.1, 0.9, (1, 4))
    got = compat.interp_values_2d(x0, x1, grid, icols, ii0, ii1)
    x0f, x1f = np.broadcast_arrays(x0, x1)
    ref = compat.interp_values_2d(x0f.ravel(), x1f.ravel(), grid, icols, ii0, ii1)
    np.testing.assert_allclose(got, ref, rtol=1e-12)


def test_sign():
    assert compat.sign(-3.0) == -1
    assert compat.sign(2.0) == 1
    assert compat.sign(0.0) == 1  # reference quirk: sign(0) == 1
