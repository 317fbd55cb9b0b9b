"""Interpolator API tests — the reference's ``test_basic.py`` matrix adapted to
the synthetic grids: scalar/vector broadcasting, NaN propagation, EEP inversion
round trips, generate() consistency."""

import numpy as np
import pandas as pd
import pytest

from isochrones_tpu import get_ichrone


@pytest.fixture(scope="module")
def track():
    return get_ichrone("synthetic", tracks=True)


@pytest.fixture(scope="module")
def iso():
    return get_ichrone("synthetic")


def test_grid_point_exact(track):
    """Interpolation at a grid knot returns the tabulated value exactly
    (pattern of reference test_basic.py:16-18)."""
    g = track.model
    fehs = np.asarray(g.knots[0])
    masses = np.asarray(g.knots[1])
    eeps = np.asarray(g.knots[2])
    i, j, k = 4, 10, 50
    icol = g.column_index["logg"]
    expect = float(np.asarray(g.values)[i, j, k, icol])
    got = track.logg(masses[j], eeps[k], fehs[i])
    assert got == pytest.approx(expect, rel=1e-14)


def test_broadcasting_matrix(track):
    """All scalar/vector combinations agree (reference test_basic.py:90-100)."""
    m0, e0, f0 = 1.0, 120.0, -0.2
    base = track.Teff(m0, e0, f0)
    n = 5
    vec = np.ones(n)
    combos = [
        (m0 * vec, e0, f0),
        (m0, e0 * vec, f0),
        (m0, e0, f0 * vec),
        (m0 * vec, e0 * vec, f0),
        (m0 * vec, e0 * vec, f0 * vec),
    ]
    for args in combos:
        out = track.Teff(*args)
        assert out.shape == (n,)
        np.testing.assert_allclose(out, base, rtol=1e-12)


def test_nan_propagation(track):
    assert np.isnan(track.Teff(np.nan, 120.0, 0.0))
    out = track.Teff(np.array([1.0, np.nan]), 120.0, 0.0)
    assert np.isfinite(out[0]) and np.isnan(out[1])
    # out-of-bounds mass
    assert np.isnan(track.Teff(99.0, 120.0, 0.0))


def test_interp_mag_finite(track):
    Teff, logg, feh, mags = track.interp_mag([1.0, 120.0, -0.2, 500.0, 0.3], ["J", "K", "G"])
    assert np.isfinite([Teff, logg, feh]).all()
    assert mags.shape == (3,)
    assert np.isfinite(mags).all()
    # distance modulus: moving 10x farther adds 5 mags exactly
    _, _, _, mags2 = track.interp_mag([1.0, 120.0, -0.2, 5000.0, 0.3], ["J", "K", "G"])
    np.testing.assert_allclose(mags2 - mags, 5.0, rtol=1e-10)


def test_extinction_positive(track):
    _, _, _, m0 = track.interp_mag([1.0, 120.0, -0.2, 500.0, 0.0], ["G"])
    _, _, _, m1 = track.interp_mag([1.0, 120.0, -0.2, 500.0, 1.0], ["G"])
    assert m1 > m0  # extinction dims the star


def test_get_eep_roundtrip_fast(track):
    """age -> EEP -> age consistency at integer-EEP resolution."""
    rng = np.random.RandomState(0)
    n = 200
    masses = rng.uniform(0.3, 3.0, n)
    fehs = rng.uniform(-1.5, 0.3, n)
    # pick ages safely inside each track
    true_eeps = rng.uniform(30, 120, n)
    ages = np.array(
        [float(track.interp_value([m, e, f], ["age"]).squeeze()) for m, e, f in zip(masses, true_eeps, fehs)]
    )
    eeps = track.get_eep(masses, ages, fehs)
    valid = np.isfinite(eeps)
    assert valid.mean() > 0.95
    # fast path is integer-resolution (reference interp_eep returns index+1)
    assert np.nanmax(np.abs(eeps[valid] - true_eeps[valid])) < 2.5


def test_get_eep_accurate(track):
    rng = np.random.RandomState(1)
    n = 50
    masses = rng.uniform(0.3, 3.0, n)
    fehs = rng.uniform(-1.5, 0.3, n)
    true_eeps = rng.uniform(30, 120, n)
    pts = np.stack([masses, true_eeps, fehs], -1)
    ages = np.asarray(track.interp_value_batch(pts, ["age"]))[:, 0]
    eeps = track.get_eep(masses, ages, fehs, accurate=True)
    valid = np.isfinite(eeps)
    assert valid.mean() > 0.9
    # accurate path: recovered age residual below tolerance
    ages_back = np.asarray(
        track.interp_value_batch(np.stack([masses, np.where(valid, eeps, 100.0), fehs], -1), ["age"])
    )[:, 0]
    assert np.nanmax(np.abs(ages_back[valid] - ages[valid])) < 0.02


def test_generate(track):
    df = track.generate([0.8, 1.0, 1.2], 9.0, 0.0, distance=100.0, AV=0.1)
    assert isinstance(df, pd.DataFrame)
    assert len(df) == 3
    assert np.isfinite(df["Teff"].values).all()
    assert np.isfinite(df["J_mag"].values).all()
    # masses increase -> (toy model) Teff increases on MS
    assert df["Teff"].values[2] > df["Teff"].values[0]


def test_generate_device_matches_host(track):
    """generate_device returns the same fused-kernel outputs as generate,
    minus the host readback (the device-resident consumer/bench path)."""
    mass = np.array([0.8, 1.0, 1.2])
    df = track.generate(mass, 9.0, 0.0, distance=100.0, AV=0.1)
    eeps, values, mags = track.generate_device(mass, 9.0, 0.0, distance=100.0, AV=0.1)
    values = np.asarray(values)
    mags = np.asarray(mags)
    cols = list(track.model.columns)
    np.testing.assert_allclose(values[:, cols.index("Teff")], df["Teff"].values, rtol=1e-12)
    band_i = track.bands.index("J")
    np.testing.assert_allclose(mags[:, band_i], df["J_mag"].values, rtol=1e-12)
    assert np.asarray(eeps).shape == (3,)


def test_generate_all_As(track):
    df = track.generate(1.0, 9.0, 0.0, distance=100.0, AV=0.5, all_As=True)
    for b in track.bands:
        assert f"A_{b}" in df.columns
        assert (df[f"A_{b}"].values > 0).all()


def test_generate_binary(track):
    df = track.generate_binary(1.0, 0.8, 9.0, 0.0, distance=100.0)
    m0 = df["J_mag_0"].values
    tot = df["J_mag"].values
    # total brighter than primary alone
    assert (tot < m0).all()


def test_isochrone_table(iso):
    df = iso.isochrone(9.0, feh=0.0)
    assert len(df) > 10
    assert "initial_mass" in df.columns
    assert (np.diff(df["initial_mass"].values) > 0).all()  # mass increases with EEP


def test_iso_track_consistency(iso, track):
    """Same physical star through both grids gives consistent Teff."""
    mass, age, feh = 1.0, 9.0, 0.0
    eep_t = track.get_eep(mass, age, feh, accurate=True)
    teff_t = track.Teff(mass, eep_t, feh)
    teff_i = iso.Teff(eep_t, age, feh)
    assert teff_i == pytest.approx(teff_t, rel=2e-3)


def test_iso_get_eep_accurate(iso):
    """Mass-residual EEP inversion on the isochrone grid."""
    eep = iso.get_eep(1.0, 9.0, 0.0, accurate=True)
    assert np.isfinite(eep)
    m_back = float(iso.interp_value([eep, 9.0, 0.0], ["initial_mass"]).squeeze())
    assert m_back == pytest.approx(1.0, abs=0.02)


def test_limits(track, iso):
    assert track.get_limits("feh") == (-2.0, 0.5)
    lo, hi = track.get_limits("mass")
    assert lo == pytest.approx(0.1) and hi == pytest.approx(10.0)
    assert iso.get_limits("age")[0] == pytest.approx(6.0)


def test_call_dataframe(track):
    df = track(1.0, 120.0, 0.0, distance=200.0, AV=0.1)
    assert isinstance(df, pd.DataFrame)
    assert len(df) == 1
    assert {"Teff", "logg", "mass", "J_mag"} <= set(df.columns)


def test_pair_grids_opt_in_parity(monkeypatch):
    """ISOTPU_PAIR_GRIDS=1 (the paired-gather option) must build paired packed
    tables that produce the same lnpost surface as the default unpaired
    build (values to fp-association rounding; identical -inf pattern)."""
    import numpy as np

    import jax.numpy as jnp

    from isochrones_tpu import get_ichrone
    from isochrones_tpu.starmodel import BinaryStarModel

    def build(env):
        monkeypatch.setenv("ISOTPU_PAIR_GRIDS", env)
        iso = get_ichrone("synthetic", n_feh=5, n_mass=20, n_eep=60, n_age=20)
        t = iso.interp_mag([30.0, 9.0, 0.0, 200.0, 0.1], ["J", "K"])
        return BinaryStarModel(
            iso, Teff=(float(t[0]), 100.0), J=(float(np.asarray(t[3])[0]), 0.02),
            K=(float(np.asarray(t[3])[1]), 0.02), parallax=(5.0, 0.05),
        )

    m0 = build("0")
    m1 = build("1")
    assert m0.ic.model_packed.paired is False
    assert m1.ic.model_packed.paired is True
    assert m1.ic.bc_paired is not None and m1.ic.bc_paired.paired

    rng = np.random.default_rng(0)
    p = np.stack([
        rng.uniform(5, 55, 300), rng.uniform(5, 55, 300),
        rng.uniform(8.2, 9.8, 300), rng.uniform(-0.4, 0.4, 300),
        rng.uniform(50, 400, 300), rng.uniform(0, 0.5, 300),
    ], axis=-1)
    a = np.asarray(m0.lnpost_batch(jnp.asarray(p)))
    b = np.asarray(m1.lnpost_batch(jnp.asarray(p)))
    np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b))
    f = np.isfinite(a)
    np.testing.assert_allclose(b[f], a[f], rtol=1e-10, atol=1e-10)
