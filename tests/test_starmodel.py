"""Tests for BasicStarModel family (mirrors reference tests/test_likelihood.py
and test_fits.py strategy: consistency of lnlike/lnprior/lnpost + tiny-budget
sampler smoke tests, on hermetic synthetic grids)."""

import math

import numpy as np
import pytest

import jax.numpy as jnp

from isochrones_tpu import get_ichrone
from isochrones_tpu.starmodel import (
    BasicStarModel,
    BinaryStarModel,
    IsoTrackModel,
    SingleStarModel,
    TripleStarModel,
)
from isochrones_tpu.ops.likelihood import LOG_ONE_OVER_ROOT_2PI


@pytest.fixture(scope="module")
def iso():
    return get_ichrone("synthetic", n_feh=7, n_mass=30, n_eep=100, n_age=30)


@pytest.fixture(scope="module")
def track(iso):
    return iso.track


def _true_star(iso, eep=60.0, age=9.0, feh=0.0, distance=200.0, AV=0.1):
    Teff, logg, feh_m, mags = iso.interp_mag([eep, age, feh, distance, AV], ["J", "H", "K"])
    return dict(
        pars=[eep, age, feh, distance, AV],
        Teff=Teff,
        logg=logg,
        feh=feh_m,
        mags=dict(zip(["J", "H", "K"], np.asarray(mags))),
    )


@pytest.fixture(scope="module")
def star1_model(iso):
    t = _true_star(iso)
    return SingleStarModel(
        iso,
        Teff=(t["Teff"], 100.0),
        logg=(t["logg"], 0.1),
        J=(t["mags"]["J"], 0.02),
        H=(t["mags"]["H"], 0.02),
        K=(t["mags"]["K"], 0.02),
        parallax=(5.0, 0.05),
        name="star1",
    ), t


def test_spec_only_lnlike_exact(iso):
    """At exact model values the Gaussian term reduces to the constant
    LOG_ONE_OVER_ROOT_2PI + log(unc) (reference likelihood.py:13 quirk)."""
    t = _true_star(iso)
    m = SingleStarModel(iso, Teff=(t["Teff"], 80.0), logg=(t["logg"], 0.1))
    ll = m.lnlike(t["pars"])
    expected = (LOG_ONE_OVER_ROOT_2PI + math.log(80.0)) + (LOG_ONE_OVER_ROOT_2PI + math.log(0.1))
    assert np.isclose(ll, expected, atol=1e-8)


def test_phot_lnlike_exact(iso):
    t = _true_star(iso)
    m = SingleStarModel(iso, J=(t["mags"]["J"], 0.02))
    ll = m.lnlike(t["pars"])
    expected = LOG_ONE_OVER_ROOT_2PI + math.log(0.02)
    assert np.isclose(ll, expected, atol=1e-8)


def test_parallax_term(iso):
    t = _true_star(iso, distance=200.0)
    plax = 1000.0 / 200.0
    m = SingleStarModel(iso, parallax=(plax, 0.1))
    ll = m.lnlike(t["pars"])
    expected = LOG_ONE_OVER_ROOT_2PI + math.log(0.1)
    assert np.isclose(ll, expected, atol=1e-8)


def test_lnpost_consistency(star1_model):
    m, t = star1_model
    p = t["pars"]
    assert np.isclose(m.lnpost(p), m.lnprior(p) + m.lnlike(p), atol=1e-8)
    assert np.isfinite(m.lnpost(p))


def test_lnprior_out_of_bounds(star1_model):
    m, t = star1_model
    p = list(t["pars"])
    p[3] = -5.0  # negative distance
    assert m.lnprior(p) == -np.inf
    assert m.lnpost(p) == -np.inf


def test_batch_matches_scalar(star1_model):
    m, t = star1_model
    rng = np.random.default_rng(0)
    base = np.asarray(t["pars"])
    batch = base[None, :] + rng.normal(0, [5.0, 0.05, 0.05, 5.0, 0.02], size=(16, 5))
    lnp_b = np.asarray(m.lnpost_batch(jnp.asarray(batch)))
    for i in range(16):
        assert np.isclose(lnp_b[i], m.lnpost(batch[i]), atol=1e-8, equal_nan=True)


def test_param_names_multiplicity(iso):
    assert SingleStarModel(iso, J=(10, 0.02)).param_names == ("eep", "age", "feh", "distance", "AV")
    assert BinaryStarModel(iso, J=(10, 0.02)).param_names == ("eep_0", "eep_1", "age", "feh", "distance", "AV")
    assert TripleStarModel(iso, J=(10, 0.02)).param_names == (
        "eep_0", "eep_1", "eep_2", "age", "feh", "distance", "AV",
    )


def test_binary_eep_ordering(iso):
    t = _true_star(iso)
    m = BinaryStarModel(iso, J=(t["mags"]["J"], 0.02))
    eep, age, feh, d, av = t["pars"]
    # secondary eep > primary -> -inf (reference starmodel.py:1618-1620)
    assert m.lnprior([eep, eep + 10, age, feh, d, av]) == -np.inf
    assert np.isfinite(m.lnprior([eep, eep - 10, age, feh, d, av]))


def test_binary_flux_sum(iso):
    """Binary lnlike at equal components = single star brightened by 2x flux."""
    t = _true_star(iso)
    eep, age, feh, d, av = t["pars"]
    J_binary = t["mags"]["J"] - 2.5 * np.log10(2.0)
    m = BinaryStarModel(iso, J=(J_binary, 0.02))
    ll = m.lnlike([eep, eep, age, feh, d, av])
    expected = LOG_ONE_OVER_ROOT_2PI + math.log(0.02)
    assert np.isclose(ll, expected, atol=1e-6)


def test_track_parameterization(track):
    m = BasicStarModel(track, Teff=(5700, 100))
    assert m.param_names == ("mass", "eep", "feh", "distance", "AV")
    ll = m.lnlike([1.0, 60.0, 0.0, 100.0, 0.0])
    assert np.isfinite(ll)
    assert np.isfinite(m.lnprior([1.0, 60.0, 0.0, 100.0, 0.0]))


def test_multiple_requires_iso(track):
    with pytest.raises(ValueError):
        BasicStarModel(track, N=2)


def test_asteroseismology(track):
    nu_max = float(track.interp_value([1.0, 60.0, 0.0], ["nu_max"]).squeeze())
    m = BasicStarModel(track, nu_max=(nu_max, 10.0), Teff=(5700, 100))
    ll = m.lnlike([1.0, 60.0, 0.0, 100.0, 0.0])
    m2 = BasicStarModel(track, Teff=(5700, 100))
    ll2 = m2.lnlike([1.0, 60.0, 0.0, 100.0, 0.0])
    expected_numax_term = LOG_ONE_OVER_ROOT_2PI + math.log(10.0)
    assert np.isclose(ll - ll2, expected_numax_term, atol=1e-8)


def test_sample_from_prior(star1_model):
    m, _ = star1_model
    df = m.sample_from_prior(50, rng=42)
    assert len(df) == 50
    assert list(df.columns) == list(m.param_names)
    lnp = np.asarray(m.lnpost_batch(jnp.asarray(df.values)))
    assert np.isfinite(lnp).all()


@pytest.mark.slow
def test_mcmc_smoke(star1_model):
    m, t = star1_model
    df = m.fit_mcmc(nwalkers=64, nburn=500, niter=100, seed=1)
    assert len(df) == 64 * 100
    assert np.isfinite(df["lnprob"]).all()
    # posterior recovers truth (toy model is exactly realizable)
    assert abs(df["eep"].median() - t["pars"][0]) < 5.0
    assert abs(df["age"].median() - t["pars"][1]) < 0.1
    assert abs(df["feh"].median() - t["pars"][2]) < 0.1
    assert abs(df["distance"].median() - t["pars"][3]) < 10.0


@pytest.mark.slow
def test_nested_smoke(iso):
    t = _true_star(iso)
    m = SingleStarModel(
        iso,
        Teff=(t["Teff"], 100.0),
        J=(t["mags"]["J"], 0.05),
        parallax=(5.0, 0.1),
        name="ns-smoke",
    )
    res = m.fit_multinest(n_live_points=50, max_iter=300, seed=2)
    assert np.isfinite(res.logz)
    assert m.evidence is not None
    assert len(m.samples) > 100
    assert abs(m.samples["distance"].median() - 200.0) < 60.0


def test_derived_samples(star1_model):
    m, _ = star1_model
    if m._samples is None:
        # enough burn-in to land near the mode: the module-scoped model's
        # samples are reused by test_posterior_predictive (chi^2/N check)
        m.fit_mcmc(nwalkers=32, nburn=200, niter=20, seed=3)
    ds = m.derived_samples
    for col in ("mass", "radius", "Teff", "logg", "parallax", "J_mag"):
        assert col in ds.columns, col
    assert np.isfinite(ds["parallax"]).all()


def test_save_load_hdf(tmp_path, star1_model):
    m, _ = star1_model
    if m._samples is None:
        m.fit_mcmc(nwalkers=32, nburn=20, niter=10, seed=4)
    fn = str(tmp_path / "model.h5")
    m.save_hdf(fn)
    m2 = BasicStarModel.load_hdf(fn, ic=m.ic)
    assert m2.name == m.name
    assert m2.N == m.N
    assert np.allclose(m2.samples.values, m.samples.values)
    assert set(m2.kwargs) == set(m.kwargs)


def test_isotrack_model(iso, track):
    t = _true_star(iso)
    eep, age, feh, d, av = t["pars"]
    mass = float(iso.interp_value([eep, age, feh], ["initial_mass"]).squeeze())
    m = IsoTrackModel(iso, track, Teff=(t["Teff"], 100.0), J=(t["mags"]["J"], 0.05))
    assert m.param_names == ("eep", "mass", "age", "feh", "distance", "AV")
    p = [eep, mass, age, feh, d, av]
    assert np.isfinite(m.lnlike(p))
    assert np.isfinite(m.lnpost(p))


def test_posterior_predictive(star1_model):
    m, _ = star1_model
    if m._samples is None:
        # enough burn-in to land near the mode — pp is chi^2/N of the samples
        m.fit_mcmc(nwalkers=32, nburn=200, niter=20, seed=5)
    pp = m.posterior_predictive
    assert np.isfinite(pp)
    assert pp < 10.0


def test_isotrack_bounds_age_from_iso_grid(iso, track):
    """IsoTrackModel age/feh bounds come from the ISO grid's axes, not the
    track grid's age data column (regression: a dead conditional sampled
    age from nanmin/nanmax of log10(star_age) ~ (0, 2))."""
    m = IsoTrackModel(iso, track, Teff=(5800.0, 100.0))
    lo, hi = m.bounds("age")
    ilo, ihi = iso.get_limits("age")
    assert (lo, hi) == (ilo, ihi)
    assert hi > 5.0  # log10(age/yr) axis range, not a stellar-age column


def test_load_hdf_syncs_prior_bounds(tmp_path, iso):
    """Restored bounds must flow through set_bounds so prior objects agree
    with the prior-transform box (regression: a non-default maxAV was
    silently rejected by lnprior after reload)."""
    t = _true_star(iso)
    m = SingleStarModel(iso, Teff=(t["Teff"], 100.0), J=(t["mags"]["J"], 0.02), maxAV=3.0)
    fn = str(tmp_path / "maxav.h5")
    m.save_hdf(fn)
    m2 = BasicStarModel.load_hdf(fn, ic=iso)
    assert m2._bounds["AV"] == (0.0, 3.0)
    assert tuple(m2._priors["AV"].bounds) == (0.0, 3.0)
    # AV above the default maxAV=1 but inside the restored (0, 3) bound
    # must survive the prior (other params at safe mid-quantiles)
    u = jnp.asarray([[0.5, 0.5, 0.5, 0.3, 0.9]])
    p = m2.prior_transform_batch(u)
    assert float(p[0, -1]) == pytest.approx(2.7)
    assert np.isfinite(m2.lnprior(np.asarray(p[0])))


def test_fit_multinest_gpu_default_batching(iso, monkeypatch):
    """On a GPU backend, fit_multinest defaults to the batched-K walk
    config (n_batch=64, n_chains=16: a wide likelihood fan-out per step),
    while explicit kwargs always win. CPU backends keep the engine
    defaults."""
    import jax

    t = _true_star(iso)
    m = SingleStarModel(iso, Teff=(t["Teff"], 100.0), J=(t["mags"]["J"], 0.02))

    seen = {}

    def fake_run_nested(lnpost, transform, n_params, key, **kwargs):
        seen.update(kwargs)
        raise _Stop

    class _Stop(Exception):
        pass

    from isochrones_tpu.samplers import nested as nested_mod

    monkeypatch.setattr(nested_mod, "run_nested", fake_run_nested)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    with pytest.raises(_Stop):
        m.fit_multinest(n_live_points=100, seed=0)
    assert seen["n_batch"] == 64 and seen["n_chains"] == 16

    seen.clear()
    with pytest.raises(_Stop):
        m.fit_multinest(n_live_points=100, seed=0, n_batch=4, n_chains=2)
    assert seen["n_batch"] == 4 and seen["n_chains"] == 2

    seen.clear()
    monkeypatch.setattr(jax, "default_backend", lambda: "cpu")
    with pytest.raises(_Stop):
        m.fit_multinest(n_live_points=100, seed=0)
    assert "n_batch" not in seen and "n_chains" not in seen
