"""f32/f64 tolerance guardrail (SURVEY §7 "fp precision" hard part).

The shipped accelerator configuration stores grids in float32 (bench.py, config.py
DEFAULT_DTYPE) while the reference — and the round-1 test suite — is float64
throughout. These tests certify the dtype the benchmark ships: f32 grids must
give lnpost within absolute tolerance of f64 on MIST-scale synthetic grids,
and (slow) a full MCMC fit's posterior quantiles must agree within
Monte-Carlo error.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from isochrones_tpu import get_ichrone
from isochrones_tpu.starmodel import BinaryStarModel, SingleStarModel

GRID_KW = dict(n_feh=15, n_mass=96, n_eep=856, n_age=54)


@pytest.fixture(scope="module")
def iso_pair():
    iso64 = get_ichrone("synthetic", dtype=np.float64, **GRID_KW)
    iso32 = get_ichrone("synthetic", dtype=np.float32, **GRID_KW)
    return iso64, iso32


def _model(iso, cls=SingleStarModel, pars=(350.0, 9.0, 0.0, 200.0, 0.1)):
    bands = ["J", "H", "K"]
    Teff, logg, _, mags = iso.interp_mag(list(pars), bands)
    kw = dict(
        Teff=(float(Teff), 100.0),
        logg=(float(logg), 0.1),
        parallax=(1000.0 / pars[3], 0.05),
    )
    for b, m in zip(bands, np.asarray(mags)):
        kw[b] = (float(m), 0.02)
    return cls(iso, **kw)


def _walker_batch(rng, base, scales, n):
    base = np.asarray(base)
    return base[None, :] + rng.normal(0, scales, size=(n, len(base)))


def test_interp_mag_f32_close_to_f64(iso_pair):
    iso64, iso32 = iso_pair
    rng = np.random.default_rng(0)
    pts = np.stack(
        [
            rng.uniform(50, 700, 512),
            rng.uniform(8.2, 9.9, 512),
            rng.uniform(-0.4, 0.4, 512),
            rng.uniform(50, 500, 512),
            rng.uniform(0, 0.8, 512),
        ],
        axis=-1,
    )
    _, _, _, m64 = iso64.interp_mag(pts.T.tolist())
    _, _, _, m32 = iso32.interp_mag(pts.T.tolist())
    m64, m32 = np.asarray(m64), np.asarray(m32)
    finite64 = np.isfinite(m64)
    finite32 = np.isfinite(m32)
    # NaN masks agree except possibly at cell boundaries straddled by rounding
    assert (finite64 == finite32).mean() > 0.995
    both = finite64 & finite32
    assert both.any()
    # mags agree to well under a milli-mag (obs uncertainties are >= 0.01 mag)
    assert np.max(np.abs(m64[both] - m32[both])) < 5e-4


def test_lnpost_f32_close_to_f64(iso_pair):
    iso64, iso32 = iso_pair
    m64 = _model(iso64)
    m32 = _model(iso32)
    rng = np.random.default_rng(1)
    batch = _walker_batch(rng, [350.0, 9.0, 0.0, 200.0, 0.1], [10.0, 0.05, 0.05, 5.0, 0.02], 1024)
    lnp64 = np.asarray(m64.lnpost_batch(jnp.asarray(batch)))
    lnp32 = np.asarray(m32.lnpost_batch(jnp.asarray(batch.astype(np.float32))))
    f64, f32_ = np.isfinite(lnp64), np.isfinite(lnp32)
    assert (f64 == f32_).mean() > 0.995
    both = f64 & f32_
    assert both.sum() > 100
    # absolute lnpost tolerance: posterior-shape distortion below sampler noise
    err = np.abs(lnp64[both] - lnp32[both])
    assert np.median(err) < 5e-3, np.median(err)
    assert np.quantile(err, 0.99) < 0.1, np.quantile(err, 0.99)


def test_binary_lnpost_f32_close_to_f64(iso_pair):
    iso64, iso32 = iso_pair
    m64 = _model(iso64, cls=BinaryStarModel)
    m32 = _model(iso32, cls=BinaryStarModel)
    rng = np.random.default_rng(2)
    batch = _walker_batch(
        rng, [350.0, 300.0, 9.0, 0.0, 200.0, 0.1], [10.0, 10.0, 0.05, 0.05, 5.0, 0.02], 1024
    )
    lnp64 = np.asarray(m64.lnpost_batch(jnp.asarray(batch)))
    lnp32 = np.asarray(m32.lnpost_batch(jnp.asarray(batch.astype(np.float32))))
    both = np.isfinite(lnp64) & np.isfinite(lnp32)
    assert both.sum() > 100
    err = np.abs(lnp64[both] - lnp32[both])
    assert np.median(err) < 5e-3, np.median(err)
    assert np.quantile(err, 0.99) < 0.1, np.quantile(err, 0.99)


@pytest.mark.slow
def test_fit_posterior_f32_matches_f64(iso_pair):
    """Posterior quantiles from an f32-grid fit match the f64-grid fit within
    Monte-Carlo error — the dtype the accelerator benchmark ships is certified at the
    posterior level, not just pointwise lnpost."""
    iso64, iso32 = iso_pair
    m64 = _model(iso64)
    m32 = _model(iso32)
    df64 = m64.fit_mcmc(nwalkers=128, nburn=800, niter=120, seed=5, moves="mixed")
    df32 = m32.fit_mcmc(nwalkers=128, nburn=800, niter=120, seed=6, moves="mixed")
    for p in m64.param_names:
        q64 = np.quantile(df64[p].values, [0.16, 0.5, 0.84])
        q32 = np.quantile(df32[p].values, [0.16, 0.5, 0.84])
        scale = max(0.5 * (q64[2] - q64[0]), 1e-12)
        delta = np.abs(q32 - q64) / scale
        assert np.all(delta < 0.35), f"{p}: {q32} vs {q64} (delta/sigma={delta})"
