"""Simulation-based calibration (SBC) of the nested-sampling posterior.

The strongest end-to-end correctness check available without real data
(Talts et al. 2018): draw truths from the model's own prior, generate
observations from the forward model at each truth, fit every dataset, and
rank each truth within its posterior samples. If (and only if) the whole
pipeline — prior sampling, forward model, likelihood, sampler — is
self-consistent, the ranks are uniform on [0, 1].

This exercises the exact acceptance bar of SURVEY §7 stage 6 (posterior
correctness, reference starmodel.py:717-802) as a *distributional* property
over many fits, not a single-fixture quantile check. The whole M-dataset
ensemble fits in ONE vmapped nested-sampling program (BatchStarFitter),
which is the reason this test is affordable at all.
"""

import numpy as np
import pandas as pd
import pytest
from scipy import stats

import jax.numpy as jnp

from isochrones_tpu import get_ichrone
from isochrones_tpu.batch import BatchStarFitter
from isochrones_tpu.catalog import StarCatalog

BANDS = ("J", "H", "K")
MAG_UNC = 0.02
TEFF_UNC = 80.0
M_STARS = 32


@pytest.mark.slow
def test_sbc_ranks_uniform():
    iso = get_ichrone("synthetic", n_feh=7, n_mass=30, n_eep=100, n_age=30)
    rng = np.random.default_rng(7)

    # -- dummy fitter: same constructor args as the real one (identical
    # priors), placeholder observations with huge uncertainties so
    # sample_p0's finite-lnpost rejection only enforces model validity.
    # NO parallax anywhere: a parallax column would give the real fitter a
    # per-star distance bound the generator didn't use (prior mismatch).
    dummy_rows = {f"{b}_mag": np.full(M_STARS, 10.0) for b in BANDS}
    dummy_rows.update({f"{b}_mag_unc": 1e6 for b in BANDS})
    dummy_rows["Teff"] = np.full(M_STARS, 5000.0)
    dummy_rows["Teff_unc"] = 1e6
    dummy_cat = StarCatalog(pd.DataFrame(dummy_rows), bands=BANDS, props=("Teff",))
    gen = BatchStarFitter(iso, dummy_cat, max_distance=1000.0)
    truths = gen.sample_p0(1, rng=rng)[:, 0, :]  # (M, 5) prior draws

    # -- forward model + observation noise at each truth
    Teff, _, _, mags = iso.interp_mag(
        [truths[:, 0], truths[:, 1], truths[:, 2], truths[:, 3], truths[:, 4]],
        list(BANDS),
    )
    mags = np.asarray(mags)
    rows = {}
    for i, b in enumerate(BANDS):
        rows[f"{b}_mag"] = mags[:, i] + rng.normal(0, MAG_UNC, M_STARS)
        rows[f"{b}_mag_unc"] = MAG_UNC
    rows["Teff"] = np.asarray(Teff) + rng.normal(0, TEFF_UNC, M_STARS)
    rows["Teff_unc"] = TEFF_UNC
    cat = StarCatalog(pd.DataFrame(rows), bands=BANDS, props=("Teff",))

    fitter = BatchStarFitter(iso, cat, max_distance=1000.0)
    res = fitter.fit_multinest(n_live_points=300, n_batch=8, seed=11)
    assert np.isfinite(res["logz"]).all()
    samples = fitter.samples  # (M, n_equal, 5)

    # -- rank of each truth within its posterior; uniform iff calibrated
    ranks = np.mean(samples < truths[:, None, :], axis=1)  # (M, 5)
    for j, name in enumerate(fitter.param_names):
        r = ranks[:, j]
        ks = stats.kstest(r, "uniform")
        # M=32: KS 1% critical value ~0.28; a mis-calibrated posterior
        # (e.g. 2x-too-narrow errors piles ranks at 0/1) fails decisively
        assert ks.pvalue > 0.005, f"{name}: ranks not uniform (p={ks.pvalue:.4f}, ranks={np.sort(r)})"
        assert abs(r.mean() - 0.5) < 0.2, f"{name}: rank mean {r.mean():.2f} biased"
