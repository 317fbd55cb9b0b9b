"""Statistical validation of the hierarchical cluster fit (VERDICT r2 ask #2).

Round 2 smoke-tested the cluster posterior (finite lnprob); this module
asserts the fit RECOVERS truth from a SimulatedCluster and pins the three
generative-mismatch traps the validation campaign uncovered (each one
measured to corrupt a naive recovery test):

1. **IMF normalization box** — the likelihood normalizes the mass power law
   over ``mass_bounds``; fitting a (0.6, 2.0) simulation with the grid-wide
   (0.1, 10) default box biases alpha by ~+0.9.
2. **Mass-ratio measure** (``q_jacobian``) — the reference integrates
   ``pl(q)`` over the secondary-EEP measure without the |dq/deep2|
   change-of-variables factor (docs/cluster.md); the corrected measure
   integrates to exactly 1 where the reference's is ladder-scale-dependent
   (~30-70x here), dragging the single/binary balance.
3. **Ladder resolution** — integer-EEP marginalization misses sub-EEP
   single-star likelihood peaks at few-mmag precision; the binary component
   absorbs those stars and fB pins at its prior bound. ``eep_step`` and/or
   observation noise >= ladder resolution restores honesty. At noise
   matched to the ladder (0.08 mag here), fB itself is genuinely
   UNidentifiable from JHK photometry (measured per-star binary/single
   marginal ratios ~ +-0.3 nats even for q = 0.93 pairs), so the recovery
   assertions cover the six identifiable shared parameters and exclude fB.

Bracketing statistics: a calibrated 68% interval misses truth ~1/3 of the
time per parameter, so the hard assertion is the central 95% interval plus
a majority vote on the 68% intervals.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from isochrones_tpu import get_ichrone
from isochrones_tpu.cluster import SimulatedCluster, StarClusterModel
from isochrones_tpu.priors import FlatPrior

TRUTH = dict(age=9.0, feh=0.0, distance=500.0, AV=0.05, alpha=-2.0, gamma=0.3, fB=0.3)


@pytest.fixture(scope="module")
def iso():
    return get_ichrone("synthetic", n_feh=7, n_mass=30, n_eep=100, n_age=30)


@pytest.fixture(scope="module")
def fitted(iso):
    sim = SimulatedCluster(
        48, ic=iso, **TRUTH, rng=11, bands=("J", "H", "K"),
        mass_range=(0.6, 2.0), phot_unc=0.08, distance_scatter=0.0,
    )
    model = StarClusterModel(
        iso, sim, eep_bounds=(1, 90), max_distance=2000, minq=0.2,
        max_AV=0.3, mass_bounds=(0.6, 2.0), q_jacobian=True,
    )
    model.set_prior(feh=FlatPrior((-0.5, 0.5)))
    p_true = np.array([TRUTH[k] for k in model.param_names])
    assert np.isfinite(model.lnlike(p_true))
    rng = np.random.default_rng(0)
    p0 = p_true[None] + rng.normal(
        0, [0.03, 0.03, 8.0, 0.02, 0.2, 0.05, 0.05], size=(32, 7)
    )
    p0[:, 6] = np.clip(p0[:, 6], 0.05, 0.55)
    p0[:, 3] = np.abs(p0[:, 3])
    df = model.fit_mcmc(
        nwalkers=32, nburn=300, niter=300, thin=2, p0=p0, seed=4, moves="mixed"
    )
    return model, df


SHARED = ("age", "feh", "distance", "AV", "alpha", "gamma")


@pytest.mark.slow
def test_cluster_recovery_quantiles(fitted):
    """Truth inside the central 95% for every identifiable shared parameter;
    inside 16-84% for the majority (expected hit rate 68% per parameter)."""
    model, df = fitted
    in95, in68 = {}, {}
    for k in SHARED:
        q02, q16, q84, q98 = np.percentile(df[k].values, [2, 16, 84, 98])
        t = TRUTH[k]
        in95[k] = q02 <= t <= q98
        in68[k] = q16 <= t <= q84
    assert all(in95.values()), f"95% interval misses truth: {in95}"
    assert sum(in68.values()) >= 4, f"68% bracketing below majority: {in68}"


@pytest.mark.slow
def test_cluster_recovery_core_parameters_tight(fitted):
    """The well-identified shared parameters land close to truth in
    absolute terms (measured medians on this fixture: age 9.08, feh 0.21,
    distance 498, AV 0.056)."""
    model, df = fitted
    med = df.median()
    assert abs(med["age"] - TRUTH["age"]) < 0.15
    assert abs(med["feh"] - TRUTH["feh"]) < 0.35
    assert abs(med["distance"] - TRUTH["distance"]) < 0.05 * TRUTH["distance"]
    assert abs(med["AV"] - TRUTH["AV"]) < 0.1


def test_q_measure_normalization(iso):
    """The corrected mass-ratio measure integrates to ~1 for every primary;
    the reference's (no |dq/deep2|) integral is ladder-scale-dependent and
    ~30-70x inflated — the mechanism behind the fB distortion."""
    from isochrones_tpu.ops.interp import interp_nd

    model = iso.model
    ci = model.column_index
    eeps = np.arange(1.0, 91.0)
    n = len(eeps)
    io = iso._param_index_order
    user = [eeps, np.full(n, 9.0), np.full(n, 0.0)]
    grid_pts = jnp.stack(
        [jnp.asarray(user[io[0]]), jnp.asarray(user[io[1]]), jnp.asarray(user[io[2]])],
        axis=-1,
    )
    mv = np.asarray(interp_nd(
        model.values, model.knots, grid_pts,
        icols=(ci["initial_mass"], ci["dm_deep"]), axis_maps=model.axis_maps,
    ))
    masses, ln_dm = mv[:, 0], np.log(np.abs(mv[:, 1]))
    gamma, q_lo = 0.3, 0.2
    g1 = gamma + 1.0
    c_q = g1 / (1.0 - q_lo ** g1)
    refs, corrs = [], []
    for j in (30, 50, 70):
        q = masses[: j + 1] / masses[j]
        ok = (q >= q_lo) & np.isfinite(q)
        pl = c_q * q ** gamma
        refs.append(np.trapezoid(np.where(ok, pl, 0.0), eeps[: j + 1]))
        corrs.append(np.trapezoid(
            np.where(ok, pl * np.exp(ln_dm[: j + 1]) / masses[j], 0.0), eeps[: j + 1]
        ))
    np.testing.assert_allclose(corrs, 1.0, atol=0.05)
    assert min(refs) > 10 and max(refs) / min(refs) > 1.5, refs


def test_eep_step_resolves_single_peaks(iso):
    """A finer marginalization ladder strictly raises lnlike at truth when
    photometric precision out-resolves integer EEP spacing (the trapezoid
    recovers the missed single-star peaks; measured +13 nats here)."""
    sim = SimulatedCluster(
        12, ic=iso, **TRUTH, rng=11, bands=("J", "K"),
        mass_range=(0.6, 2.0), phot_unc=0.02, distance_scatter=0.0,
    )
    p = [TRUTH[k] for k in StarClusterModel._cluster_param_names]
    lnl = {}
    for step in (1.0, 0.5):
        m = StarClusterModel(
            iso, sim, eep_bounds=(1, 90), max_distance=2000, minq=0.2,
            mass_bounds=(0.6, 2.0), q_jacobian=True, eep_step=step,
        )
        lnl[step] = float(m.lnlike(p))
    assert lnl[0.5] > lnl[1.0] + 5.0, lnl


@pytest.mark.slow
def test_cluster_nested_fit_dynamic_default_recovers(iso, monkeypatch):
    """The NS driver path (`model.fit()` -> fit_multinest), which now
    defaults to DYNAMIC nested sampling for cluster models,
    recovers the simulation truth: the central 95% interval brackets every
    identifiable shared parameter, and the result really ran the dynamic
    machinery."""
    import isochrones_tpu.samplers.nested as nested

    captured = {}
    orig = nested.run_nested
    monkeypatch.setattr(
        nested, "run_nested",
        lambda *a, **kw: (captured.update(kw), orig(*a, **kw))[1],
    )
    # much smaller than the MCMC fixture: the dynamic-NS cluster fit is the
    # most expensive slow-tier path on a single CPU core (48 stars x 90-EEP
    # exceeded 50 min; 20 stars still did) — 10 stars on a 60-EEP ladder
    # keeps the same machinery tractable
    sim = SimulatedCluster(
        10, ic=iso, **TRUTH, rng=11, bands=("J", "H", "K"),
        mass_range=(0.6, 1.4), phot_unc=0.08, distance_scatter=0.0,
    )
    model = StarClusterModel(
        iso, sim, eep_bounds=(1, 60), max_distance=2000, minq=0.2,
        max_AV=0.3, mass_bounds=(0.6, 1.4), q_jacobian=True,
    )
    model.set_prior(feh=FlatPrior((-0.5, 0.5)))
    p_true = np.array([TRUTH[k] for k in model.param_names])
    assert np.isfinite(model.lnlike(p_true))  # truth inside ladder support
    res = model.fit(n_live_points=100, seed=3, min_ess=250)
    assert captured.get("dynamic") is True  # the dynamic default took effect
    assert np.isfinite(res.logz)
    assert res.ess >= 250
    df = model.samples
    missed = {}
    for k in SHARED:
        q02, q98 = np.percentile(df[k].values, [2, 98])
        if not (q02 <= TRUTH[k] <= q98):
            missed[k] = (q02, TRUTH[k], q98)
    assert not missed, f"95% interval misses truth: {missed}"
