"""Cluster kernel + model tests.

Kernel parity uses a direct NumPy loop oracle implementing the reference
semantics (cluster_utils.py:30-128); model tests simulate a synthetic cluster
and check the 7-parameter likelihood peaks at truth.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from isochrones_tpu import get_ichrone
from isochrones_tpu.catalog import StarCatalog
from isochrones_tpu.cluster import SimulatedCluster, StarClusterModel, simulate_cluster
from isochrones_tpu.ops.cluster import calc_lnlike_grid, integrate_over_eeps


def _oracle_grid(lnlike_prop, model_mags, masses, ln_dm, eeps, vals, uncs,
                 alpha, gamma, fB, mass_lo, mass_hi, q_lo):
    """Reference-semantics loop oracle (math from cluster_utils.py:30-105)."""
    def pl_lnpdf(x, a, lo, hi):
        a1 = a + 1.0
        C = a1 / (hi ** a1 - lo ** a1)
        return np.log(C) + a * np.log(x)

    n = len(model_mags)
    n_stars = len(vals)
    n_bands = model_mags.shape[1]
    out = np.full((n_stars, n, n), -np.inf)
    for i in range(n_stars):
        for j in range(n):
            for k in range(j + 1):
                if masses[k] / masses[j] < q_lo:
                    continue
                lp = 0.0
                for b in range(n_bands):
                    f1 = 10 ** (-0.4 * model_mags[j, b])
                    f2 = 10 ** (-0.4 * model_mags[k, b])
                    tot = -2.5 * np.log10(f1 + f2)
                    rb = tot - vals[i, b]
                    lb = -0.5 * rb * rb / uncs[i, b] ** 2
                    rs = model_mags[j, b] - vals[i, b]
                    ls = -0.5 * rs * rs / uncs[i, b] ** 2
                    lp += np.logaddexp(np.log(fB) + lb, np.log(1 - fB) + ls)
                lm = pl_lnpdf(masses[j], alpha, mass_lo, mass_hi) + ln_dm[j]
                lq = pl_lnpdf(masses[k] / masses[j], gamma, q_lo, 1.0)
                out[i, j, k] = lp + lm + lq + lnlike_prop[i, j]
    return out


def _oracle_integrate(grid, eeps):
    """cluster_utils.py:108-128 semantics."""
    n_stars, n, _ = grid.shape
    out = np.zeros(n_stars)
    for i in range(n_stars):
        row = np.zeros(n)
        for j in range(n):
            tot = 0.0
            for k in range(j):
                tot += 0.5 * (np.exp(grid[i, j, k]) + np.exp(grid[i, j, k + 1])) * (eeps[k + 1] - eeps[k])
            row[j] = tot
        out[i] = np.trapezoid(row, eeps)
    return out


def test_kernel_parity():
    rng = np.random.default_rng(0)
    n_eep, n_bands, n_stars = 12, 3, 4
    eeps = np.arange(n_eep, dtype=float) + 10
    model_mags = rng.normal(8, 1, (n_eep, n_bands))
    masses = np.sort(rng.uniform(0.5, 2.0, n_eep))
    ln_dm = rng.normal(-4, 0.3, n_eep)
    lnlike_prop = rng.normal(-1, 0.5, (n_stars, n_eep))
    vals = rng.normal(8, 1, (n_stars, n_bands))
    uncs = np.full((n_stars, n_bands), 0.05)
    alpha, gamma, fB, mass_lo, mass_hi, q_lo = (-2.0, 0.3, 0.4, 0.3, 3.0, 0.2)

    grid = np.asarray(
        calc_lnlike_grid(
            jnp.asarray(lnlike_prop), jnp.asarray(model_mags), jnp.asarray(masses),
            jnp.asarray(ln_dm), jnp.asarray(vals), jnp.asarray(uncs),
            alpha, gamma, fB, mass_lo, mass_hi, q_lo,
        )
    )
    oracle = _oracle_grid(lnlike_prop, model_mags, masses, ln_dm, eeps, vals, uncs,
                          alpha, gamma, fB, mass_lo, mass_hi, q_lo)
    finite = np.isfinite(oracle)
    assert (np.isfinite(grid) == finite).all()
    assert np.allclose(grid[finite], oracle[finite], rtol=1e-10)

    marg = np.asarray(integrate_over_eeps(jnp.asarray(grid), jnp.asarray(eeps)))
    marg_oracle = _oracle_integrate(oracle, eeps)
    assert np.allclose(marg, marg_oracle, rtol=1e-10)


def test_q_jacobian_correction():
    """q_jacobian=True adds exactly ln|dq/deep2| = ln_dm[k] - ln m_j to the
    mass-ratio term (the change-of-variables factor the reference omits,
    cluster_utils.py:101), in both the XLA grid and the pallas marginal."""
    from isochrones_tpu.ops.cluster import cluster_lnmarginal

    rng = np.random.default_rng(3)
    n_eep, n_bands, n_stars = 12, 2, 3
    eeps = np.arange(n_eep, dtype=float) + 10
    model_mags = rng.normal(8, 1, (n_eep, n_bands))
    masses = np.sort(rng.uniform(0.5, 2.0, n_eep))
    ln_dm = rng.normal(-4, 0.3, n_eep)
    lnlike_prop = rng.normal(-1, 0.5, (n_stars, n_eep))
    vals = rng.normal(8, 1, (n_stars, n_bands))
    uncs = np.full((n_stars, n_bands), 0.05)
    args = (
        jnp.asarray(lnlike_prop), jnp.asarray(model_mags), jnp.asarray(masses),
        jnp.asarray(ln_dm), jnp.asarray(vals), jnp.asarray(uncs),
        -2.0, 0.3, 0.4, 0.3, 3.0, 0.2,
    )
    plain = np.asarray(calc_lnlike_grid(*args))
    corr = np.asarray(calc_lnlike_grid(*args, q_jacobian=True))
    jac = ln_dm[None, :] - np.log(masses)[:, None]  # (j, k)
    finite = np.isfinite(plain)
    np.testing.assert_allclose(
        corr[finite], (plain + jac[None])[finite], rtol=1e-12
    )
    # pallas(interpret) marginal agrees with the XLA marginal in this mode
    margs = {}
    for up in (False, True):
        margs[up] = np.asarray(cluster_lnmarginal(
            args[0], args[1], args[2], args[3], jnp.asarray(eeps), args[4], args[5],
            -2.0, 0.3, 0.4, 0.3, 3.0, 0.2, use_pallas=up, q_jacobian=True,
            interpret=up,
        ))
    np.testing.assert_allclose(margs[True], margs[False], rtol=1e-6)


@pytest.fixture(scope="module")
def sim():
    ic = get_ichrone("synthetic", n_feh=7, n_mass=30, n_eep=100, n_age=30)
    return SimulatedCluster(
        30, age=9.0, feh=0.0, distance=500.0, AV=0.05, alpha=-2.0, gamma=0.3, fB=0.3,
        bands=("J", "H", "K"), mass_range=(0.5, 3.0), distance_scatter=2.0,
        ic=ic, rng=42, phot_unc=0.02,
    )


def test_simulated_cluster(sim):
    assert len(sim) == 30
    df = sim.df
    for c in ("J_mag", "H_mag", "K_mag", "J_mag_unc", "parallax", "mass_pri", "is_binary"):
        assert c in df.columns
    assert np.isfinite(df["J_mag"]).all()
    # binaries are brighter than the equivalent single primary
    assert (df.mass_sec[df.is_binary] > 0).all()


def test_cluster_model_lnlike(sim):
    model = StarClusterModel(
        sim.ic, sim, eep_bounds=(1, 95), max_distance=2000, minq=0.2, max_AV=0.2,
    )
    truth = [9.0, 0.0, 500.0, 0.05, -2.0, 0.3, 0.3]
    ll_truth = model.lnlike(truth)
    assert np.isfinite(ll_truth)
    assert np.isfinite(model.lnprior(truth))
    # wrong age should be much worse
    wrong = [8.0, 0.0, 500.0, 0.05, -2.0, 0.3, 0.3]
    assert model.lnlike(wrong) < ll_truth
    wrong_d = [9.0, 0.0, 900.0, 0.05, -2.0, 0.3, 0.3]
    assert model.lnlike(wrong_d) < ll_truth


def test_cluster_batch_eval(sim):
    model = StarClusterModel(sim.ic, sim, eep_bounds=(1, 95), max_distance=2000, minq=0.2)
    rng = np.random.default_rng(1)
    batch = np.array([9.0, 0.0, 500.0, 0.05, -2.0, 0.3, 0.3]) + rng.normal(
        0, [0.02, 0.02, 5.0, 0.01, 0.1, 0.02, 0.02], size=(4, 7)
    )
    lnp = np.asarray(model.lnpost_batch(jnp.asarray(batch)))
    for i in range(4):
        assert np.isclose(lnp[i], model.lnpost(batch[i]), rtol=1e-8, equal_nan=True)


@pytest.mark.slow
def test_cluster_fit_smoke(sim):
    model = StarClusterModel(
        sim.ic, sim, eep_bounds=(1, 95), max_distance=2000, minq=0.2, max_AV=0.2,
    )
    df = model.fit_mcmc(nwalkers=16, nburn=40, niter=10, seed=0)
    assert np.isfinite(df["lnprob"]).all()
    assert len(df) == 16 * 10


def test_simulate_cluster_function():
    ic = get_ichrone("synthetic", n_feh=7, n_mass=30, n_eep=100, n_age=30)
    cat = simulate_cluster(20, 9.0, 0.0, 400.0, 0.05, -2.2, 0.3, 0.4, iso=ic, rng=1)
    assert isinstance(cat, StarCatalog)
    assert len(cat) == 20
    assert "age" in cat.df.columns


def test_catalog_iter_models(sim):
    mods = list(sim.iter_models(ic=sim.ic, N=1))
    assert len(mods) == 30
    m = mods[0]
    assert set(m.bands) == {"J", "H", "K"}
    assert "parallax" in m.kwargs


def test_catalog_write_ini(tmp_path, sim):
    dirs = sim.write_ini(ic=sim.ic, root=str(tmp_path), N=1)
    assert len(dirs) == 30
    import os

    assert os.path.exists(os.path.join(dirs[0], "star.ini"))


def test_simulated_cluster_no_dead_stars():
    """Masses evolved past their track end must be redrawn: NaN photometry
    rows poison the whole cluster likelihood."""
    ic = get_ichrone("synthetic", n_feh=7, n_mass=30, n_eep=100, n_age=30)
    sim = SimulatedCluster(
        40, age=9.6, feh=0.0, distance=400.0, AV=0.05, alpha=-2.0, gamma=0.3, fB=0.3,
        bands=("J", "H", "K"), mass_range=(0.5, 9.0),  # top masses dead at this age
        ic=ic, rng=3, phot_unc=0.02,
    )
    mags = sim.df[["J_mag", "H_mag", "K_mag"]]
    assert not mags.isna().any(axis=1).any()
    model = StarClusterModel(ic, sim, eep_bounds=(1, 99), max_distance=2000, minq=0.2)
    ll = model.lnlike([9.6, 0.0, 400.0, 0.05, -2.0, 0.3, 0.3])
    assert np.isfinite(ll)


@pytest.mark.slow
def test_cluster_star_sharding(sim):
    """Star-sharded cluster lnlike over an 8-device mesh == unsharded
    (30 stars -> 2 ghost-star pads)."""
    from isochrones_tpu.parallel import default_mesh

    mesh = default_mesh(8, axis_names=("stars",))
    plain = StarClusterModel(sim.ic, sim, eep_bounds=(1, 95), max_distance=2000, minq=0.2)
    sharded = StarClusterModel(sim.ic, sim, eep_bounds=(1, 95), max_distance=2000,
                               minq=0.2, mesh=mesh)
    for p in (
        [9.0, 0.0, 500.0, 0.05, -2.0, 0.3, 0.3],
        [8.8, -0.1, 480.0, 0.1, -2.5, 0.35, 0.2],
    ):
        a = plain.lnlike(p)
        b = sharded.lnlike(p)
        assert np.isclose(a, b, rtol=1e-10), (a, b)
    # batched path too
    batch = np.array([[9.0, 0.0, 500.0, 0.05, -2.0, 0.3, 0.3],
                      [8.9, 0.05, 510.0, 0.08, -2.2, 0.28, 0.25]])
    np.testing.assert_allclose(
        np.asarray(sharded.lnpost_batch(jnp.asarray(batch))),
        np.asarray(plain.lnpost_batch(jnp.asarray(batch))),
        rtol=1e-10,
    )


def test_lnlike_dataset_matches_catalog_lnlike(sim):
    """The dataset-parametric lnlike (observations as ARGUMENTS — the hook
    for vmapping M simulated replicas into one program, e.g. cluster SBC)
    must agree exactly with the catalog-built lnlike on the model's own
    stacked data."""
    model = StarClusterModel(
        sim.ic, sim, eep_bounds=(1, 95), max_distance=2000, minq=0.2, max_AV=0.2
    )
    mv, mu, pv, pu = (jnp.asarray(x) for x in sim.observation_stacks())

    lnlike_ds = model._build_lnlike_dataset()
    rng = np.random.default_rng(5)
    pts = np.array([9.0, 0.0, 500.0, 0.05, -2.0, 0.3, 0.3]) + 0.02 * rng.standard_normal((6, 7))
    got = np.asarray(
        jnp.stack([lnlike_ds(jnp.asarray(p), mv, mu, pv, pu) for p in pts])
    )
    want = np.asarray(model.lnlike_batch(jnp.asarray(pts)))
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_integrate_underflow_safe():
    """A grid whose max sits below exp-underflow (-745 in f64) must yield a
    finite ln-marginal, not -inf — prior-box distance/age edges reach this
    regime and a sampler would see a spurious zero-support region there.
    (The reference's exp-space trapezoid underflows; both our backends
    max-shift.)"""
    from isochrones_tpu.ops.cluster import integrate_over_eeps_ln

    rng = np.random.default_rng(1)
    eeps = jnp.asarray(np.arange(10.0, 22.0))
    grid = jnp.asarray(rng.normal(-2000.0, 5.0, (3, 12, 12)))
    # keep the reference's lower-triangle support pattern
    tri = np.tril(np.ones((12, 12), dtype=bool), k=-1)
    grid = jnp.where(jnp.asarray(tri)[None], grid, -jnp.inf)
    lnm = np.asarray(integrate_over_eeps_ln(grid, eeps))
    assert np.isfinite(lnm).all()
    assert (lnm < -1900).all()
    # shift-invariance: adding a constant shifts the ln-marginal exactly
    lnm_up = np.asarray(integrate_over_eeps_ln(grid + 1500.0, eeps))
    np.testing.assert_allclose(lnm_up, lnm + 1500.0, rtol=1e-12)
    # all -inf (genuinely empty support) still returns -inf
    empty = jnp.full((2, 12, 12), -jnp.inf)
    assert (np.asarray(integrate_over_eeps_ln(empty, eeps)) == -np.inf).all()


def test_star_lnmarginals_support_diagnostic(sim):
    """star_lnmarginals names the members that poison a cluster fit —
    the all-or-nothing trap the reference shares silently."""
    truth = [9.0, 0.0, 500.0, 0.05, -2.0, 0.3, 0.3]

    # full-coverage ladder: every member supported, total finite
    wide = StarClusterModel(
        sim.ic, sim, eep_bounds=(1, 95), max_distance=2000, minq=0.2, max_AV=0.2
    )
    marg_wide = wide.star_lnmarginals(truth)
    assert len(marg_wide) == len(sim.df)
    assert np.isfinite(marg_wide.values).all()
    # the sum of per-star marginals IS the cluster lnlike
    assert np.isclose(marg_wide.values.sum(), wide.lnlike(truth), rtol=1e-6)

    # truncated ladder: evolved members can't be matched anywhere on the
    # ladder — with the underflow-safe integration their marginals stay
    # FINITE but crater (the reference returns -inf here), and the
    # diagnostic points at the most evolved (most massive) members
    narrow = StarClusterModel(
        sim.ic, sim, eep_bounds=(1, 35), max_distance=2000, minq=0.2, max_AV=0.2
    )
    marg_narrow = narrow.star_lnmarginals(truth)
    assert np.isfinite(marg_narrow.values).all()
    bad = marg_narrow.values < -1e3
    assert bad.any(), "expected truncated-ladder members to crater"
    masses = sim.df["mass_pri"].values
    assert masses[bad].min() > np.median(masses[~bad])

    # genuinely empty support (NaN photometry) is the -inf case the
    # clusterfit probe warning names
    import pandas as pd
    from isochrones_tpu.catalog import StarCatalog

    df = sim.df.copy()
    df.loc[df.index[3], "J_mag"] = np.nan
    cat = StarCatalog(df, bands=("J", "H", "K"), props=("parallax",))
    poisoned = StarClusterModel(
        sim.ic, cat, eep_bounds=(1, 95), max_distance=2000, minq=0.2, max_AV=0.2
    )
    marg_bad = poisoned.star_lnmarginals(truth)
    assert not np.isfinite(marg_bad.values[3])  # NaN photometry -> NaN marginal
    assert np.isfinite(np.delete(marg_bad.values, 3)).all()
    assert poisoned.lnlike(truth) == -np.inf


def test_cluster_fit_defaults_to_dynamic(monkeypatch):
    """StarClusterModel.fit_multinest defaults dynamic=True (the cluster
    marginal is expensive per call — the measured regime where
    dynamic NS's call saving is real wall-clock); explicit dynamic=False
    and n_runs>1 both override."""
    from isochrones_tpu import get_ichrone
    from isochrones_tpu.cluster import SimulatedCluster, StarClusterModel
    import isochrones_tpu.starmodel as sm

    iso = get_ichrone("synthetic", n_feh=5, n_mass=20, n_eep=60, n_age=20)
    sim = SimulatedCluster(
        6, age=9.0, feh=0.0, distance=300.0, AV=0.05, alpha=-2.0, gamma=0.3,
        fB=0.3, bands=("J", "K"), mass_range=(0.6, 2.0), ic=iso, rng=0,
    )
    model = StarClusterModel(iso, sim, eep_bounds=(1, 50), max_distance=2000)

    captured = {}

    def fake_run_nested(*a, **kw):
        captured.update(kw)
        raise RuntimeError("stop-at-engine")

    monkeypatch.setattr("isochrones_tpu.samplers.nested.run_nested", fake_run_nested)
    with pytest.raises(RuntimeError, match="stop-at-engine"):
        model.fit_multinest(n_live_points=50)
    assert captured.get("dynamic") is True

    captured.clear()
    with pytest.raises(RuntimeError, match="stop-at-engine"):
        model.fit_multinest(n_live_points=50, dynamic=False)
    assert captured.get("dynamic") is False

    captured.clear()
    with pytest.raises(RuntimeError, match="stop-at-engine"):
        model.fit_multinest(n_live_points=50, n_runs=2)
    assert "dynamic" not in captured  # n_runs>1 is incompatible with dynamic
