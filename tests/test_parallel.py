"""Multi-chip (virtual 8-device CPU mesh) sharding tests."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from isochrones_tpu import get_ichrone
from isochrones_tpu.parallel import default_mesh, pad_to_multiple, replicate, shard_batch, sharded_lnpost
from isochrones_tpu.starmodel import SingleStarModel


@pytest.fixture(scope="module")
def model():
    iso = get_ichrone("synthetic", n_feh=7, n_mass=30, n_eep=100, n_age=30)
    Teff, logg, _, mags = iso.interp_mag([60.0, 9.0, 0.0, 200.0, 0.1], ["J", "H", "K"])
    return SingleStarModel(
        iso, Teff=(Teff, 100.0), logg=(logg, 0.1),
        J=(float(mags[0]), 0.02), parallax=(5.0, 0.05),
    )


def test_eight_devices():
    assert len(jax.devices()) == 8, "conftest must provide 8 virtual CPU devices"


def test_sharded_lnpost_matches(model):
    mesh = default_mesh(8)
    rng = np.random.default_rng(0)
    batch = np.array([60.0, 9.0, 0.0, 200.0, 0.1]) + rng.normal(
        0, [3.0, 0.03, 0.03, 3.0, 0.02], size=(64, 5)
    )
    ref = np.asarray(model.lnpost_batch(jnp.asarray(batch)))
    sharded_fn = sharded_lnpost(model.lnpost_batch, mesh)
    out = np.asarray(sharded_fn(shard_batch(jnp.asarray(batch), mesh)))
    np.testing.assert_allclose(out, ref, rtol=1e-12)


@pytest.mark.slow
def test_sharded_fit_mcmc_matches_unsharded(model):
    """Same PRNG key + sharded walkers -> bitwise-deterministic chain."""
    mesh = default_mesh(8)
    p0 = model.emcee_p0(32, rng=7)
    df_plain = model.fit_mcmc(nwalkers=32, nburn=10, niter=10, p0=p0, seed=3)
    df_shard = model.fit_mcmc(nwalkers=32, nburn=10, niter=10, p0=p0, seed=3, mesh=mesh)
    np.testing.assert_allclose(df_shard.values, df_plain.values, rtol=1e-10)


def test_sharded_nested_multirun_matches_unsharded(model):
    """Flagship engine on a mesh: independent NS runs shard over devices
    with zero communication, so same seeds -> bitwise-identical dead-point
    sequences, samples, and evidence."""
    mesh = default_mesh(8, axis_names=("runs",))
    kw = dict(n_live_points=32, max_iter=128, seed=5, n_runs=8, min_ess=0, dlogz=1.0)
    r_plain = model.fit_multinest(**kw)
    r_shard = model.fit_multinest(mesh=mesh, **kw)
    assert r_shard.logz == r_plain.logz
    np.testing.assert_array_equal(r_shard.samples, r_plain.samples)
    np.testing.assert_array_equal(r_shard.logl, r_plain.logl)
    np.testing.assert_array_equal(r_shard.logz_runs, r_plain.logz_runs)


@pytest.mark.slow
def test_sharded_nested_singlerun_close(model):
    """Single-run NS shards the constrained-walk chain batch instead: the
    sharded program re-fuses the elementwise lnpost, so values can differ at
    float-rounding level but every walk decision — hence the dead-point
    sequence and evidence — must match to ~1e-10."""
    mesh = default_mesh(8, axis_names=("walkers",))
    kw = dict(n_live_points=64, max_iter=400, seed=5, min_ess=0, dlogz=1.0)
    r_plain = model.fit_multinest(**kw)
    r_shard = model.fit_multinest(mesh=mesh, **kw)
    assert abs(r_shard.logz - r_plain.logz) < 1e-10
    np.testing.assert_allclose(r_shard.logl, r_plain.logl, rtol=1e-10)
    np.testing.assert_allclose(r_shard.samples, r_plain.samples, rtol=1e-8, atol=1e-10)


@pytest.mark.slow
def test_sharded_polychord_matches_unsharded(model):
    """The slice-sampling NS engine takes the same mesh= through
    run_polychord -> run_nested (multi-run: run-axis sharding, bitwise)."""
    mesh = default_mesh(8, axis_names=("runs",))
    kw = dict(n_live_points=32, max_iter=128, seed=5, n_runs=4, min_ess=0, dlogz=1.0)
    r_plain = model.fit_polychord(**kw)
    r_shard = model.fit_polychord(mesh=mesh, **kw)
    assert r_shard.logz == r_plain.logz
    np.testing.assert_array_equal(r_shard.samples, r_plain.samples)


@pytest.mark.slow
def test_sharded_batch_fitter_matches_unsharded(model):
    """Catalog fitter: star axis shards over the mesh (the SLURM-array role,
    reference scripts/batch_starfit). 12 stars on 8 devices — deliberately
    non-divisible (GSPMD pads) — must be bitwise-identical to unsharded."""
    import pandas as pd

    from isochrones_tpu.batch import BatchStarFitter

    iso = model.ic
    rng = np.random.default_rng(0)
    rows = []
    for _ in range(12):
        eep, age = rng.uniform(20, 80), rng.uniform(8.5, 9.5)
        feh, d, av = rng.uniform(-0.3, 0.3), rng.uniform(100, 400), rng.uniform(0, 0.3)
        Teff, logg, _, mags = iso.interp_mag([eep, age, feh, d, av], ["J", "H", "K"])
        rows.append(dict(
            Teff=float(Teff), Teff_unc=100.0,
            J_mag=float(mags[0]), J_mag_unc=0.02,
            H_mag=float(mags[1]), H_mag_unc=0.02,
            parallax=1000.0 / d, parallax_unc=0.1,
        ))
    df = pd.DataFrame(rows)
    kw = dict(n_live_points=48, max_iter=300, seed=3, min_ess=0, dlogz=1.0)
    f_plain = BatchStarFitter(iso, df)
    out_plain = f_plain.fit_multinest(**kw)
    f_shard = BatchStarFitter(iso, df)
    mesh = default_mesh(8, axis_names=("stars",))
    out_shard = f_shard.fit_multinest(mesh=mesh, **kw)
    np.testing.assert_array_equal(out_shard["logz"], out_plain["logz"])
    np.testing.assert_array_equal(f_shard.samples, f_plain.samples)


@pytest.mark.slow
def test_sharded_batch_mcmc_matches_unsharded(model):
    """BatchStarFitter.fit_mcmc(mesh=): star-axis sharding of the lockstep
    ensembles — per-star updates have no cross-star reductions, so sharded
    == unsharded bitwise for the same seed."""
    import pandas as pd

    from isochrones_tpu.batch import BatchStarFitter

    iso = model.ic
    rng = np.random.default_rng(2)
    rows = []
    for _ in range(10):  # non-divisible by 8
        eep, age = rng.uniform(30, 70), rng.uniform(8.7, 9.3)
        feh, d, av = rng.uniform(-0.2, 0.2), rng.uniform(150, 350), rng.uniform(0, 0.2)
        Teff, _, _, mags = iso.interp_mag([eep, age, feh, d, av], ["J", "H", "K"])
        rows.append(dict(
            Teff=float(Teff), Teff_unc=100.0,
            J_mag=float(mags[0]), J_mag_unc=0.02,
            parallax=1000.0 / d, parallax_unc=0.1,
        ))
    df = pd.DataFrame(rows)
    f_plain = BatchStarFitter(iso, df)
    s_plain = f_plain.fit_mcmc(nwalkers=16, nburn=20, niter=10, seed=5)
    f_shard = BatchStarFitter(iso, df)
    mesh = default_mesh(8, axis_names=("stars",))
    s_shard = f_shard.fit_mcmc(nwalkers=16, nburn=20, niter=10, seed=5, mesh=mesh)
    np.testing.assert_array_equal(s_shard, s_plain)


@pytest.mark.slow
def test_sharded_nuts_statistical_equivalence():
    """NUTS chains shard over the mesh (one block of independent chains per
    device). The pooled warmup variance crosses the mesh, so bitwise equality
    is not the contract — both runs must sample the same correlated Gaussian
    correctly."""
    import jax.numpy as jnp

    from isochrones_tpu.samplers.nuts import run_nuts

    rho = 0.8
    cov = np.array([[1.0, rho], [rho, 1.0]])
    prec = jnp.asarray(np.linalg.inv(cov))

    def lnpost_v(x):
        return -0.5 * jnp.einsum("bi,ij,bj->b", x, prec, x)

    key = jax.random.PRNGKey(0)
    x0 = 0.5 * jax.random.normal(key, (16, 2))
    mesh = default_mesh(8, axis_names=("chains",))
    for m in (None, mesh):
        res = run_nuts(lnpost_v, x0, key, n_warmup=400, n_samples=600, mesh=m)
        flat = res.samples.reshape(-1, 2)
        np.testing.assert_allclose(flat.mean(axis=0), 0.0, atol=0.12)
        np.testing.assert_allclose(np.cov(flat.T), cov, atol=0.2)
        assert (res.accept_rate > 0.5).all()


def test_replicate(model):
    mesh = default_mesh(8)
    rep = replicate(model.ic.model, mesh)
    assert np.allclose(np.asarray(rep.values), np.asarray(model.ic.model.values), equal_nan=True)


def test_pad_to_multiple():
    x = np.ones((13, 5))
    padded, n = pad_to_multiple(x, 8)
    assert padded.shape == (16, 5)
    assert n == 13
    assert np.isnan(padded[13:]).all()


def test_mag_accessor(model):
    ic = model.ic
    magJ = ic.mag["J"](60.0, 9.0, 0.0, 200.0, 0.1)
    _, _, _, mags = ic.interp_mag([60.0, 9.0, 0.0, 200.0, 0.1], ["J"])
    assert np.isclose(magJ, float(mags[0]))
    assert "J" in ic.mag.keys()


@pytest.mark.slow
def test_sharded_dynamic_nested(model):
    """dynamic=True composes with mesh= (single-run chain sharding): the
    thread rounds and the decorrelation walk both fan out through the same
    mesh-wrapped lnlike, and the merged result matches the unsharded dynamic
    run to float-rounding level."""
    mesh = default_mesh(8, axis_names=("walkers",))
    kw = dict(n_live_points=64, seed=5, min_ess=400, dlogz=0.5, dynamic=True)
    r_plain = model.fit_multinest(**kw)
    r_shard = model.fit_multinest(mesh=mesh, **kw)
    assert r_plain.ess >= 400 and r_shard.ess >= 400
    assert abs(r_shard.logz - r_plain.logz) < 1e-8
    np.testing.assert_allclose(r_shard.logl, r_plain.logl, rtol=1e-10)


def test_run_nested_vmapped_mesh_invariance():
    """Public problem-family NS engine: a toy family of shifted Gaussians
    sharded over the problem axis must be bitwise-identical to unsharded,
    and every evidence must match the analytic ln Z = ln integral over the
    unit box within its own error bar."""
    from scipy import stats as sps

    from isochrones_tpu.samplers.nested import run_nested_vmapped

    M, n_live, n_params = 12, 48, 3  # 12 problems on 8 devices: GSPMD pads
    centers = np.linspace(0.3, 0.7, M)
    sigma = 0.08

    def make_lnlike_u(c):
        return lambda u: -0.5 * jnp.sum((u - c) ** 2, axis=-1) / sigma**2

    rng = np.random.default_rng(0)
    u0 = rng.random((M, n_live, n_params))
    lnl0 = np.stack([
        np.asarray(make_lnlike_u(c)(jnp.asarray(u))) for c, u in zip(centers, u0)
    ])

    kw = dict(n_live=n_live, n_batch=4, n_chains=4, n_repeat=8, n_equal=500,
              dlogz=0.05, min_ess=50.0, seed=9)
    data = jnp.asarray(centers)
    out_plain = run_nested_vmapped(make_lnlike_u, data, u0, lnl0, **kw)
    mesh = default_mesh(8, axis_names=("problems",))
    out_shard = run_nested_vmapped(make_lnlike_u, data, u0, lnl0, mesh=mesh, **kw)

    np.testing.assert_array_equal(out_shard["logz"], out_plain["logz"])
    np.testing.assert_array_equal(out_shard["samples_u"], out_plain["samples_u"])
    assert out_plain["converged"].all()

    # analytic evidence of a spherical Gaussian truncated to the unit box
    for m, c in enumerate(centers):
        ln_axis = np.log(sigma * np.sqrt(2 * np.pi)
                         * (sps.norm.cdf((1 - c) / sigma) - sps.norm.cdf(-c / sigma)))
        assert abs(out_plain["logz"][m] - n_params * ln_axis) < 4 * out_plain["logzerr"][m]


def test_run_nested_vmapped_dynamic():
    """Family-wide dynamic NS: posterior threads lift every problem's ESS to
    target where the same budget of static shrinkage cannot, evidences stay
    analytic, and the mode composes with problem-axis mesh sharding."""
    from scipy import stats as sps

    from isochrones_tpu.samplers.nested import run_nested_vmapped

    M, n_live, n_params = 8, 48, 3
    centers = np.linspace(0.35, 0.65, M)
    sigma = 0.05

    def make_lnlike_u(c):
        return lambda u: -0.5 * jnp.sum((u - c) ** 2, axis=-1) / sigma**2

    rng = np.random.default_rng(3)
    u0 = rng.random((M, n_live, n_params))
    lnl0 = np.stack([
        np.asarray(make_lnlike_u(c)(jnp.asarray(u))) for c, u in zip(centers, u0)
    ])

    # tight budget: static terminal shrinkage exhausts it stuck at ~220 ESS
    # (post-dlogz deaths barely add posterior weight); dynamic threads reach
    # the 400 target with FEWER total deaths (measured: 768 vs 1200)
    kw = dict(n_live=n_live, n_batch=4, n_chains=4, n_repeat=8, n_equal=500,
              dlogz=0.05, min_ess=400.0, seed=9, max_iter=1200)
    data = jnp.asarray(centers)
    static = run_nested_vmapped(make_lnlike_u, data, u0, lnl0, **kw)
    dyn = run_nested_vmapped(make_lnlike_u, data, u0, lnl0, dynamic=True, **kw)

    assert dyn["dynamic_rounds"] >= 1
    assert (dyn["ess"] >= 400.0).all(), dyn["ess"]
    assert dyn["converged"].all()
    # at the same hard budget the static runs can't reach the ESS target...
    assert (static["ess"] < 400.0).all()
    # ...and dynamic got there spending LESS likelihood budget
    assert dyn["n_dead"] < static["n_dead"]

    # evidence stays unbiased through the varying-live-count merge
    for m, c in enumerate(centers):
        ln_axis = np.log(sigma * np.sqrt(2 * np.pi)
                         * (sps.norm.cdf((1 - c) / sigma) - sps.norm.cdf(-c / sigma)))
        assert abs(dyn["logz"][m] - n_params * ln_axis) < 4 * max(dyn["logzerr"][m], 0.05)

    # posterior quantiles match the analytic Gaussian marginals
    q = np.quantile(dyn["samples_u"], [0.16, 0.5, 0.84], axis=1)  # (3, M, p)
    for m, c in enumerate(centers):
        assert abs(q[1, m].mean() - c) < 0.02
        w = (q[2, m] - q[0, m]).mean() / 2
        assert abs(w - sigma) < 0.015

    # sharded == unsharded (same seeds, problem-axis sharding). Not bitwise
    # like the static path: the decorrelation walk's whitening
    # (cov matmul + cholesky) tiles differently under GSPMD, so values agree
    # to ulps (measured 9e-15), not exactly.
    mesh = default_mesh(8, axis_names=("problems",))
    dyn_shard = run_nested_vmapped(make_lnlike_u, data, u0, lnl0,
                                   dynamic=True, mesh=mesh, **kw)
    np.testing.assert_allclose(dyn_shard["logz"], dyn["logz"], rtol=1e-12)
    assert dyn_shard["dynamic_rounds"] == dyn["dynamic_rounds"]
    np.testing.assert_allclose(
        np.quantile(dyn_shard["samples_u"], [0.16, 0.5, 0.84], axis=1),
        np.quantile(dyn["samples_u"], [0.16, 0.5, 0.84], axis=1),
        atol=5e-3,
    )
