"""Sampler correctness on analytic targets: the ensemble sampler recovers
Gaussian moments; nested sampling recovers a known evidence (Gaussian in a
box) and matching posterior moments."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from isochrones_tpu.samplers import autocorr_time, run_ensemble, run_nested


def test_ensemble_gaussian():
    mean = jnp.asarray([1.0, -2.0, 0.5])
    sigma = jnp.asarray([0.5, 1.5, 0.1])

    def lnpost_v(x):
        return -0.5 * jnp.sum(((x - mean) / sigma) ** 2, axis=-1)

    key = jax.random.PRNGKey(0)
    n_walkers = 64
    w0 = mean + 0.1 * jax.random.normal(key, (n_walkers, 3))
    chain, ln_chain, final = run_ensemble(lnpost_v, w0, key, n_steps=2000, thin=2)
    burn = 300
    flat = np.asarray(chain[burn:]).reshape(-1, 3)
    np.testing.assert_allclose(flat.mean(axis=0), np.asarray(mean), atol=0.05)
    np.testing.assert_allclose(flat.std(axis=0), np.asarray(sigma), rtol=0.1)
    # acceptance in a sane range
    acc = np.asarray(final.n_accept).mean() / 2000
    assert 0.2 < acc < 0.9
    taus = autocorr_time(np.asarray(chain[burn:]))
    assert (taus > 0).all() and (taus < 200).all()


def test_ensemble_handles_inf():
    def lnpost_v(x):
        lp = -0.5 * jnp.sum(x ** 2, axis=-1)
        return jnp.where(jnp.any(jnp.abs(x) > 3.0, axis=-1), -jnp.inf, lp)

    key = jax.random.PRNGKey(1)
    w0 = 0.1 * jax.random.normal(key, (32, 2))
    chain, ln_chain, final = run_ensemble(lnpost_v, w0, key, n_steps=500)
    assert np.isfinite(np.asarray(ln_chain)).all()
    assert (np.abs(np.asarray(chain)) <= 3.0).all()


def test_nested_gaussian_evidence():
    """Gaussian likelihood in a uniform box: analytic logZ."""
    sigma = 0.1
    lo, hi = -1.0, 1.0

    def lnpost_v(x):
        return -0.5 * jnp.sum((x / sigma) ** 2, axis=-1) - x.shape[-1] * 0.5 * np.log(2 * np.pi * sigma ** 2)

    def prior_transform(u):
        return lo + (hi - lo) * u

    n_params = 2
    res = run_nested(
        lnpost_v,
        prior_transform,
        n_params,
        key=jax.random.PRNGKey(2),
        n_live=400,
        max_iter=4000,
        rng=3,
    )
    # Z = integral of N(0, sigma) over box / box volume^n... with our convention
    # (uniform NS prior over the box has density 1/V per dim, but MultiNest
    # convention integrates L over the unit cube mapped to the box, i.e.
    # Z = mean of L over the box = (1 full Gaussian mass) / V)
    expected = np.log(1.0 / (hi - lo) ** n_params)
    assert res.logz == pytest.approx(expected, abs=max(3 * res.logzerr, 0.1))
    # posterior moments
    assert np.abs(res.posterior.mean(axis=0)).max() < 0.02
    np.testing.assert_allclose(res.posterior.std(axis=0), sigma, rtol=0.15)


def test_nested_bimodal():
    """Two well-separated modes: both captured in the posterior."""
    centers = np.array([[-0.5, -0.5], [0.5, 0.5]])
    sigma = 0.05

    def lnpost_v(x):
        d0 = -0.5 * jnp.sum(((x - centers[0]) / sigma) ** 2, axis=-1)
        d1 = -0.5 * jnp.sum(((x - centers[1]) / sigma) ** 2, axis=-1)
        return jnp.logaddexp(d0, d1)

    def prior_transform(u):
        return -1.0 + 2.0 * u

    res = run_nested(
        lnpost_v, prior_transform, 2, key=jax.random.PRNGKey(5), n_live=400, max_iter=4000, rng=7
    )
    labels = (res.posterior[:, 0] > 0).astype(int)
    frac = labels.mean()
    assert 0.2 < frac < 0.8  # both modes populated


@pytest.mark.parametrize("moves", ["de", "snooker", "kde", "mixed"])
def test_ensemble_moves_gaussian(moves):
    """DE / snooker / KDE / mixed moves sample a correlated Gaussian
    correctly (the emcee3 mixture role, reference fit.py:110-120)."""
    rho = 0.9
    cov = np.array([[1.0, rho], [rho, 1.0]])
    prec = jnp.asarray(np.linalg.inv(cov))

    def lnpost_v(x):
        return -0.5 * jnp.einsum("bi,ij,bj->b", x, prec, x)

    key = jax.random.PRNGKey(3)
    w0 = 0.5 * jax.random.normal(key, (64, 2))
    chain, ln_chain, final = run_ensemble(lnpost_v, w0, key, n_steps=3000, thin=2, moves=moves)
    flat = np.asarray(chain[400:]).reshape(-1, 2)
    np.testing.assert_allclose(flat.mean(axis=0), 0.0, atol=0.1)
    got_cov = np.cov(flat.T)
    np.testing.assert_allclose(got_cov, cov, atol=0.15)
    acc = np.asarray(final.n_accept).mean() / 3000
    assert 0.1 < acc < 0.95, f"acceptance {acc}"


def test_kde_move_physical_scales_f32():
    """KDE kernel regularization must scale with the parameter scales: with
    a distance-like axis (sigma ~1e2) in f32 the sample covariance's
    rounding error exceeds any absolute jitter, cholesky goes NaN, and every
    proposal is rejected (measured 1.9% acceptance pre-fix). The ridge is
    now relative to each axis's own variance."""
    scale = jnp.asarray([1.0, 1.0, 100.0, 1.0, 1.0, 1.0, 0.1], dtype=jnp.float32)

    def lnpost_v(p):
        z = p / scale
        return -0.5 * jnp.sum(z * z, axis=-1)

    key = jax.random.PRNGKey(2)
    w0 = (jax.random.normal(key, (64, 7), dtype=jnp.float32) * scale).astype(jnp.float32)
    chain, _, final = run_ensemble(lnpost_v, w0, key, n_steps=300, moves="kde")
    assert bool(jnp.all(jnp.isfinite(chain[-1])))
    acc = float(jnp.mean(final.n_accept)) / 300
    assert acc > 0.1, f"KDE acceptance collapsed: {acc}"

    # small-ensemble guard: 16 walkers / 7 dims -> the passive half (8 pts)
    # cannot support a useful 7-dim KDE; "mixed" falls back to DE/snooker
    w0s = w0[:16]
    chain_s, _, final_s = run_ensemble(lnpost_v, w0s, key, n_steps=300, moves="mixed")
    acc_s = float(jnp.mean(final_s.n_accept)) / 300
    assert acc_s > 0.1, f"mixed acceptance collapsed at 16 walkers: {acc_s}"


def test_mixed_moves_autocorr_benchmark():
    """Benchmark mixed vs stretch-only mixing on a curved (banana) target —
    the correlated-posterior case the emcee3 mixture exists for. Asserts both
    are correct and records the tau comparison; mixed must not mix
    pathologically worse than stretch."""
    # Rosenbrock-like banana: x1 ~ N(0,1), x2 ~ N(x1^2, 0.5)
    def lnpost_v(x):
        return -0.5 * x[:, 0] ** 2 - 0.5 * ((x[:, 1] - x[:, 0] ** 2) / 0.5) ** 2

    key = jax.random.PRNGKey(9)
    w0 = jnp.stack([0.5 * jax.random.normal(key, (64,)), 0.5 + 0.2 * jax.random.normal(key, (64,))], axis=-1)

    taus = {}
    for moves in ("stretch", "kde", "mixed"):
        chain, _, _ = run_ensemble(lnpost_v, w0, key, n_steps=4000, moves=moves)
        flat = np.asarray(chain[1000:]).reshape(-1, 2)
        np.testing.assert_allclose(flat[:, 0].mean(), 0.0, atol=0.15)
        np.testing.assert_allclose(flat[:, 1].mean(), 1.0, atol=0.3)  # E[x1^2] = 1
        taus[moves] = float(np.nanmax(autocorr_time(np.asarray(chain[1000:]))))
    print(
        "banana tau_max: stretch={stretch:.1f} kde={kde:.1f} mixed={mixed:.1f}".format(**taus)
    )
    # the full reference mixture (KDE/DE/snooker) must not mix pathologically
    # worse than stretch-only; measured values are printed for the record
    assert taus["mixed"] < 2.0 * taus["stretch"]
    assert taus["kde"] < 4.0 * taus["stretch"]


@pytest.mark.slow
def test_nested_ess_auto_extend_and_truncation():
    """min_ess termination: truncated runs are flagged
    loudly (or raise), and a dlogz-converged run keeps extending until the
    posterior ESS is usable."""
    sigma = 0.05

    def lnpost_v(x):
        return -0.5 * jnp.sum((x / sigma) ** 2, axis=-1)

    def prior_transform(u):
        return -1.0 + 2.0 * u

    # tiny budget -> truncated flag set
    res = run_nested(
        lnpost_v, prior_transform, 2, key=jax.random.PRNGKey(1), n_live=100,
        max_iter=60, rng=1,
    )
    assert res.truncated
    assert res.ess < 100

    # same tiny budget with on_low_ess="raise" -> error
    with pytest.raises(RuntimeError, match="ESS"):
        run_nested(
            lnpost_v, prior_transform, 2, key=jax.random.PRNGKey(1), n_live=100,
            max_iter=60, rng=1, on_low_ess="raise",
        )

    # default budget: auto-extends until ESS criterion is met
    res = run_nested(
        lnpost_v, prior_transform, 2, key=jax.random.PRNGKey(2), n_live=100,
        max_iter=6000, rng=2,
    )
    assert not res.truncated
    assert res.ess >= 100


def test_nested_batched_replacement_matches():
    """n_batch > 1 (batched-K live-point replacement) reproduces the analytic
    evidence and posterior moments of the sequential sampler."""
    sigma = 0.1
    lo, hi = -1.0, 1.0

    def lnpost_v(x):
        return -0.5 * jnp.sum((x / sigma) ** 2, axis=-1) - x.shape[-1] * 0.5 * np.log(
            2 * np.pi * sigma ** 2
        )

    def prior_transform(u):
        return lo + (hi - lo) * u

    n_params = 2
    res = run_nested(
        lnpost_v, prior_transform, n_params, key=jax.random.PRNGKey(5),
        n_live=400, max_iter=4000, n_batch=8, rng=7,
    )
    expected = np.log(1.0 / (hi - lo) ** n_params)
    assert res.logz == pytest.approx(expected, abs=max(3 * res.logzerr, 0.12))
    assert np.abs(res.posterior.mean(axis=0)).max() < 0.02
    np.testing.assert_allclose(res.posterior.std(axis=0), sigma, rtol=0.15)
    assert res.ess > 300


def test_ln_x_schedule_harmonic():
    """Batched-K removal must use the harmonic varying-live-set shrinkage:
    the j-th point removed within a batch (0-based, ascending lnL) shrinks
    the prior mass by 1/(n_live - j), not the naive 1/n_live — the constant
    schedule under-shrinks by ~K^2/2n^2 per batch, an O(+0.5 nat)
    evidence bias at K=64, n=1000."""
    from isochrones_tpu.samplers.nested import _RunningEvidence, _ln_x_schedule

    # K=1 reduces exactly to Skilling's -i/n
    np.testing.assert_allclose(
        _ln_x_schedule(100, 500, 1), -np.arange(1, 101) / 500, rtol=1e-12
    )
    # explicit harmonic sums for K=4, n=10
    inc = [1 / 10, 1 / 9, 1 / 8, 1 / 7] * 2
    np.testing.assert_allclose(_ln_x_schedule(8, 10, 4), -np.cumsum(inc), rtol=1e-12)
    # chunked accumulator folds to the same dead-only evidence as one pass
    rng = np.random.default_rng(0)
    lnl = np.sort(rng.normal(size=64))
    r = _RunningEvidence(40, n_batch=8)
    r.add(lnl[:24])
    r.add(lnl[24:])
    ln_x = _ln_x_schedule(64, 40, 8)
    w = np.exp(np.concatenate([[0.0], ln_x[:-1]])) - np.exp(ln_x)
    np.testing.assert_allclose(
        r.log_s1, np.log(np.sum(w * np.exp(lnl))), rtol=1e-10
    )
    np.testing.assert_allclose(r.ln_x, ln_x[-1], rtol=1e-12)
    # logzerr scale: exact 1/n at K=1, larger (by ~K/2n relative) otherwise
    from isochrones_tpu.samplers.nested import _logzerr_scale

    assert _logzerr_scale(500, 1) == pytest.approx(1 / 500, rel=1e-12)
    s64 = _logzerr_scale(1000, 64)
    assert s64 == pytest.approx((1 + 64 / 2000) / 1000, rel=0.01)
    assert s64 > 1 / 1000


def test_nested_aggressive_batch_evidence_unbiased():
    """Aggressive batching (K/n_live = 24%) still recovers the analytic
    evidence. With the naive constant -i/n schedule this configuration is
    biased by ~+1 nat (the harmonic deficit [H(n)-H(n-K)] - K/n per batch,
    compounded) and fails decisively — regression for _ln_x_schedule."""
    sigma = 0.1
    lo, hi = -1.0, 1.0

    def lnpost_v(x):
        return -0.5 * jnp.sum((x / sigma) ** 2, axis=-1) - x.shape[-1] * 0.5 * np.log(
            2 * np.pi * sigma ** 2
        )

    def prior_transform(u):
        return lo + (hi - lo) * u

    res = run_nested(
        lnpost_v, prior_transform, 2, key=jax.random.PRNGKey(9),
        n_live=200, max_iter=6000, n_batch=48, rng=3,
    )
    expected = np.log(1.0 / (hi - lo) ** 2)
    assert res.logz == pytest.approx(expected, abs=max(3 * res.logzerr, 0.3))


def test_nested_multi_run_evidence():
    """n_runs > 1: vmapped independent runs recover the analytic evidence,
    logzerr reflects the EMPIRICAL run scatter, and the combined posterior
    pools all runs (ESS ~sums across runs)."""
    sigma = 0.1
    lo, hi = -1.0, 1.0

    def lnpost_v(x):
        return -0.5 * jnp.sum((x / sigma) ** 2, axis=-1) - x.shape[-1] * 0.5 * np.log(
            2 * np.pi * sigma ** 2
        )

    def prior_transform(u):
        return lo + (hi - lo) * u

    n_params = 2
    res = run_nested(
        lnpost_v, prior_transform, n_params, key=jax.random.PRNGKey(9),
        n_live=300, max_iter=4000, n_batch=8, rng=11, n_runs=4,
    )
    expected = np.log(1.0 / (hi - lo) ** n_params)
    assert res.logz_runs is not None and res.logz_runs.shape == (4,)
    # every run individually sane, combined estimate within errors
    assert np.all(np.abs(res.logz_runs - expected) < 0.5)
    assert res.logz == pytest.approx(expected, abs=max(3 * res.logzerr, 0.12))
    # empirical scatter of independent runs is a valid error source: the
    # combined error must be consistent with the observed per-run spread
    assert res.logzerr >= np.std(res.logz_runs, ddof=1) / np.sqrt(4) - 1e-12
    assert np.abs(res.posterior.mean(axis=0)).max() < 0.02
    np.testing.assert_allclose(res.posterior.std(axis=0), sigma, rtol=0.15)
    assert res.ess > 600  # pooled across runs
    assert not res.truncated


# ------------------------------------------------------ dynamic nested sampling
def test_merge_segments_single_reproduces_classic():
    """One segment through the varying-n merge == the classic batched-K
    assembly: dead-point weights exactly, total logz to O(1/n_live) (the
    final-live treatment differs: decrementing deaths vs uniform X/n)."""
    from isochrones_tpu.samplers.nested import _assemble_weights, _merge_segments

    rng = np.random.default_rng(0)
    n_live, K = 200, 8
    dead_lnl = np.sort(rng.normal(size=960))
    live_lnl = dead_lnl[-1] + np.abs(rng.normal(size=n_live))  # live above dead
    _, _, logwt_classic, logz_classic, _, _ = _assemble_weights(
        dead_lnl, live_lnl, n_live, n_batch=K
    )
    seg = dict(
        dead_lnl=dead_lnl, live_lnl=live_lnl, n_live=n_live, n_batch=K,
        L0=-np.inf, all_u=rng.random((len(dead_lnl) + n_live, 3)),
    )
    _, all_lnl, all_logwt, logz, _, _, _, _ = _merge_segments([seg])
    # merged order is ascending lnl -> first 960 rows are the deaths
    np.testing.assert_allclose(all_logwt[:960], logwt_classic[:960], rtol=1e-10)
    assert abs(logz - logz_classic) < 3.0 / n_live


def test_merge_segments_two_runs_hand_counts():
    """Hand-checked alive counts for a base run + one thread activated
    mid-run: each death shrinks by 1/n_alive with the thread's points
    counting only above its activation threshold."""
    from isochrones_tpu.samplers.nested import _merge_segments

    base = dict(
        dead_lnl=np.array([1.0, 2.0, 3.0]), live_lnl=np.array([5.0, 4.0]),
        n_live=2, n_batch=1, L0=-np.inf, all_u=np.zeros((5, 2)),
    )
    thread = dict(
        dead_lnl=np.array([2.5, 3.5]), live_lnl=np.array([5.5, 4.5]),
        n_live=2, n_batch=1, L0=2.0, all_u=np.ones((4, 2)),
    )
    _, all_lnl, all_logwt, _, _, _, _, _ = _merge_segments([base, thread])
    np.testing.assert_allclose(
        all_lnl, [1.0, 2.0, 2.5, 3.0, 3.5, 4.0, 4.5, 5.0, 5.5]
    )
    # expected alive counts per event (activation sorts FIRST at equal lnl,
    # so the thread's points already count at the base death tied AT 2.0 —
    # the documented boundary convention that also keeps -inf events safe)
    expected_n = np.array([2, 4, 4, 4, 4, 4, 3, 2, 1], dtype=float)
    w = np.exp(all_logwt - all_lnl)  # prior-mass weight per event
    x = 1.0 - np.cumsum(w)  # remaining prior mass after each event
    np.testing.assert_allclose(
        x, np.exp(-np.cumsum(1.0 / expected_n)), rtol=1e-10
    )


def test_nested_dynamic_reaches_ess_cheaply():
    """dynamic=True hits a high ESS target in a small fraction of the
    likelihood calls static terminal shrinkage needs — at unchanged evidence
    and posterior moments (the Higson dynamic-NS payoff)."""
    sigma = 0.1

    def lnpost_v(x):
        return -0.5 * jnp.sum((x / sigma) ** 2, axis=-1) - x.shape[-1] * 0.5 * np.log(
            2 * np.pi * sigma ** 2
        )

    def prior_transform(u):
        return -1.0 + 2.0 * u

    d, min_ess = 3, 1500
    common = dict(
        n_live=200, n_chains=8, n_repeat=16, n_batch=8, dlogz=0.01,
        min_ess=min_ess, rng=3,
    )
    static = run_nested(
        lnpost_v, prior_transform, d, jax.random.PRNGKey(2),
        max_iter=20_000, **common,
    )
    dynamic = run_nested(
        lnpost_v, prior_transform, d, jax.random.PRNGKey(2),
        dynamic=True, **common,
    )
    # static terminal shrinkage saturates below the target...
    assert static.truncated and static.ess < min_ess
    # ...dynamic reaches it with far fewer evaluations
    assert not dynamic.truncated and dynamic.ess >= min_ess
    assert dynamic.dynamic_rounds >= 1
    assert dynamic.n_iter < static.n_iter / 2
    # unchanged evidence and posterior
    expected = np.log(1.0 / 2.0 ** d)
    assert dynamic.logz == pytest.approx(expected, abs=max(3 * dynamic.logzerr, 0.1))
    assert abs(dynamic.logz - static.logz) < 3 * np.hypot(dynamic.logzerr, static.logzerr)
    assert np.abs(dynamic.posterior.mean(axis=0)).max() < 0.02
    np.testing.assert_allclose(dynamic.posterior.std(axis=0), sigma, rtol=0.15)
    # full-distribution certificate: the analytic posterior is N(0, sigma)
    # per axis (flat prior); a KS test catches merge-weighting errors that
    # moments alone miss. Thin to ~independent draws (equal-weight resampling
    # repeats rows), then demand p > 1e-3 on every axis.
    from scipy import stats

    for ax in range(d):
        draws = np.unique(dynamic.posterior[:, ax])
        assert len(draws) > 300
        ks = stats.kstest(draws / sigma, "norm")
        assert ks.pvalue > 1e-3, (ax, ks)


def test_nested_dynamic_rejects_multi_run():
    with pytest.raises(ValueError, match="dynamic"):
        run_nested(
            lambda x: -jnp.sum(x ** 2, axis=-1), lambda u: u, 2,
            jax.random.PRNGKey(0), n_runs=2, dynamic=True,
        )


def test_merge_segments_inf_safe():
    """-inf dead/live points (zero-probability prior regions) must flow
    through the merge like the static assembly: shrinkage consumed, weight
    -inf, no crash."""
    from isochrones_tpu.samplers.nested import _assemble_weights, _merge_segments

    rng = np.random.default_rng(1)
    n_live = 50
    dead_lnl = np.concatenate([[-np.inf, -np.inf], np.sort(rng.normal(size=98))])
    live_lnl = np.concatenate([[-np.inf], dead_lnl[-1] + np.abs(rng.normal(size=n_live - 1))])
    seg = dict(dead_lnl=dead_lnl, live_lnl=live_lnl, n_live=n_live, n_batch=1,
               L0=-np.inf, all_u=rng.random((len(dead_lnl) + n_live, 2)))
    _, all_lnl, all_logwt, logz, probs, ess, _, _ = _merge_segments([seg])
    assert np.isfinite(logz)
    assert np.all(all_logwt[~np.isfinite(all_lnl)] == -np.inf)
    assert probs[~np.isfinite(all_lnl)].sum() == 0.0
    _, _, _, logz_classic, _, _ = _assemble_weights(dead_lnl, live_lnl, n_live)
    assert abs(logz - logz_classic) < 3.0 / n_live


def test_live_cholesky_duplicate_rows_f32():
    """Regression: the whitening factor must stay finite when the start set
    contains exact duplicate rows (dynamic-NS thread starts whose
    decorrelation stalled) — in f32 an absolute 1e-12 jitter is
    unrepresentable next to O(1e-2) diagonals, leaving cov singular and the
    Cholesky factor NaN, which permanently kills every later proposal."""
    from isochrones_tpu.samplers.nested import _live_cholesky

    rng = np.random.default_rng(3)
    base = rng.random((8, 4)) * 0.1 + 0.45
    live = np.repeat(base, 4, axis=0)  # 32 rows, each duplicated 4x
    L = _live_cholesky(jnp.asarray(live, dtype=jnp.float32))
    assert np.isfinite(np.asarray(L)).all()
    # fully degenerate set (all rows identical): tiny but finite factor
    L0 = _live_cholesky(jnp.asarray(np.repeat(base[:1], 16, axis=0),
                                    dtype=jnp.float32))
    assert np.isfinite(np.asarray(L0)).all()


def test_run_nested_vmapped_rng_precedence():
    """Regression: with seed=None the device walk streams must derive from
    the caller's rng (docstring contract) — two campaigns differing only in
    rng must explore differently, and the same rng seed must reproduce."""
    from isochrones_tpu.samplers.nested import run_nested_vmapped

    M, n_live, n_params = 2, 32, 2
    centers = np.array([0.4, 0.6])

    def make_lnlike_u(c):
        return lambda u: -0.5 * jnp.sum((u - c) ** 2, axis=-1) / 0.1**2

    host = np.random.default_rng(0)
    u0 = host.random((M, n_live, n_params))
    lnl0 = np.stack([
        np.asarray(make_lnlike_u(c)(jnp.asarray(u))) for c, u in zip(centers, u0)
    ])
    kw = dict(n_live=n_live, n_batch=4, n_chains=4, n_repeat=4, n_equal=100,
              dlogz=0.2, min_ess=20.0)
    data = jnp.asarray(centers)

    outs = [
        run_nested_vmapped(make_lnlike_u, data, u0, lnl0,
                           rng=np.random.default_rng(s), **kw)
        for s in (11, 12, 11)
    ]
    assert not np.array_equal(outs[0]["samples_u"], outs[1]["samples_u"])
    np.testing.assert_array_equal(outs[0]["samples_u"], outs[2]["samples_u"])
    np.testing.assert_array_equal(outs[0]["logz"], outs[2]["logz"])
