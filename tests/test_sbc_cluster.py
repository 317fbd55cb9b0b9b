"""Simulation-based calibration of the HIERARCHICAL cluster posterior.

The star-model pipeline earned an SBC certificate in round 2
(test_sbc.py); this module gives the cluster model the same distributional
correctness check (Talts et al. 2018): draw M cluster parameter vectors
from a known prior box, simulate a cluster catalog at each truth
(SimulatedCluster: IMF power-law masses, q^gamma binaries, fB mixing,
Gaussian photometric + parallax noise), fit every dataset, and rank each
truth within its posterior samples — uniform ranks iff prior, forward
model, marginal likelihood, and sampler are jointly self-consistent.

Mechanics: all M fits run as ONE vmapped nested-sampling
program (samplers/nested.py::run_nested_vmapped) over the
dataset-parametric cluster likelihood
(StarClusterModel._build_lnlike_dataset) — the observations are function
ARGUMENTS, so M simulated replicas share a single compiled likelihood.

Generative-match notes (each one measured to corrupt a naive SBC):
* model mass_bounds == simulator mass_range (IMF normalization box);
* q_jacobian=True (the |dq/deep2| measure; docs/cluster.md);
* distance_scatter=0 and parallax noise added MANUALLY — SimulatedCluster
  records the exact 1000/d with unc=0.2 (reference parity), but SBC needs
  obs ~ N(truth, sigma);
* phot_unc at the EEP-ladder resolution so integer-ladder marginalization
  stays honest (see tests/test_cluster_validation.py trap #3);
* the prior box keeps every (mass, age, feh) corner alive on the grid
  (no dead-star redraws -> no survival-conditioning mismatch) and every
  true EEP inside the ladder (asserted per dataset).

A sampler that returns the PRIOR also passes rank-uniformity (truths are
prior draws), so the test additionally asserts the posteriors actually
CONCENTRATE (distance/age posterior spread << prior box) — uniformity is
only meaningful once the data constrain the fit.
"""

import numpy as np
import pytest
from scipy import stats

import jax
import jax.numpy as jnp

from isochrones_tpu import get_ichrone
from isochrones_tpu.catalog import StarCatalog
from isochrones_tpu.cluster import SimulatedCluster, StarClusterModel
from isochrones_tpu.samplers.nested import run_nested_vmapped

M, N = 10, 6
NAMES = ["age", "feh", "distance", "AV", "alpha", "gamma", "fB"]
BOX = dict(age=(8.6, 9.3), feh=(-0.3, 0.3), distance=(300.0, 800.0),
           AV=(0.0, 0.2), alpha=(-2.5, -1.5), gamma=(0.1, 0.6), fB=(0.1, 0.5))
MASS = (0.6, 1.8)
PHOT_UNC = 0.08
PLAX_UNC = 0.2


@pytest.mark.slow
def test_sbc_cluster_ranks_uniform():
    iso = get_ichrone("synthetic", n_feh=7, n_mass=30, n_eep=100, n_age=30)
    rng = np.random.default_rng(42)
    los = np.array([BOX[k][0] for k in NAMES])
    his = np.array([BOX[k][1] for k in NAMES])
    truths = los + (his - los) * rng.random((M, 7))

    # -- simulate M clusters at the prior-drawn truths
    stacks = {k: [] for k in ("mv", "mu", "pv", "pu")}
    template = None
    for m in range(M):
        t = dict(zip(NAMES, truths[m]))
        sim = SimulatedCluster(
            N, t["age"], t["feh"], t["distance"], t["AV"], t["alpha"],
            t["gamma"], t["fB"], ic=iso, rng=rng, mass_range=MASS,
            distance_scatter=0.0, phot_unc=PHOT_UNC,
        )
        df = sim.df.copy()
        assert not df[[f"{b}_mag" for b in "JHK"]].isna().any().any()
        assert df["eep_pri"].max() < 88  # ladder covers every true EEP
        df["parallax"] = df["parallax"] + rng.normal(0, PLAX_UNC, N)
        cat = StarCatalog(df, bands=("J", "H", "K"), props=("parallax",))
        if template is None:
            template = StarClusterModel(
                iso, cat, eep_bounds=(1, 90), eep_step=2.0, minq=0.2,
                max_distance=2000, max_AV=0.3, mass_bounds=MASS,
                q_jacobian=True,
            )
        for key, arr in zip(("mv", "mu", "pv", "pu"), cat.observation_stacks()):
            stacks[key].append(arr)

    data = tuple(jnp.asarray(np.stack(stacks[k])) for k in ("mv", "mu", "pv", "pu"))
    lnlike_ds = template._build_lnlike_dataset()
    los_j, his_j = jnp.asarray(los), jnp.asarray(his)

    # flat priors over the box: NS likelihood = lnlike, transform = box map
    def make_lnlike_u(data_m):
        mv, mu, pv, pu = data_m

        def lnlike_u(u):
            p = los_j[None] + (his_j - los_j)[None] * u
            return jax.vmap(lambda pp: lnlike_ds(pp, mv, mu, pv, pu))(p)

        return lnlike_u

    lt = np.asarray(jax.jit(jax.vmap(lnlike_ds))(jnp.asarray(truths), *data))
    assert np.isfinite(lt).all()  # support at every truth

    n_live = 64
    u0 = rng.random((M, n_live, 7))
    lnl0 = np.asarray(
        jax.jit(jax.vmap(lambda dm, uu: make_lnlike_u(dm)(uu)))(data, jnp.asarray(u0))
    )
    assert np.isfinite(lnl0).all()  # underflow-safe marginal: no false walls

    out = run_nested_vmapped(
        make_lnlike_u, data, u0, lnl0, n_live=n_live, n_batch=8, n_chains=6,
        n_repeat=10, n_equal=1000, dlogz=0.1, min_ess=60.0, seed=5, rng=rng,
        max_iter=1024, label="cluster",
    )
    assert np.isfinite(out["logz"]).all()
    assert (out["ess"] > 100).all()

    samples = los[None, None] + (his - los)[None, None] * out["samples_u"]

    # posteriors must CONCENTRATE, else rank-uniformity is vacuous
    # (a prior-returning sampler passes SBC by construction). Distance is
    # the witness: parallax pins it to ~0.1x the prior-box std in every
    # dataset (age/feh only partially concentrate at N=6 JHK stars —
    # measured median age spread ~0.18 dex vs 0.20 prior std).
    box_w = his - los
    spread = samples.std(axis=1)  # (M, 7) vs flat-box std ~0.29 * width
    assert (spread[:, 2] < 0.12 * box_w[2]).all()  # distance: parallax-pinned

    ranks = np.mean(samples < truths[:, None, :], axis=1)  # (M, 7)
    for j, name in enumerate(NAMES):
        r = ranks[:, j]
        ks = stats.kstest(r, "uniform")
        # M=10: KS 0.5% critical ~0.51; a 2x-too-narrow posterior piles
        # ranks at 0/1 and fails decisively
        assert ks.pvalue > 0.005, f"{name}: ranks not uniform (p={ks.pvalue:.4f}, ranks={np.sort(r)})"
        assert abs(r.mean() - 0.5) < 0.25, f"{name}: rank mean {r.mean():.2f} biased"
