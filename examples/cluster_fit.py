"""Hierarchical cluster fit: simulate a cluster, fit its shared parameters.

The cluster likelihood marginalizes every member over (primary EEP,
secondary EEP) with power-law mass/mass-ratio priors and a binary-fraction
photometric mixture (reference isochrones/cluster.py) — on a GPU this runs
as the fused Pallas kernel in ops/cluster_pallas.py.

Run from the repo root:  python examples/cluster_fit.py [--platform cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

parser = argparse.ArgumentParser()
parser.add_argument("--platform", default=None)
parser.add_argument("--n-stars", type=int, default=30)
parser.add_argument("--nested", action="store_true",
                    help="full nested-sampling fit with evidence (accelerator-scale; "
                    "the default ensemble-MCMC budget suits a CPU demo)")
parser.add_argument("--n-live", type=int, default=300)
args = parser.parse_args()
if args.platform:
    import jax

    jax.config.update("jax_platforms", args.platform)

import numpy as np

import isochrones_tpu as itpu
from isochrones_tpu.cluster import SimulatedCluster, StarClusterModel

truth = dict(age=9.0, feh=0.0, distance=500.0, AV=0.05, alpha=-2.0, gamma=0.3, fB=0.3)

iso = itpu.get_ichrone("synthetic", n_feh=7, n_mass=30, n_eep=120, n_age=30)
sim = SimulatedCluster(args.n_stars, ic=iso, **truth, rng=3)
model = StarClusterModel(iso, sim, eep_bounds=(1, 115))

# sanity: the truth must have finite likelihood before trusting any fit
p_true = [truth[k] for k in ("age", "feh", "distance", "AV", "alpha", "gamma", "fB")]
lnl = model.lnlike(p_true)
print(f"lnlike(truth) = {lnl:.1f}")
assert np.isfinite(lnl), "truth outside model support — check eep_bounds/photometry"

if args.nested:
    res = model.fit(n_live_points=args.n_live, seed=1)
    print(f"ln Z = {res.logz:.2f} +/- {res.logzerr:.2f} (posterior ESS {res.ess:.0f})")
    samples = model.samples
else:
    samples = model.fit_mcmc(nwalkers=32, nburn=150, niter=40, seed=1)
med = samples.median()
for k in ("age", "feh", "distance", "AV", "fB"):
    print(f"  {k:>9}: {med[k]:8.3f}   (truth {truth[k]})")
print(
    "(3-band photometry alone leaves a feh-AV-distance degeneracy; the "
    "short demo MCMC budget can sit off-truth in feh. A full --nested run "
    "or per-star spectroscopic priors tighten it.)"
)
