"""Multi-device scaling: every fit engine over a `jax.sharding.Mesh`.

Run from the repo root (8 virtual CPU devices stand in for 8 cards; on a
multi-GPU host pass --no-virtual and the same code shards over the cards):

    python examples/multichip.py            # 8 virtual CPU devices
    python examples/multichip.py --devices 4

Axes of parallelism (SURVEY §2.8: all parallelism in this problem is
embarrassingly-parallel likelihood fan-out, so every engine shards a batch
axis and XLA inserts the collectives):

  * nested sampling  — independent runs across chips (`runs` axis)
  * ensemble MCMC    — walker batch across chips (`walkers` axis)
  * NUTS             — chains across chips
  * cluster model    — stars across chips (scalar-psum total)
  * catalog fitter   — stars across chips (zero communication)
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

parser = argparse.ArgumentParser()
parser.add_argument("--devices", type=int, default=8)
parser.add_argument("--virtual", action=argparse.BooleanOptionalAction, default=True,
                    help="force N virtual CPU devices (default; --no-virtual on a real slice)")
args = parser.parse_args()

import jax

if args.virtual:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", args.devices)

import numpy as np

import isochrones_tpu as itpu
from isochrones_tpu.parallel import default_mesh

assert len(jax.devices()) >= args.devices, jax.devices()
print(f"{len(jax.devices())} devices on backend {jax.default_backend()!r}")

iso = itpu.get_ichrone("synthetic", n_feh=7, n_mass=30, n_eep=100, n_age=30)
Teff, logg, feh, mags = iso.interp_mag([60.0, 9.0, 0.0, 200.0, 0.1], ["J", "H", "K"])
model = itpu.SingleStarModel(
    iso, Teff=(float(Teff), 100.0), J=(float(mags[0]), 0.02), parallax=(5.0, 0.05)
)

# ---- nested sampling: independent runs sharded over chips -----------------
mesh = default_mesh(args.devices, axis_names=("runs",))
res = model.fit_multinest(n_live_points=100, n_runs=args.devices, mesh=mesh,
                          max_iter=1200, seed=1)
print(f"nested ({args.devices} runs sharded): logz = {res.logz:.2f} +- {res.logzerr:.2f}")

# ---- ensemble MCMC: walkers sharded ---------------------------------------
mesh_w = default_mesh(args.devices, axis_names=("walkers",))
model.fit_mcmc(nwalkers=16 * args.devices, nburn=200, niter=50, mesh=mesh_w, seed=2)
print(f"mcmc ({16 * args.devices} walkers sharded): age median = "
      f"{model.samples['age'].median():.2f}")

# ---- cluster likelihood: stars sharded ------------------------------------
from isochrones_tpu.cluster import SimulatedCluster, StarClusterModel

sim = SimulatedCluster(4 * args.devices, age=9.0, feh=0.0, distance=300.0,
                       AV=0.05, alpha=-2.0, gamma=0.3, fB=0.3, bands=("J", "H"),
                       mass_range=(0.6, 1.5), ic=iso, rng=0, phot_unc=0.05)
mesh_s = default_mesh(args.devices, axis_names=("stars",))
cm = StarClusterModel(iso, sim, eep_bounds=(1, 90), mesh=mesh_s,
                      mass_bounds=(0.6, 1.5), minq=0.2)
p = np.array([9.0, 0.0, 300.0, 0.05, -2.0, 0.3, 0.3])
print(f"cluster lnlike ({len(sim.df)} stars sharded): {cm.lnlike(p):.1f}")

# ---- whole-catalog fitter: stars sharded, zero communication --------------
from isochrones_tpu.batch import fit_catalog

fitter, summary = fit_catalog(iso, sim, method="mcmc", nwalkers=32, nburn=100,
                              niter=30, seed=3, mesh=mesh_s)
print(f"catalog fit ({fitter.n_stars} stars sharded): "
      f"median distance_50 = {summary['distance_50'].median():.0f} pc")
print("OK")
