"""NUTS wall-clock decomposition: why a warm NUTS fit takes longer than
nested sampling or the ensemble on the same posterior.

Runs bench.py's binary-star fit at several (n_chains, n_warmup,
n_samples) configurations on the accelerator and prints seconds per
config + the per-transition cost, separating the two candidate
explanations:

* underfill — 16 chains put only 16 points per leapfrog dispatch, far
  below the batch at which the lnpost kernel fills the device; more
  chains are near-free until then;
* sequential depth — warmup+sampling transitions x lockstep tree depth is
  the irreducible serial axis; fewer, fatter transitions win.

Usage:  python examples/profile_nuts.py
"""

import json
import time

import numpy as np

from isochrones_tpu import get_ichrone
from isochrones_tpu.config import enable_compile_cache
from isochrones_tpu.device import on_accelerator
from isochrones_tpu.starmodel import BinaryStarModel


def build_model():
    dtype = np.float32 if on_accelerator() else np.float64
    iso = get_ichrone("synthetic", n_feh=15, n_mass=196, n_eep=1710, n_age=107, dtype=dtype)
    pars = [350.0, 9.0, 0.0, 200.0, 0.1]
    bands = ["J", "H", "K", "G"]
    Teff, logg, _, mags1 = iso.interp_mag(list(pars), list(bands))
    _, _, _, mags2 = iso.interp_mag([300.0] + pars[1:], list(bands))
    mags1, mags2 = np.asarray(mags1), np.asarray(mags2)
    tot = -2.5 * np.log10(10 ** (-0.4 * mags1) + 10 ** (-0.4 * mags2))
    return BinaryStarModel(
        iso, Teff=(float(Teff), 100.0), logg=(float(logg), 0.1),
        J=(float(tot[0]), 0.02), H=(float(tot[1]), 0.02),
        K=(float(tot[2]), 0.02), G=(float(tot[3]), 0.01),
        parallax=(5.0, 0.05),
    )


def one(model, n_chains, n_warmup, n_samples, max_depth=8, seed=2, reps=2):
    times = []
    for r in range(reps):
        t0 = time.perf_counter()
        df = model.fit_nuts(n_chains=n_chains, n_warmup=n_warmup,
                            n_samples=n_samples, max_depth=max_depth,
                            seed=seed + r)
        times.append(time.perf_counter() - t0)
    res = model._nuts_result
    n_trans = n_warmup + n_samples
    warm = times[-1]
    row = {
        "config": f"{n_chains}c x {n_warmup}+{n_samples} d{max_depth}",
        "seconds_warm": round(warm, 2),
        "seconds_cold": round(times[0], 2),
        "ms_per_transition": round(warm / n_trans * 1e3, 2),
        "n_posterior_samples": int(len(df)),
        "accept": [round(float(a), 3) for a in np.atleast_1d(res.accept_rate)[:4]],
        "divergent_frac": round(float(np.sum(res.n_divergent)) / (n_chains * n_samples), 4),
        "quantiles_distance": [round(q, 1) for q in np.percentile(df["distance"], [16, 50, 84])],
    }
    print(json.dumps(row), flush=True)
    return row


def main():
    enable_compile_cache()
    model = build_model()
    # round-3 already measured that chains do NOT amortize (per-step cost
    # grows ~linearly with chain count; docs "NUTS wall-clock does not
    # amortize over chains") — so the sweep here attacks the SEQUENTIAL
    # axis: transition count (warmup + samples) and the lockstep tree-depth
    # cap, with posterior sanity columns to catch quality loss.
    rows = [
        one(model, 16, 800, 1000),              # the bench-15 r4 configuration
        one(model, 16, 500, 500, max_depth=7),  # halve transitions + cap leaves 256->128
        one(model, 16, 500, 500, max_depth=6),  # cap 256->64
    ]
    print(json.dumps({"summary": rows}, indent=1))


if __name__ == "__main__":
    main()
