"""Full-scale dress rehearsal for real MIST data.

The real MIST track grid is 15 feh x ~196 mass x 1710 EEP with 1710-EEP
cluster ladders (reference mist/models.py:60,99,167); until the network
unblocks the real download, this tier proves the whole pipeline — grid
bake -> packed interpolator -> cluster marginal at the FULL EEP ladder ->
one nested-sampling fit — at those exact dimensions on synthetic data, so
no OOM/layout surprise is left for the day real data lands
(tests/test_realdata.py stays the turnkey correctness gate).

On a card (``JAX_PLATFORMS=cuda,cpu pytest -m gpu``) this runs compiled
with the Pallas marginal and checks peak device memory; the ``slow``
variant runs the same shapes on CPU (XLA grid path, one walker) so the
dimensions stay exercised in every environment.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

REAL_DIMS = dict(n_feh=15, n_mass=196, n_eep=1710, n_age=107)


def _real_scale_iso(dtype):
    from isochrones_tpu import get_ichrone

    return get_ichrone("synthetic", dtype=dtype, **REAL_DIMS)


def _full_ladder_cluster(iso, n_stars=30):
    from isochrones_tpu.cluster import SimulatedCluster, StarClusterModel

    sim = SimulatedCluster(
        n_stars, age=9.0, feh=0.0, distance=300.0, AV=0.05, alpha=-2.0,
        gamma=0.3, fB=0.3, bands=("J", "H", "K"), mass_range=(0.6, 2.0),
        ic=iso, rng=0, phot_unc=0.02,
    )
    return StarClusterModel(
        iso, sim, eep_bounds=(1, int(iso.maxeep)), max_distance=3000, minq=0.2
    )


@pytest.mark.slow
def test_real_dims_pipeline_cpu():
    """Grid bake + packed interpolator + full-1710-EEP cluster marginal +
    a short single-star NS fit, all at real-MIST dimensions (CPU/f64)."""
    iso = _real_scale_iso(np.float64)
    grid = iso.track.model
    assert grid.values.shape[0] == REAL_DIMS["n_feh"]
    assert grid.values.shape[2] == REAL_DIMS["n_eep"]

    # interpolator hot path at scale
    Teff, logg, _, mags = iso.interp_mag([350.0, 9.0, 0.0, 200.0, 0.1], ["J", "K"])
    assert np.isfinite(Teff) and np.isfinite(np.asarray(mags)).all()

    # full-ladder cluster marginal: one walker through the XLA grid path
    model = _full_ladder_cluster(iso)
    assert model._n_ladder == int(iso.maxeep)  # the real grid's worst case
    p = jnp.asarray([[9.0, 0.0, 300.0, 0.05, -2.0, 0.3, 0.3]], dtype=jnp.float64)
    lp = float(np.asarray(model.lnpost_batch(p))[0])
    assert np.isfinite(lp)

    # one short NS fit on a single star at real grid scale
    from isochrones_tpu.starmodel import SingleStarModel

    Teff1, logg1, _, mags1 = iso.interp_mag([320.0, 9.2, 0.1, 150.0, 0.1], ["J", "K"])
    m = SingleStarModel(
        iso, Teff=(float(Teff1), 80.0), logg=(float(logg1), 0.1),
        J=(float(np.asarray(mags1)[0]), 0.02), K=(float(np.asarray(mags1)[1]), 0.02),
        parallax=(1000.0 / 150.0, 0.1),
    )
    res = m.fit_multinest(n_live_points=100, n_batch=16, n_chains=8, seed=0)
    assert np.isfinite(res.logz)
    assert res.ess > 50


@pytest.mark.gpu
def test_real_dims_pipeline_on_chip(gpu):
    """Same pipeline compiled on the card, float32, Pallas marginal at the
    full 1710-EEP ladder at the bench configuration (50 stars, walker
    batch 16), with peak device memory held under 75% of what the card
    lets this process use, so runs with real BC grids resident cannot
    run out of memory."""
    with jax.enable_x64(False), jax.default_device(gpu):
        iso = _real_scale_iso(np.float32)
        model = _full_ladder_cluster(iso, n_stars=50)
        p = jnp.asarray(
            np.asarray([9.0, 0.0, 300.0, 0.05, -2.0, 0.3, 0.3])[None, :]
            + np.random.default_rng(0).normal(0, 0.01, (16, 7)),
            dtype=jnp.float32,
        )
        out = np.asarray(model.lnpost_batch(p))
    assert np.isfinite(out).all()

    stats = gpu.memory_stats()
    assert stats["peak_bytes_in_use"] < 0.75 * stats["bytes_limit"], (
        f"peak {stats['peak_bytes_in_use']} of {stats['bytes_limit']} bytes"
    )
