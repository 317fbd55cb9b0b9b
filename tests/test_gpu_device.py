"""Tests that need a GPU: ``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/``.

The CPU suite checks the Pallas cluster kernel only in interpret mode and
the device-resident generate path only on the CPU backend. These run the
same parity assertions with the kernel compiled for the card, in float32.
Each test takes the ``gpu`` fixture, which skips it where there is no card.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

pytestmark = pytest.mark.gpu


def _cluster_fixture(seed, S=8, E=128, B=3):
    rng = np.random.default_rng(seed)
    f32 = jnp.float32
    model_mags = jnp.asarray(rng.normal(8.0, 1.0, (E, B)), dtype=f32)
    masses = jnp.asarray(np.linspace(0.4, 2.2, E), dtype=f32)
    ln_dm = jnp.asarray(rng.normal(-4.0, 0.3, E), dtype=f32)
    eeps = jnp.asarray(np.linspace(1.0, 260.0, E), dtype=f32)
    lnlike_prop = jnp.asarray(rng.normal(-1.0, 0.5, (S, E)), dtype=f32)
    mag_values = jnp.asarray(rng.normal(8.0, 0.8, (S, B)), dtype=f32)
    mag_uncs = jnp.full((S, B), 0.05, dtype=f32)
    valid = jnp.asarray(rng.random(E) > 0.05)
    return dict(
        lnlike_prop=lnlike_prop, model_mags=model_mags, masses=masses,
        ln_dm_deeps=ln_dm, eeps=eeps, mag_values=mag_values,
        mag_uncs=mag_uncs, alpha=-2.0, gamma=0.3, fB=0.35,
        mass_lo=0.4, mass_hi=2.2, q_lo=0.2, valid=valid,
    )


@pytest.mark.parametrize("q_jacobian", [False, True])
def test_compiled_pallas_matches_xla_on_chip(gpu, q_jacobian):
    """Compiled (Triton) Pallas cluster marginal == XLA grid path on the
    card, float32. The CPU suite checks this in interpret mode only."""
    from isochrones_tpu.ops.cluster import cluster_lnmarginal

    with jax.enable_x64(False), jax.default_device(gpu):
        kw = _cluster_fixture(3)
        ref = np.asarray(
            cluster_lnmarginal(**kw, use_pallas=False, q_jacobian=q_jacobian)
        )
        got = np.asarray(
            cluster_lnmarginal(**kw, use_pallas=True, q_jacobian=q_jacobian)
        )
    m = np.isfinite(ref)
    assert m.any()
    rel = np.max(np.abs(got[m] - ref[m]) / np.abs(ref[m]))
    print(f"compiled kernel vs XLA, q_jacobian={q_jacobian}: max rel diff {rel:.3e}")
    np.testing.assert_allclose(got[m], ref[m], rtol=5e-4)
    assert np.array_equal(np.isfinite(got), m)


def test_generate_device_on_chip(gpu):
    """Device-resident generate returns finite on-device float32 arrays
    matching the host path."""
    from isochrones_tpu import get_ichrone

    with jax.enable_x64(False), jax.default_device(gpu):
        iso = get_ichrone("synthetic", n_feh=5, n_mass=16, n_eep=50, n_age=16,
                          dtype=np.float32)
        mass = jnp.asarray(
            np.random.default_rng(0).uniform(0.5, 1.4, 512), dtype=jnp.float32
        )
        eeps, values, mags = iso.generate_device(mass, 9.0, 0.0, bands=["J", "H"])
        assert isinstance(mags, jax.Array) and mags.dtype == jnp.float32
        mags_h = np.asarray(mags)
        df = iso.generate(np.asarray(mass), 9.0, 0.0, bands=["J", "H"])
    assert np.isfinite(mags_h).mean() > 0.5
    np.testing.assert_allclose(
        mags_h[:, 0], df["J_mag"].values.astype(np.float32), rtol=2e-5,
        equal_nan=True,
    )


def test_fused_lnpost_deterministic_on_chip(gpu):
    """The flagship fused lnpost is finite and bitwise-deterministic across
    repeated dispatches on the card (catches nondeterministic float32
    fusion or uninitialized-memory regressions the CPU suite can't see)."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from __graft_entry__ import entry

    with jax.enable_x64(False), jax.default_device(gpu):
        fn, (batch,) = entry()
        a = np.asarray(fn(batch))
        b = np.asarray(fn(batch))
    assert np.isfinite(a).any()
    np.testing.assert_array_equal(a, b)
