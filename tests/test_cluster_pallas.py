"""Pallas cluster-kernel parity vs the XLA grid path, and its dispatch.

The fused Pallas kernel (ops/cluster_pallas.py) must agree with
``log(integrate_over_eeps(calc_lnlike_grid(...)))`` — which is itself
parity-tested against the numpy loop oracle of the reference's
``cluster_utils.py`` kernels in test_cluster.py — on randomized inputs,
adversarial masks, and under vmap. Runs in interpret mode on CPU; the
same kernel compiled for the card is checked by tests/test_gpu_device.py
and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from isochrones_tpu.ops.cluster import (
    calc_lnlike_grid,
    cluster_lnmarginal,
    integrate_over_eeps,
    kernel_path,
)
from isochrones_tpu.ops.cluster_pallas import (
    cluster_lnmarginal_pallas,
    plan_tiles,
    trapezoid_weights,
)


def _fixture(seed, S=7, E=50, B=4, invalid_frac=0.1):
    rng = np.random.default_rng(seed)
    eeps = jnp.asarray(np.sort(rng.uniform(200, 400, E)))
    masses = jnp.asarray(np.sort(rng.uniform(0.3, 2.0, E)))
    model_mags = jnp.asarray(rng.normal(10, 2, (E, B)))
    ln_dm = jnp.asarray(rng.normal(-3, 0.5, E))
    valid = jnp.asarray(rng.random(E) > invalid_frac)
    lnprop = jnp.asarray(rng.normal(-2, 1, (S, E)))
    mag_values = jnp.asarray(rng.normal(10, 2, (S, B)))
    mag_uncs = jnp.asarray(rng.uniform(0.05, 0.2, (S, B)))
    masses_safe = jnp.where(valid, masses, 1.0)
    ln_dm_safe = jnp.where(valid, ln_dm, 0.0)
    mm = jnp.where(valid[:, None], model_mags, 0.0)
    return dict(
        lnlike_prop=lnprop, model_mags=mm, masses=masses_safe,
        ln_dm_deeps=ln_dm_safe, eeps=eeps, mag_values=mag_values,
        mag_uncs=mag_uncs, alpha=-2.35, gamma=0.3, fB=0.4,
        mass_lo=0.3, mass_hi=2.0, q_lo=0.2, valid=valid,
    )


def _xla_ref(kw):
    grid = calc_lnlike_grid(
        kw["lnlike_prop"], kw["model_mags"], kw["masses"], kw["ln_dm_deeps"],
        kw["mag_values"], kw["mag_uncs"], kw["alpha"], kw["gamma"], kw["fB"],
        kw["mass_lo"], kw["mass_hi"], kw["q_lo"], valid=kw["valid"],
    )
    with np.errstate(divide="ignore"):  # log(0) -> -inf is the intended result
        return np.log(np.asarray(integrate_over_eeps(grid, kw["eeps"])))


def test_trapezoid_weights_identity():
    """W-weighted sum-of-exp == the pairwise double trapezoid, exactly
    the identity the kernel relies on, for an arbitrary masked plane."""
    rng = np.random.default_rng(3)
    E, S = 37, 5
    eeps = jnp.asarray(np.sort(rng.uniform(0, 10, E)))
    lnl = jnp.asarray(rng.normal(-3, 2, (S, E, E)))
    mask = jnp.asarray(rng.random((E, E)) > 0.3) & jnp.tril(
        jnp.ones((E, E), dtype=bool)
    )
    ref = np.asarray(
        integrate_over_eeps(jnp.where(mask[None], lnl, -jnp.inf), eeps)
    )
    w = trapezoid_weights(eeps, mask)
    got = np.asarray(jnp.sum(jnp.exp(lnl) * w[None], axis=(1, 2)))
    np.testing.assert_allclose(got, ref, rtol=1e-12)


@pytest.mark.parametrize("tile_s", [1, 4])
@pytest.mark.parametrize("seed,S,E,B", [(0, 7, 50, 4), (1, 3, 130, 2), (2, 9, 64, 6)])
def test_pallas_parity_randomized(seed, S, E, B, tile_s):
    """tile_s=4 is the star tile the planner picks at production sizes;
    star counts that are not a multiple of it pad the last block with
    -1e30 ghost rows, which must not leak into the real stars."""
    kw = _fixture(seed, S=S, E=E, B=B)
    ref = _xla_ref(kw)
    got = np.asarray(
        cluster_lnmarginal_pallas(**kw, interpret=True, tile_s=tile_s, tile_j=16)
    )
    assert got.shape == (S,)
    m = np.isfinite(ref)
    np.testing.assert_allclose(got[m], ref[m], rtol=1e-8)
    assert np.array_equal(np.isfinite(got), m)


@pytest.mark.parametrize("tile_k", [8, 16, 32])
def test_pallas_parity_k_tiled(tile_k):
    """The in-kernel k loop must stream the same logsumexp: tile widths
    that divide E unevenly, straddle the mask and the diagonal, and force
    >=3 k tiles all agree with the XLA grid path."""
    kw = _fixture(4, S=6, E=70, B=3)
    ref = _xla_ref(kw)
    got = np.asarray(
        cluster_lnmarginal_pallas(**kw, interpret=True, tile_j=16, tile_k=tile_k)
    )
    m = np.isfinite(ref)
    np.testing.assert_allclose(got[m], ref[m], rtol=1e-8)
    assert np.array_equal(np.isfinite(got), m)


@pytest.mark.parametrize("n_eep,n_stars,n_bands", [
    (800, 50, 3), (1710, 50, 3), (1710, 50, 8), (50, 7, 4), (6840, 3, 2),
])
def test_tile_planner(n_eep, n_stars, n_bands):
    """The production planner (the one the kernel wrapper calls) gives
    power-of-two tiles whose live tiles fit the register budget, and at
    the bench's 50 stars launches at least two blocks per SM of an H100
    for a single walker."""
    from isochrones_tpu.ops.cluster_pallas import _N_SM, _TILE_ELEMS_BUDGET

    ts, tj, tk = plan_tiles(n_eep, n_stars, n_bands)
    for t in (ts, tj, tk):
        assert t >= 1 and t & (t - 1) == 0
    assert tj * tk * (n_bands + 4) <= _TILE_ELEMS_BUDGET
    n_blocks = -(-n_stars // ts) * -(-n_eep // tj)
    if n_stars == 50:
        assert n_blocks >= 2 * _N_SM
        assert ts == 4  # the measured-best star tile at the bench shapes


def test_kernel_rejects_non_pow2_tiles():
    kw = _fixture(0, S=3, E=40, B=3)
    with pytest.raises(ValueError, match="power of two"):
        cluster_lnmarginal_pallas(**kw, interpret=True, tile_j=24)


@pytest.mark.parametrize("tile_s", [1, 4])
def test_pallas_parity_inf_lnprop_and_all_invalid_star(tile_s):
    """-inf / nan property likelihoods and a star with no valid support
    must not poison neighbors (in the same star tile too, and with ghost
    stars padding it); the dead star's marginal is -inf."""
    kw = _fixture(5, S=6, E=40, B=3)
    lnprop = np.array(kw["lnlike_prop"])
    lnprop[0, 3] = -np.inf
    lnprop[1, :] = np.nan
    lnprop[2, :] = -np.inf  # star with zero marginal likelihood
    kw["lnlike_prop"] = jnp.asarray(lnprop)
    ref = _xla_ref(kw)
    got = np.asarray(
        cluster_lnmarginal_pallas(**kw, interpret=True, tile_s=tile_s, tile_j=16)
    )
    m = np.isfinite(ref)
    assert not m[2] and not np.isfinite(got[2])
    np.testing.assert_allclose(got[m], ref[m], rtol=1e-8)


def test_pallas_narrow_valid_window():
    """A narrow valid-EEP window (3 rows, straddling no stride-4 index)
    must still be integrated exactly — the streaming-logsumexp kernel has
    no subsampled shift estimate to miss it (regression: an earlier coarse
    shift falsely marked such stars dead / truncated their peaks)."""
    rng = np.random.default_rng(0)
    E = 40
    valid = np.zeros(E, dtype=bool)
    valid[5:8] = True
    valid_j = jnp.asarray(valid)
    masses = jnp.asarray(np.sort(rng.uniform(0.3, 2.0, E)))
    kw = dict(
        lnlike_prop=jnp.asarray(rng.normal(-2, 1, (3, E))),
        model_mags=jnp.where(valid_j[:, None], jnp.asarray(rng.normal(10, 2, (E, 3))), 0.0),
        masses=jnp.where(valid_j, masses, 1.0),
        ln_dm_deeps=jnp.where(valid_j, jnp.asarray(rng.normal(-3, 0.5, E)), 0.0),
        eeps=jnp.asarray(np.sort(rng.uniform(200, 400, E))),
        mag_values=jnp.asarray(rng.normal(10, 2, (3, 3))),
        mag_uncs=jnp.asarray(rng.uniform(0.05, 0.2, (3, 3))),
        alpha=-2.35, gamma=0.3, fB=0.4, mass_lo=0.3, mass_hi=2.0, q_lo=0.2,
        valid=valid_j,
    )
    ref = _xla_ref(kw)
    got = np.asarray(cluster_lnmarginal_pallas(**kw, interpret=True, tile_j=16))
    m = np.isfinite(ref)
    np.testing.assert_allclose(got[m], ref[m], rtol=1e-8)
    # where the unshifted grid path underflows whole marginals to zero the
    # streaming kernel may legitimately resolve a tiny finite value
    assert np.all(got[~m] < -300)


def test_pallas_dead_star_minus_inf():
    """All -inf property likelihoods -> exactly -inf (not the -1e30
    sentinel), so the model layer counts the star as bad."""
    kw = _fixture(3, S=4, E=40, B=3)
    lnprop = np.array(kw["lnlike_prop"])
    lnprop[1, :] = -np.inf
    kw["lnlike_prop"] = jnp.asarray(lnprop)
    got = np.asarray(cluster_lnmarginal_pallas(**kw, interpret=True, tile_j=16))
    assert got[1] == -np.inf
    assert np.isfinite(got[[0, 2, 3]]).all()


def test_pallas_vmap_over_params():
    """vmap over parameter-dependent inputs (the chunked-walker batch
    path in cluster.py) matches sequential evaluation."""
    kw = _fixture(7, S=5, E=40, B=3)

    def f(fb):
        k = dict(kw, fB=fb)
        return cluster_lnmarginal_pallas(**k, interpret=True, tile_j=16)

    fbs = jnp.asarray([0.2, 0.5, 0.8])
    batched = np.asarray(jax.vmap(f)(fbs))
    seq = np.stack([np.asarray(f(x)) for x in fbs])
    np.testing.assert_allclose(batched, seq, rtol=1e-9)


def test_dispatcher_cpu_uses_xla_path():
    kw = _fixture(11)
    ref = _xla_ref(kw)
    got = np.asarray(cluster_lnmarginal(**kw))
    m = np.isfinite(ref)
    np.testing.assert_allclose(got[m], ref[m], rtol=1e-10)
    assert np.array_equal(np.isfinite(got), m)


def test_dispatcher_forced_pallas_matches():
    """``use_pallas=True, interpret=True`` runs the kernel in interpret
    mode through the dispatcher."""
    kw = _fixture(13, S=6, E=45, B=3)
    ref = _xla_ref(kw)
    got = np.asarray(cluster_lnmarginal(**kw, use_pallas=True, interpret=True))
    m = np.isfinite(ref)
    np.testing.assert_allclose(got[m], ref[m], rtol=1e-8)


def test_dispatcher_forced_without_interpret_on_cpu_raises():
    """Forcing the compiled kernel where there is no GPU is an error, never
    a silent interpret-mode run."""
    kw = _fixture(13, S=6, E=45, B=3)
    with pytest.raises(RuntimeError, match="needs a GPU"):
        cluster_lnmarginal(**kw, use_pallas=True)


@pytest.mark.parametrize("dtype,use_pallas,interpret,expect", [
    (jnp.float32, None, False, True),  # the GPU's default: compiled kernel
    (jnp.float64, None, False, False),  # float64: the XLA grid path
    (jnp.float32, False, False, False),  # explicit XLA grid path
    (jnp.float32, True, False, True),  # forced compiled kernel
    (jnp.float64, None, True, True),  # interpret mode, any dtype
])
def test_dispatcher_gpu_choice(monkeypatch, dtype, use_pallas, interpret, expect):
    """The path the dispatcher picks on a GPU (backend faked), per dtype
    and option."""
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert kernel_path(dtype, use_pallas, interpret) is expect


def test_dispatcher_f64_forced_on_gpu_raises(monkeypatch):
    """The compiled kernel is float32 only: forcing it on float64 inputs
    raises instead of falling back with a warning."""
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    with pytest.raises(ValueError, match="float32 only"):
        kernel_path(jnp.float64, True)


def test_dispatcher_cpu_choice():
    """On the CPU the dispatcher never picks the compiled kernel."""
    assert kernel_path(jnp.float32) is False
    assert kernel_path(jnp.float64) is False
