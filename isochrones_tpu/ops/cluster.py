"""Hierarchical-cluster likelihood kernels.

Rebuild of ``isochrones/cluster_utils.py:9-128`` (``calc_lnlike_grid`` +
``integrate_over_eeps``, numba prange/fastmath) as fused batched XLA:

* the (Nstars, Neep, Neep) binary-mixture photometric grid is built by
  broadcasting over a ``lax.fori_loop`` across bands (keeps the peak
  intermediate at one (Nstars, Neep, Neep) buffer instead of
  (Nstars, Neep, Neep, Nbands));
* the double trapezoid marginalization over (eep1, eep2) is a masked
  pairwise-sum;
* multi-device: the star axis shards cleanly (each device owns a block of
  stars' grids; total lnlike is a scalar psum) — see
  ``isochrones_tpu.parallel``.

Deviation from the reference (documented): the reference builds
``lnlike_prop`` as (Neep, Nstars) (cluster.py:316-325) but indexes it as
``lnlike_prop[i_star, j_eep]`` inside the numba kernel
(cluster_utils.py:102) — out-of-bounds UB whenever Nstars != Neep. Here the
intended (Nstars, Neep) orientation is required and bounds-checked by shape.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..device import on_accelerator

__all__ = [
    "calc_lnlike_grid",
    "integrate_over_eeps",
    "integrate_over_eeps_ln",
    "cluster_lnlike",
    "cluster_lnmarginal",
    "kernel_path",
    "logaddexp",
    "logsumexp",
]

# reference cluster_utils.py:9-27 exports jitted logaddexp/logsumexp helpers;
# here they ARE the jnp/XLA primitives (compat aliases for reference users)
logaddexp = jnp.logaddexp
logsumexp = jax.scipy.special.logsumexp


def _powerlaw_lnpdf(x, alpha, lo, hi):
    """reference priors.py:476-480"""
    a1 = alpha + 1.0
    C = a1 / (hi ** a1 - lo ** a1)
    return jnp.log(C) + alpha * jnp.log(x)


def calc_lnlike_grid(
    lnlike_prop,  # (Nstars, Neep)
    model_mags,  # (Neep, Nbands)
    masses,  # (Neep,)
    ln_dm_deeps,  # (Neep,)
    mag_values,  # (Nstars, Nbands)
    mag_uncs,  # (Nstars, Nbands)
    alpha,
    gamma,
    fB,
    mass_lo,
    mass_hi,
    q_lo,
    valid=None,  # (Neep,) bool: primary (j) rows with finite model values
    q_jacobian=False,
    valid_k=None,  # (Neep,) bool: secondary (k) rows; defaults to ``valid``
):
    """Lower-triangular (Nstars, Neep, Neep) grid of
    lnlike(photometry mixture) + lnlike(primary mass) + lnlike(mass ratio)
    + lnlike_prop, as a function of (eep1=j, eep2=k), k <= j
    (reference cluster_utils.py:30-105).

    ``fB`` is the binary fraction: each star's photometric likelihood is the
    ``fB``-weighted logaddexp mixture of the binary (flux sum of j,k) and
    single (j only) models.

    q_jacobian : the reference integrates ``pl(q)`` over the eep2 MEASURE
        without the ``|dq/deep2| = (dm/deep)_k / m_j`` change-of-variables
        factor (cluster_utils.py:101 applies ``ln_dm_deeps`` to the primary
        only) — the integrand is then not the generative density of
        (m1 ~ PL(alpha), q ~ PL(gamma)) and biases the inferred (fB, gamma)
        against simulations that draw q directly (measured: fB 0.3 fitted
        as ~0.5). False (default) preserves exact reference parity; True
        adds ``ln_dm_deeps[k] - ln m_j`` so the grid IS that generative
        density in EEP coordinates (validated by the cluster mini-SBC).
    valid_k : separate validity for the secondary axis. The reference
        constrains the secondary through ``q >= q_lo`` ONLY
        (cluster_utils.py:69-70) — its mass-prior box applies to the
        primary. Passing the primary mask (the old behavior and the
        default) silently forces binaries whose secondary falls below the
        primary mass box into the single component.
    """
    n_eep = model_mags.shape[0]
    n_bands = model_mags.shape[1]
    n_stars = mag_values.shape[0]
    assert lnlike_prop.shape == (n_stars, n_eep), "lnlike_prop must be (Nstars, Neep)"
    dt = model_mags.dtype

    if valid is None:
        valid = jnp.ones(n_eep, dtype=bool)
    if valid_k is None:
        valid_k = valid
    either = valid | valid_k
    safe_mags = jnp.where(either[:, None], model_mags, jnp.zeros_like(model_mags))
    safe_masses = jnp.where(either, masses, jnp.ones_like(masses))

    flux = 10.0 ** (-0.4 * safe_mags)  # (Neep, Nbands)

    # accumulate the photometric mixture over bands without materializing a
    # (Nstars, Neep, Neep, Nbands) tensor
    def band_term(b, acc):
        f1 = flux[:, b][:, None]  # (Neep, 1) primary (j)
        f2 = flux[:, b][None, :]  # (1, Neep) secondary (k)
        tot_mag_binary = -2.5 * jnp.log10(f1 + f2)  # (Neep, Neep)
        mag_v = mag_values[:, b][:, None, None]  # (Nstars, 1, 1)
        mag_u = mag_uncs[:, b][:, None, None]
        resid_b = tot_mag_binary[None] - mag_v
        lnlike_binary = -0.5 * resid_b * resid_b / (mag_u * mag_u)
        resid_s = safe_mags[:, b][None, :, None] - mag_v  # single: primary j only
        lnlike_single = -0.5 * resid_s * resid_s / (mag_u * mag_u)
        mix = jnp.logaddexp(jnp.log(fB) + lnlike_binary, jnp.log(1.0 - fB) + lnlike_single)
        return acc + mix

    # init carry derived from mag_values so it inherits any shard_map
    # "varying" axis of the star dimension (a plain jnp.zeros is replicated
    # and the loop would mix varying/replicated carries)
    acc0 = jnp.zeros_like(mag_values[:, 0]).astype(dt)[:, None, None] + jnp.zeros(
        (n_eep, n_eep), dtype=dt
    )
    lnlike_phot = jax.lax.fori_loop(0, n_bands, band_term, acc0)

    q = safe_masses[None, :] / safe_masses[:, None]  # (Neep_j, Neep_k): m_k / m_j
    lnlike_mass = _powerlaw_lnpdf(safe_masses, alpha, mass_lo, mass_hi) + ln_dm_deeps  # (Neep,)
    lnlike_q = _powerlaw_lnpdf(q, gamma, q_lo, 1.0)  # (Neep, Neep)
    if q_jacobian:
        lnlike_q = lnlike_q + ln_dm_deeps[None, :] - jnp.log(safe_masses)[:, None]

    out = (
        lnlike_phot
        + lnlike_mass[None, :, None]
        + lnlike_q[None, :, :]
        + lnlike_prop[:, :, None]
    )

    # mask: q < q_lo -> -inf (cluster_utils.py:72-74); invalid rows/cols and
    # the upper triangle (k > j) contribute nothing downstream
    tri = jnp.tril(jnp.ones((n_eep, n_eep), dtype=bool))
    mask = (q >= q_lo) & tri & valid[:, None] & valid_k[None, :]
    return jnp.where(mask[None], out, -jnp.inf)


def integrate_over_eeps(lnlike_grid, eeps):
    """Double trapezoid over (eep2 then eep1) per star
    (reference cluster_utils.py:108-128). Returns (Nstars,) linear-space
    marginalized likelihoods."""
    return jnp.exp(integrate_over_eeps_ln(lnlike_grid, eeps))


def integrate_over_eeps_ln(lnlike_grid, eeps):
    """Log-space :func:`integrate_over_eeps`: (Nstars,) ln of the double
    trapezoid, max-shifted per star. The raw exp-space sum (which the
    reference uses, cluster_utils.py:108-128) underflows to exactly 0 — and
    the marginal to -inf — once a star's whole (eep1, eep2) grid drops below
    ~-745 nats, which real prior boxes reach at their distance/age edges;
    a nested/MCMC sampler then sees a spurious zero-support region. The
    Pallas kernel streams a shifted logsumexp and never had the problem."""
    m = jnp.max(lnlike_grid, axis=(1, 2))  # (Nstars,)
    m_safe = jnp.where(jnp.isfinite(m), m, 0.0)
    like = jnp.exp(lnlike_grid - m_safe[:, None, None])  # -inf -> 0, max -> 1
    n = eeps.shape[0]
    de = eeps[1:] - eeps[:-1]  # (Neep-1,)

    # inner trapezoid over k, restricted to k+1 <= j:
    # row[i, j] = sum_k 0.5 (like[i,j,k] + like[i,j,k+1]) de[k]  for k+1 <= j
    pair = 0.5 * (like[:, :, :-1] + like[:, :, 1:]) * de[None, None, :]
    kmask = (jnp.arange(1, n)[None, :] <= jnp.arange(n)[:, None])  # (Neep_j, Neep-1_k)
    row = jnp.sum(jnp.where(kmask[None], pair, 0.0), axis=-1)  # (Nstars, Neep)

    # outer trapz over j
    integral = jnp.sum(0.5 * (row[:, :-1] + row[:, 1:]) * de[None, :], axis=-1)
    return m_safe + jnp.log(integral)


def kernel_path(dtype, use_pallas=None, interpret=False):
    """Whether :func:`cluster_lnmarginal` runs the Pallas kernel.

    The rule: ``use_pallas=None`` picks the compiled kernel on a GPU for
    float32 inputs and the XLA grid path otherwise (float64 on a GPU
    included — the compiled kernel is float32 only), or the kernel in
    interpret mode when ``interpret=True``. ``use_pallas=True`` without
    ``interpret`` demands the compiled kernel and raises where it cannot
    run (no GPU, or float64 inputs) instead of quietly interpreting or
    falling back. ``use_pallas=False`` is the XLA grid path."""
    if use_pallas is False:
        return False
    if interpret:
        return True
    f32 = jnp.dtype(dtype) == jnp.float32
    if use_pallas is None:
        return on_accelerator() and f32
    if not on_accelerator():
        raise RuntimeError(
            "the compiled cluster kernel needs a GPU backend; pass "
            "interpret=True to run it on the CPU"
        )
    if not f32:
        raise ValueError(
            f"the compiled cluster kernel is float32 only, got {jnp.dtype(dtype)}; "
            "use use_pallas=None (XLA grid path) or interpret=True"
        )
    return True


def cluster_lnmarginal(
    lnlike_prop, model_mags, masses, ln_dm_deeps, eeps, mag_values, mag_uncs,
    alpha, gamma, fB, mass_lo, mass_hi, q_lo, valid=None, use_pallas=None,
    q_jacobian=False, valid_k=None, interpret=False,
):
    """Per-star ln marginal likelihood (S,) — ``log(integrate_over_eeps(
    calc_lnlike_grid(...)))`` with a backend switch (:func:`kernel_path`).
    On a GPU this runs the fused Pallas kernel
    (:mod:`isochrones_tpu.ops.cluster_pallas`), which never materializes
    the (S, E, E) plane in device memory; elsewhere it runs the XLA path.
    Returns -inf where the marginal is zero."""
    if valid is None:
        valid = jnp.ones(model_mags.shape[0], dtype=bool)
    if kernel_path(model_mags.dtype, use_pallas, interpret):
        from .cluster_pallas import cluster_lnmarginal_pallas

        return cluster_lnmarginal_pallas(
            lnlike_prop, model_mags, masses, ln_dm_deeps, eeps, mag_values,
            mag_uncs, alpha, gamma, fB, mass_lo, mass_hi, q_lo, valid,
            interpret=interpret, q_jacobian=q_jacobian, valid_k=valid_k,
        )
    grid = calc_lnlike_grid(
        lnlike_prop, model_mags, masses, ln_dm_deeps, mag_values, mag_uncs,
        alpha, gamma, fB, mass_lo, mass_hi, q_lo, valid=valid,
        q_jacobian=q_jacobian, valid_k=valid_k,
    )
    return integrate_over_eeps_ln(grid, eeps)


@partial(jax.jit, static_argnames=())
def cluster_lnlike(
    lnlike_prop, model_mags, masses, ln_dm_deeps, eeps, mag_values, mag_uncs,
    alpha, gamma, fB, mass_lo, mass_hi, q_lo, valid=None,
):
    """Fused grid build + marginalization + star-sum (reference
    cluster.py:365-378). Returns scalar total lnlike (-inf if any star has
    zero marginal likelihood). Underflow-safe: the per-star marginals come
    from the max-shifted :func:`integrate_over_eeps_ln`, so a star whose
    whole grid sits below exp-underflow contributes its tiny-but-finite
    ln-marginal instead of zeroing the cluster."""
    grid = calc_lnlike_grid(
        lnlike_prop, model_mags, masses, ln_dm_deeps, mag_values, mag_uncs,
        alpha, gamma, fB, mass_lo, mass_hi, q_lo, valid=valid,
    )
    ln_marg = integrate_over_eeps_ln(grid, eeps)
    total = jnp.sum(ln_marg)
    return jnp.where(jnp.any(jnp.isneginf(ln_marg)) | jnp.isnan(total), -jnp.inf, total)
