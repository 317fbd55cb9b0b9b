"""On-device affine-invariant ensemble MCMC.

Replaces the reference's external ``emcee`` dependency
(``isochrones/starmodel.py:886-972`` ``fit_mcmc``, ``isochrones/fit.py:9-170``
emcee3 harness): the entire chain — proposal, accept/reject, thinned storage —
runs inside one ``lax.scan`` on device, with the log-posterior vmapped across
walkers. A whole fit never leaves the chip.

Moves: Goodman & Weare (2010) stretch, differential evolution (ter Braak
2006), DE-snooker (ter Braak & Vrugt 2008), and a Gaussian-KDE move
(emcee's ``KDEMove``: propose from a kernel-density estimate of the
complementary half). ``moves="mixed"`` is the reference harness's actual
mixture — KDE/DE/DESnooker at 0.4/0.4/0.2 (fit.py:110-120). The KDE
density evaluation is an O(half²) pairwise matrix — a trivially
XLA-friendly batched quadratic form, unlike the scipy loop the reference
delegates to. Each full-ensemble update draws one move for both
half-updates via ``lax.switch``.

Multi-chip: walkers shard trivially along the batch axis (see
``isochrones_tpu.parallel``); the stretch move only needs the complementary
half-ensemble, which lives on the same shard when walkers are interleaved.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

__all__ = ["EnsembleState", "run_ensemble", "run_ensemble_batch", "autocorr_time"]


class EnsembleState(NamedTuple):
    walkers: jnp.ndarray  # (n_walkers, n_params)
    ln_prob: jnp.ndarray  # (n_walkers,)
    key: jax.Array
    n_accept: jnp.ndarray  # (n_walkers,) acceptance counts


def _pick2_distinct(key, n, shape):
    """Two distinct indices in [0, n) per element of ``shape``."""
    k1, k2 = jax.random.split(key)
    a = jax.random.randint(k1, shape, 0, n)
    b = jax.random.randint(k2, shape, 0, n - 1)
    b = b + (b >= a)
    return a, b


def _pick3_distinct(key, n, shape):
    """Three distinct indices in [0, n) per element of ``shape``."""
    k12, k3 = jax.random.split(key)
    a, b = _pick2_distinct(k12, n, shape)
    c = jax.random.randint(k3, shape, 0, n - 2)
    lo = jnp.minimum(a, b)
    hi = jnp.maximum(a, b)
    c = c + (c >= lo)
    c = c + (c >= hi)
    return a, b, c


def _mh_accept(key, active, lnp_active, proposal, lnp_prop, ln_factor):
    """Metropolis-Hastings accept/reject with an extra ln proposal factor."""
    lnp_prop = jnp.where(jnp.isnan(lnp_prop), -jnp.inf, lnp_prop)
    ln_ratio = ln_factor + lnp_prop - lnp_active
    accept = jnp.log(jax.random.uniform(key, lnp_active.shape, dtype=active.dtype)) < ln_ratio
    new_active = jnp.where(accept[:, None], proposal, active)
    new_lnp = jnp.where(accept, lnp_prop, lnp_active)
    return new_active, new_lnp, accept


def _stretch_half(lnpost_v, active, passive, lnp_active, key, a=2.0):
    """One stretch-move update of the active half against the passive half
    (Goodman & Weare 2010; emcee's default)."""
    n_act, n_dim = active.shape
    k_z, k_pick, k_acc = jax.random.split(key, 3)
    u = jax.random.uniform(k_z, (n_act,), dtype=active.dtype)
    z = ((a - 1.0) * u + 1.0) ** 2 / a
    picks = jax.random.randint(k_pick, (n_act,), 0, passive.shape[0])
    partners = passive[picks]
    proposal = partners + z[:, None] * (active - partners)
    lnp_prop = lnpost_v(proposal)
    return _mh_accept(k_acc, active, lnp_active, proposal, lnp_prop, (n_dim - 1.0) * jnp.log(z))


def _de_half(lnpost_v, active, passive, lnp_active, key, sigma=1e-5):
    """Differential-evolution move (ter Braak 2006; the reference harness's
    ``DEMove`` slot, fit.py:94): jump along the difference of two distinct
    complementary walkers, gamma = 2.38/sqrt(2 d) with 10% 'big jump'
    (gamma=1) steps for mode hopping."""
    n_act, n_dim = active.shape
    k_pick, k_g, k_eps, k_acc = jax.random.split(key, 4)
    i, j = _pick2_distinct(k_pick, passive.shape[0], (n_act,))
    diff = passive[i] - passive[j]
    g0 = 2.38 / jnp.sqrt(2.0 * n_dim)
    big = jax.random.uniform(k_g, (n_act,), dtype=active.dtype) < 0.1
    gamma = jnp.where(big, 1.0, g0).astype(active.dtype)
    eps = jax.random.normal(k_eps, active.shape, dtype=active.dtype) * sigma
    proposal = active + gamma[:, None] * diff + eps
    lnp_prop = lnpost_v(proposal)
    return _mh_accept(k_acc, active, lnp_active, proposal, lnp_prop, 0.0)


def _snooker_half(lnpost_v, active, passive, lnp_active, key, gammas=1.7):
    """DE-snooker move (ter Braak & Vrugt 2008; the reference harness's
    ``DESnookerMove`` slot, fit.py:95): jump along the line through a third
    walker, with the |q-z|/|s-z|^(d-1) Jacobian factor."""
    n_act, n_dim = active.shape
    k_pick, k_acc = jax.random.split(key)
    iz, i1, i2 = _pick3_distinct(k_pick, passive.shape[0], (n_act,))
    z = passive[iz]
    delta = active - z
    norm = jnp.sqrt(jnp.sum(delta * delta, axis=-1))
    u = delta / jnp.where(norm == 0, jnp.ones_like(norm), norm)[:, None]
    proj = jnp.sum((passive[i1] - passive[i2]) * u, axis=-1)
    proposal = active + gammas * proj[:, None] * u
    norm_q = jnp.sqrt(jnp.sum((proposal - z) ** 2, axis=-1))
    ln_factor = (n_dim - 1.0) * (
        jnp.log(jnp.maximum(norm_q, 1e-300)) - jnp.log(jnp.maximum(norm, 1e-300))
    )
    lnp_prop = lnpost_v(proposal)
    return _mh_accept(k_acc, active, lnp_active, proposal, lnp_prop, ln_factor)


def _kde_half(lnpost_v, active, passive, lnp_active, key):
    """Gaussian-KDE move (emcee ``KDEMove``; the reference harness's KDE
    slot, fit.py:110-120): propose x' = passive[i] + bandwidth-scaled
    Gaussian noise (scipy ``gaussian_kde`` Scott's-rule kernel over the
    complementary half), accepted with the independence-sampler ratio
    q(x)/q(x') where q is the KDE density itself. Both density evaluations
    are one (n_act, n_pas) batched Mahalanobis matrix + logsumexp — XLA
    fuses it; no scipy loop."""
    n_act, n_dim = active.shape
    n_pas = passive.shape[0]
    k_pick, k_eps, k_acc = jax.random.split(key, 3)

    mu = jnp.mean(passive, axis=0)
    c = passive - mu
    # scipy.gaussian_kde: kernel cov = scott_factor^2 * sample cov (ddof=1)
    cov = jnp.matmul(c.T, c, precision=jax.lax.Precision.HIGHEST) / (n_pas - 1)
    h = float(n_pas) ** (-1.0 / (n_dim + 4))  # Scott's rule
    # Regularization must scale WITH the parameter scales: the sample cov has
    # rank <= n_pas - 1 and f32 rounding leaves eigenvalues negative by far
    # more than an absolute 1e-12 when diag ~ 1e4 (a distance-like axis), in
    # which case cholesky silently returns NaN and every proposal is
    # rejected. Ridge each axis by a fraction of its own variance; when the
    # passive half cannot span the space (n_pas <= n_dim) a larger diagonal
    # blend keeps the kernel full-rank (the independence-sampler ratio below
    # uses the same kernel, so any SPD choice stays exact).
    lam = 1e-6 if n_pas > n_dim else 1e-2
    diag = jnp.diag(cov)
    ridge = lam * diag + 1e-12 * (1.0 + jnp.max(diag))
    kcov = (h * h) * (cov + jnp.diag(ridge))
    L = jnp.linalg.cholesky(kcov)

    picks = jax.random.randint(k_pick, (n_act,), 0, n_pas)
    eps = jax.random.normal(k_eps, active.shape, dtype=active.dtype)
    proposal = passive[picks] + jnp.matmul(eps, L.T, precision=jax.lax.Precision.HIGHEST)

    def ln_kde(x):
        # (n, d) -> (n,): logsumexp of kernel densities over passive points.
        # Constants (normalization, -log n_pas) cancel in the MH ratio.
        d = x[:, None, :] - passive[None, :, :]  # (n, n_pas, dim)
        y = jax.scipy.linalg.solve_triangular(L, d.reshape(-1, n_dim).T, lower=True)
        maha = jnp.sum(y * y, axis=0).reshape(x.shape[0], n_pas)
        return jax.scipy.special.logsumexp(-0.5 * maha, axis=1)

    # independence sampler: ln alpha = [lnp(x') - ln q(x')] - [lnp(x) - ln q(x)]
    ln_factor = ln_kde(active) - ln_kde(proposal)
    lnp_prop = lnpost_v(proposal)
    return _mh_accept(k_acc, active, lnp_active, proposal, lnp_prop, ln_factor)


# mixture weights per `moves` mode: (stretch, de, snooker, kde)
_MOVE_WEIGHTS = {
    "stretch": (1.0, 0.0, 0.0, 0.0),
    "de": (0.0, 1.0, 0.0, 0.0),
    "snooker": (0.0, 0.0, 1.0, 0.0),
    "kde": (0.0, 0.0, 0.0, 1.0),
    "mixed": (0.0, 0.4, 0.2, 0.4),  # reference fit.py:110-120: KDE/DE/snooker .4/.4/.2
}


@partial(jax.jit, static_argnames=("lnpost_v", "n_steps", "thin", "a", "moves"))
def run_ensemble(
    lnpost_v: Callable,
    walkers0: jnp.ndarray,
    key: jax.Array,
    n_steps: int,
    thin: int = 1,
    a: float = 2.0,
    moves: str = "stretch",
):
    """Run the ensemble sampler for ``n_steps`` full-ensemble updates.

    lnpost_v : vmapped log-posterior, (n, n_params) -> (n,)
    walkers0 : (n_walkers, n_params) initial positions (n_walkers even)
    moves : "stretch" | "de" | "snooker" | "kde" | "mixed" (KDE/DE/snooker
        0.4/0.4/0.2, the reference emcee3 harness mixture,
        fit.py:110-120 — better mixing on correlated
        posteriors than stretch-only)
    Returns (chain (n_steps//thin, n_walkers, n_params),
             ln_chain (n_steps//thin, n_walkers),
             final EnsembleState).
    """
    n_walkers = walkers0.shape[0]
    half = n_walkers // 2
    lnp0 = lnpost_v(walkers0)
    lnp0 = jnp.where(jnp.isnan(lnp0), -jnp.inf, lnp0)
    state0 = EnsembleState(
        walkers=walkers0, ln_prob=lnp0, key=key, n_accept=jnp.zeros(n_walkers, dtype=jnp.int32)
    )

    w_moves = _MOVE_WEIGHTS[moves]
    if moves == "mixed" and half <= walkers0.shape[1] + 1:
        # an n_pas-point KDE in n_dim >= n_pas - 1 is a poor density estimate
        # (independence-sampler acceptance measured ~3% for 8 points / 7
        # dims even with an SPD kernel); fall back to the DE/snooker blend
        # for small ensembles rather than spend 40% of updates near-rejected
        w_moves = (0.0, 0.6, 0.4, 0.0)
    weights = jnp.asarray(w_moves)
    branches = [
        lambda act, pas, lnp, k: _stretch_half(lnpost_v, act, pas, lnp, k, a=a),
        lambda act, pas, lnp, k: _de_half(lnpost_v, act, pas, lnp, k),
        lambda act, pas, lnp, k: _snooker_half(lnpost_v, act, pas, lnp, k),
        lambda act, pas, lnp, k: _kde_half(lnpost_v, act, pas, lnp, k),
    ]

    def update_half(move_idx, active, passive, lnp_active, k):
        if moves in ("stretch", "de", "snooker", "kde"):  # static: no switch
            idx = {"stretch": 0, "de": 1, "snooker": 2, "kde": 3}[moves]
            return branches[idx](active, passive, lnp_active, k)
        return jax.lax.switch(move_idx, branches, active, passive, lnp_active, k)

    def one_step(state: EnsembleState, _):
        key, k_move, k1, k2 = jax.random.split(state.key, 4)
        move_idx = jax.random.choice(k_move, 4, p=weights)
        w = state.walkers
        lnp = state.ln_prob
        first, second = w[:half], w[half:]
        lnp1, lnp2 = lnp[:half], lnp[half:]

        new_first, new_lnp1, acc1 = update_half(move_idx, first, second, lnp1, k1)
        new_second, new_lnp2, acc2 = update_half(move_idx, second, new_first, lnp2, k2)

        walkers = jnp.concatenate([new_first, new_second], axis=0)
        ln_prob = jnp.concatenate([new_lnp1, new_lnp2], axis=0)
        n_accept = state.n_accept + jnp.concatenate([acc1, acc2]).astype(jnp.int32)
        new_state = EnsembleState(walkers=walkers, ln_prob=ln_prob, key=key, n_accept=n_accept)
        return new_state, None

    def thin_step(state, _):
        state, _ = jax.lax.scan(one_step, state, None, length=thin)
        return state, (state.walkers, state.ln_prob)

    final, (chain, ln_chain) = jax.lax.scan(thin_step, state0, None, length=n_steps // thin)
    return chain, ln_chain, final


@partial(jax.jit, static_argnames=("lnpost_v", "n_steps", "thin", "a"))
def run_ensemble_batch(
    lnpost_v: Callable,
    walkers0: jnp.ndarray,
    key: jax.Array,
    n_steps: int,
    thin: int = 1,
    a: float = 2.0,
):
    """Many independent ensembles advanced in lockstep — one XLA program
    fitting a whole catalog of stars simultaneously (the on-device
    replacement for the reference's SLURM fleet-of-fits,
    scripts/batch_starfit).

    lnpost_v : (S, n, n_params) -> (S, n) per-star vmapped log-posterior
    walkers0 : (S, n_walkers, n_params)
    Returns (chain (n_steps//thin, S, n_walkers, n_params),
             ln_chain (n_steps//thin, S, n_walkers), final state tuple).
    """
    S, n_walkers, n_dim = walkers0.shape
    half = n_walkers // 2

    def stretch_half(active, passive, lnp_active, lnp_prop_fn, key):
        # active: (S, half, D); passive: (S, half, D)
        k_z, k_pick, k_acc = jax.random.split(key, 3)
        u = jax.random.uniform(k_z, (S, half), dtype=active.dtype)
        z = ((a - 1.0) * u + 1.0) ** 2 / a
        picks = jax.random.randint(k_pick, (S, half), 0, passive.shape[1])
        partners = jnp.take_along_axis(passive, picks[..., None], axis=1)
        proposal = partners + z[..., None] * (active - partners)
        lnp_prop = lnp_prop_fn(proposal)
        lnp_prop = jnp.where(jnp.isnan(lnp_prop), -jnp.inf, lnp_prop)
        ln_ratio = (n_dim - 1.0) * jnp.log(z) + lnp_prop - lnp_active
        accept = jnp.log(jax.random.uniform(k_acc, (S, half), dtype=active.dtype)) < ln_ratio
        new_active = jnp.where(accept[..., None], proposal, active)
        new_lnp = jnp.where(accept, lnp_prop, lnp_active)
        return new_active, new_lnp, accept

    lnp0 = lnpost_v(walkers0)
    lnp0 = jnp.where(jnp.isnan(lnp0), -jnp.inf, lnp0)

    def one_step(state, _):
        key, w, lnp, n_acc = state
        key, k1, k2 = jax.random.split(key, 3)
        first, second = w[:, :half], w[:, half:]
        lnp1, lnp2 = lnp[:, :half], lnp[:, half:]
        new_first, new_lnp1, acc1 = stretch_half(first, second, lnp1, lnpost_v, k1)
        new_second, new_lnp2, acc2 = stretch_half(second, new_first, lnp2, lnpost_v, k2)
        w = jnp.concatenate([new_first, new_second], axis=1)
        lnp = jnp.concatenate([new_lnp1, new_lnp2], axis=1)
        n_acc = n_acc + jnp.concatenate([acc1, acc2], axis=1).astype(jnp.int32)
        return (key, w, lnp, n_acc), None

    def thin_step(state, _):
        state, _ = jax.lax.scan(one_step, state, None, length=thin)
        return state, (state[1], state[2])

    state0 = (key, walkers0, lnp0, jnp.zeros((S, n_walkers), dtype=jnp.int32))
    final, (chain, ln_chain) = jax.lax.scan(thin_step, state0, None, length=n_steps // thin)
    return chain, ln_chain, final


def autocorr_time(chain) -> jnp.ndarray:
    """Integrated autocorrelation time per parameter (Sokal window heuristic,
    same role as emcee's convergence criterion used at fit.py:100-140).

    chain : (n_steps, n_walkers, n_params)
    """
    import numpy as np

    x = np.asarray(chain)
    n_steps, n_walkers, n_params = x.shape
    taus = np.empty(n_params)
    for p in range(n_params):
        d = x[:, :, p] - x[:, :, p].mean(axis=0, keepdims=True)
        # FFT autocorrelation averaged over walkers
        n = 1 << (2 * n_steps - 1).bit_length()
        f = np.fft.rfft(d, n=n, axis=0)
        acf = np.fft.irfft(f * np.conj(f), n=n, axis=0)[:n_steps].mean(axis=1)
        acf /= acf[0] if acf[0] != 0 else 1.0
        # Sokal automatic windowing
        tau = 2.0 * np.cumsum(acf) - 1.0
        window = np.arange(len(tau)) < 5.0 * tau
        idx = np.argmin(window) if not window.all() else len(tau) - 1
        taus[p] = tau[max(idx, 1)]
    return taus
