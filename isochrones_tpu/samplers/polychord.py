"""On-device PolyChord-style nested sampling (slice-sampling replacement).

The reference optionally fits with the Fortran PolyChord sampler
(``isochrones/starmodel.py:703-715``; path injection via ``config.py:7``),
whose defining feature vs MultiNest is *slice sampling* of the constrained
prior (Handley, Hobson & Lasenby 2015). This module is the on-device
counterpart — and, deliberately, an INDEPENDENT constrained-replacement
implementation from :mod:`.nested`'s adaptive random walk, so the two
on-device nested samplers cross-check each other's evidences and posteriors
(the reference's multi-sampler role; see tests/test_polychord.py).

Algorithm per replacement: start from a random survivor and apply
``n_repeat`` sequential slice moves. Each move samples a direction from the
live-point covariance (whitened — the PolyChord trick that handles correlated
posteriors), brackets the slice with fixed-count stepping-out doublings, then
shrinks the bracket with fixed-count rejection steps (masked, so everything
stays shape-static under ``lax.scan``). Evidence assembly, chunked
termination (dlogz + ESS), and equal-weight resampling reuse the shared
Skilling machinery in :mod:`.nested` via its ``core=`` hook.
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from .nested import NestedResult, run_nested

__all__ = ["run_polychord"]

_N_EXPAND = 4  # stepping-out rounds (interval at least doubles per round -> up to ~3^4 * w0)
_N_SHRINK = 8  # shrinkage rejections per slice move


def _whitening(live_u):
    """Cholesky factor of the live-point covariance (shared helper; the
    slice sampler wants a slightly larger jitter than the walk kernel)."""
    from .nested import _live_cholesky

    return _live_cholesky(live_u, jitter=1e-10)


def _slice_move(lnlike_u, key, x0, lnl_star, L, w0):
    """One batched slice move for K chains: (K, d) -> (K, d).

    Directions are drawn in whitened space; points that never find an
    interior proposal stay put (their start is a survivor, so the invariant
    L > L* holds either way).
    """
    K, dim = x0.shape
    key, k_dir, k_u0 = jax.random.split(key, 3)
    n = jax.random.normal(k_dir, (K, dim), dtype=x0.dtype)
    n = n / jnp.linalg.norm(n, axis=-1, keepdims=True)
    dvec = jnp.matmul(n, L.T, precision=jax.lax.Precision.HIGHEST)  # covariance-whitened direction (PolyChord eq. 11 role)

    # initial bracket: [t_lo, t_hi] with x0 interior at random position
    u0 = jax.random.uniform(k_u0, (K,), dtype=x0.dtype)
    t_lo = -u0 * w0
    t_hi = t_lo + w0

    def _masked_lnl(xs):
        # NS explores the UNIT CUBE: outside it the prior mass is zero, so
        # outside counts as outside the slice. (The walk kernel enforces this
        # by reflection; without this mask, analytic likelihoods that stay
        # finite beyond the cube let replacements escape the prior volume and
        # bias ln Z low by O(1) — found via the correlated-Gaussian evidence.)
        in_cube = jnp.all((xs >= 0.0) & (xs <= 1.0), axis=-1)
        lnl = lnlike_u(xs)
        return jnp.where(in_cube & ~jnp.isnan(lnl), lnl, -jnp.inf)

    def eval_at(t):
        return _masked_lnl(x0 + t[:, None] * dvec)

    # stepping out: while an END is still inside the slice, push it outward
    # by the CURRENT bracket width (doubling the interval — Neal 2003 §4).
    # Doubling the endpoint VALUES instead would freeze any end that starts
    # near t=0 (u0 near 0 or 1), exploring only one side of the slice.
    # Both ends are evaluated in ONE likelihood batch of 2K points.
    def expand(carry, _):
        t_lo, t_hi = carry
        both = jnp.concatenate([t_lo, t_hi])
        xs = jnp.concatenate([x0, x0], axis=0) + both[:, None] * jnp.concatenate([dvec, dvec], axis=0)
        lnl_b = _masked_lnl(xs)
        inside_lo = lnl_b[:K] > lnl_star
        inside_hi = lnl_b[K:] > lnl_star
        width = t_hi - t_lo
        t_lo = jnp.where(inside_lo, t_lo - width, t_lo)
        t_hi = jnp.where(inside_hi, t_hi + width, t_hi)
        return (t_lo, t_hi), None

    (t_lo, t_hi), _ = jax.lax.scan(expand, (t_lo, t_hi), None, length=_N_EXPAND)

    # shrinkage: uniform proposals on the bracket; reject -> shrink toward 0
    def shrink(carry, _):
        key, t_lo, t_hi, x_cur, lnl_cur, done, tries = carry
        key, k_t = jax.random.split(key)
        t = t_lo + (t_hi - t_lo) * jax.random.uniform(k_t, (K,), dtype=x0.dtype)
        lnl_prop = eval_at(t)
        ok = (lnl_prop > lnl_star) & ~done
        tries = tries + (~done).astype(tries.dtype)  # proposals made while running
        x_cur = jnp.where(ok[:, None], x0 + t[:, None] * dvec, x_cur)
        lnl_cur = jnp.where(ok, lnl_prop, lnl_cur)
        newly_done = done | ok
        # standard slice shrinkage for still-running chains
        shrink_lo = (t < 0) & ~newly_done
        shrink_hi = (t >= 0) & ~newly_done
        t_lo = jnp.where(shrink_lo, t, t_lo)
        t_hi = jnp.where(shrink_hi, t, t_hi)
        return (key, t_lo, t_hi, x_cur, lnl_cur, newly_done, tries), None

    lnl0 = jnp.full((K,), -jnp.inf, dtype=x0.dtype)
    done0 = jnp.zeros((K,), dtype=bool)
    tries0 = jnp.zeros((K,), dtype=x0.dtype)
    (key, _, _, x_new, lnl_new, done, tries), _ = jax.lax.scan(
        shrink, (key, t_lo, t_hi, x0, lnl0, done0, tries0), None, length=_N_SHRINK
    )
    # mean proposals-to-acceptance: the bracket/slice width ratio in log2;
    # the adaptation target is ~2 tries (bracket ~2x slice width)
    mean_tries = jnp.mean(tries)
    return key, x_new, lnl_new, done, mean_tries


@partial(jax.jit, static_argnames=("lnlike_u", "n_live", "n_iter", "n_chains", "n_repeat", "n_batch"))
def _polychord_core(lnlike_u, u0, lnl0, key, scale0, n_live, n_iter, n_chains, n_repeat, n_batch=1):
    """Slice-sampling replacement core with :func:`.nested._nested_core`'s
    carry/return contract (so :func:`.nested.run_nested` can drive it).
    ``n_chains`` is unused (slice moves are single-chain, PolyChord-style)."""
    K = n_batch

    def one_iter(carry, _):
        key, live_u, live_lnl, scale = carry
        neg_vals, worst_idx = jax.lax.top_k(-live_lnl, K)
        dead_lnl = -neg_vals  # (K,) ascending
        dead_u = live_u[worst_idx]
        lnl_star = dead_lnl[-1]

        L = _whitening(live_u)

        key, k_start = jax.random.split(key)
        order = jnp.argsort(live_lnl)
        pick = jax.random.randint(k_start, (K,), K, n_live)
        x = live_u[order[pick]]
        lnl = live_lnl[order[pick]]

        def move(carry, _):
            key, x, lnl, t_acc = carry
            key, x_new, lnl_new, done, mean_tries = _slice_move(lnlike_u, key, x, lnl_star, L, scale)
            x = jnp.where(done[:, None], x_new, x)
            lnl = jnp.where(done, lnl_new, lnl)
            return (key, x, lnl, t_acc + mean_tries), None

        (key, x, lnl, t_sum), _ = jax.lax.scan(
            move, (key, x, lnl, jnp.zeros((), dtype=x.dtype)), None, length=n_repeat
        )
        live_u = live_u.at[worst_idx].set(x)
        live_lnl = live_lnl.at[worst_idx].set(lnl)
        # adapt the bracket width toward ~2 shrink proposals per acceptance
        mean_tries = t_sum / n_repeat
        scale = jnp.clip(scale * jnp.exp(0.3 * (2.0 - mean_tries)), 1e-4, 20.0)
        return (key, live_u, live_lnl, scale), (dead_u, dead_lnl)

    (key, live_u, live_lnl, scale), (dead_u, dead_lnl) = jax.lax.scan(
        one_iter, (key, u0, lnl0, scale0), None, length=n_iter
    )
    dead_u = dead_u.reshape(-1, dead_u.shape[-1])
    dead_lnl = dead_lnl.reshape(-1)
    return dead_u, dead_lnl, live_u, live_lnl, key, scale


def run_polychord(
    lnpost_u: Callable,
    prior_transform: Callable,
    n_params: int,
    key,
    n_live: int = 500,
    n_repeat: int = None,
    n_batch: int = 8,
    **kwargs,
) -> NestedResult:
    """PolyChord-parity nested sampling: slice replacement, whitened
    directions, same evidence/posterior conventions as :func:`run_nested`.

    n_repeat defaults to PolyChord's ``num_repeats`` heuristic ~ 2 * ndim
    slice moves per replacement (Handley et al. 2015, sec 3.3).
    """
    if n_repeat is None:
        n_repeat = max(4, 2 * n_params)
    kwargs.setdefault("n_chains", 1)
    return run_nested(
        lnpost_u,
        prior_transform,
        n_params,
        key,
        n_live=n_live,
        n_repeat=n_repeat,
        n_batch=n_batch,
        core=_polychord_core,
        **kwargs,
    )
