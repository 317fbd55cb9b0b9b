"""On-device No-U-Turn Sampler (NUTS).

The SURVEY §7 build plan calls for an on-device NUTS (blackjax-style) next to
the ensemble sampler; no probabilistic-programming library is available in
this environment, so this is a from-scratch implementation of multinomial
NUTS (Hoffman & Gelman 2014; multinomial variant of Betancourt 2017) in the
ITERATIVE formulation: subtrees are built by a ``lax.while_loop`` over
leapfrog leaves with a checkpoint stack of O(max_depth) states, and U-turn
checks use the binary-counter bit tricks

* leaf ``n`` (even) stores a checkpoint at index ``popcount(n)``;
* leaf ``n`` (odd) closes ``trailing_zeros(n+1)`` subtrees and checks
  U-turns against checkpoint indices ``[popcount(n)-1 - tz(n+1) + 1,
  popcount(n)-1]``.

Everything vmaps across chains (lockstep while_loops), so a whole multi-chain
NUTS run is one XLA program. Warmup: dual-averaging step-size adaptation +
diagonal mass-matrix estimation in three phases.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["run_nuts", "NutsResult"]

DIVERGENCE = 1000.0


class NutsResult(NamedTuple):
    samples: np.ndarray  # (n_samples, n_chains, dim)
    lnp: np.ndarray  # (n_samples, n_chains)
    step_size: np.ndarray  # (n_chains,)
    inv_mass: np.ndarray  # (n_chains, dim)
    accept_rate: np.ndarray  # (n_chains,) mean warmup-adapted accept stat
    n_divergent: np.ndarray  # (n_chains,)


def _popcount(n):
    n = n.astype(jnp.uint32)
    c = jnp.zeros_like(n)
    for _ in range(32):
        c = c + (n & 1)
        n = n >> 1
    return c.astype(jnp.int32)


def _trailing_zeros(n):
    n = n.astype(jnp.uint32)
    # tz(n) = popcount((n & -n) - 1)
    return _popcount((n & (~n + jnp.uint32(1))) - jnp.uint32(1))


def _safe_value_and_grad(logp):
    vg = jax.value_and_grad(logp)

    def fn(z):
        v, g = vg(z)
        bad = ~jnp.isfinite(v)
        v = jnp.where(bad, -jnp.inf, v)
        g = jnp.where(jnp.isfinite(g) & ~bad, g, 0.0)
        return v, g

    return fn


def _uturn(dz, r_l, r_r, inv_mass):
    return (jnp.dot(dz, inv_mass * r_l) < 0) | (jnp.dot(dz, inv_mass * r_r) < 0)


def _make_kernel(logp, dim, max_depth):
    """One NUTS transition: (key, z, lnp, grad, eps, inv_mass) ->
    (z', lnp', grad', accept_stat, divergent)."""
    vg = _safe_value_and_grad(logp)

    def leapfrog(z, r, g, eps, inv_mass):
        r_half = r + 0.5 * eps * g
        z_new = z + eps * inv_mass * r_half
        lnp_new, g_new = vg(z_new)
        r_new = r_half + 0.5 * eps * g_new
        return z_new, r_new, lnp_new, g_new

    def build_subtree(key, z0, r0, g0, eps_signed, inv_mass, h0, n_leaves):
        """Iterative subtree of ``n_leaves`` leapfrog leaves from (z0, r0).

        Returns (z_end, r_end, g_end, z_prop, lnp_prop, g_prop, logw_sub,
        turning, divergent, sum_alpha, key)."""
        z_ck = jnp.zeros((max_depth + 1, dim), dtype=z0.dtype)
        r_ck = jnp.zeros((max_depth + 1, dim), dtype=z0.dtype)

        def cond(state):
            (n, z, r, g, _, _, _, _, turning, divergent, _, _, _, _) = state
            return (n < n_leaves) & ~turning & ~divergent

        def body(state):
            (n, z, r, g, z_prop, lnp_prop, g_prop, logw, _, _, sum_alpha,
             z_ck, r_ck, key) = state
            # store checkpoint BEFORE stepping when n is even
            idx_store = _popcount(n)
            is_even = (n % 2) == 0
            z_ck = jnp.where(is_even, z_ck.at[idx_store].set(z), z_ck)
            r_ck = jnp.where(is_even, r_ck.at[idx_store].set(r), r_ck)

            z, r, lnp, g = leapfrog(z, r, g, eps_signed, inv_mass)
            e = -lnp + 0.5 * jnp.dot(r, inv_mass * r)
            logw_leaf = h0 - e  # ln of the multinomial weight
            divergent = (e - h0) > DIVERGENCE
            alpha = jnp.minimum(1.0, jnp.exp(jnp.minimum(logw_leaf, 0.0)))
            sum_alpha = sum_alpha + jnp.where(jnp.isnan(alpha), 0.0, alpha)

            # progressive multinomial proposal within the subtree
            logw_new = jnp.logaddexp(logw, logw_leaf)
            key, k_acc = jax.random.split(key)
            take = jnp.log(jax.random.uniform(k_acc)) < (logw_leaf - logw_new)
            z_prop = jnp.where(take, z, z_prop)
            lnp_prop = jnp.where(take, lnp, lnp_prop)
            g_prop = jnp.where(take, g, g_prop)

            # U-turn checks for every subtree closed by this (odd) leaf:
            # idx_max = popcount(n) - 1; n_checks = trailing_zeros(n + 1)
            pc = _popcount(n)
            n_checks = _trailing_zeros(n + 1)
            i_max = pc - 1
            i_min = i_max - n_checks + 1

            def check(i, turning):
                active = (i >= i_min) & (i <= i_max) & ((n % 2) == 1)
                dz = z - z_ck[i]
                t = _uturn(dz, r_ck[i], r, inv_mass)
                return turning | (active & t)

            turning = jax.lax.fori_loop(0, max_depth + 1, check, jnp.asarray(False))

            return (n + 1, z, r, g, z_prop, lnp_prop, g_prop, logw_new,
                    turning, divergent, sum_alpha, z_ck, r_ck, key)

        # the init proposal carries weight -inf and can never be selected
        # (the caller's merge needs finite logw_sub), so its lnp slot is a
        # dead placeholder — computing vg(z0) here wasted one full
        # value_and_grad per subtree
        lnp0 = jnp.asarray(-jnp.inf, dtype=z0.dtype)
        init = (
            jnp.asarray(0, dtype=jnp.int32), z0, r0, g0,
            z0, lnp0, g0, jnp.asarray(-jnp.inf, dtype=z0.dtype),
            jnp.asarray(False), jnp.asarray(False),
            jnp.asarray(0.0, dtype=z0.dtype), z_ck, r_ck, key,
        )
        (n, z, r, g, z_prop, lnp_prop, g_prop, logw, turning, divergent,
         sum_alpha, _, _, key) = jax.lax.while_loop(cond, body, init)
        return z, r, g, z_prop, lnp_prop, g_prop, logw, turning, divergent, sum_alpha, key

    def kernel(key, z, lnp, g, eps, inv_mass):
        key, k_mom = jax.random.split(key)
        r0 = jax.random.normal(k_mom, (dim,), dtype=z.dtype) / jnp.sqrt(inv_mass)
        h0 = -lnp + 0.5 * jnp.dot(r0, inv_mass * r0)

        def cond(state):
            (depth, _, _, _, _, _, _, _, _, _, _, turning, divergent, _, _, _) = state
            return (depth < max_depth) & ~turning & ~divergent

        def body(state):
            (depth, z_minus, r_minus, g_minus, z_plus, r_plus, g_plus,
             z_prop, lnp_prop, g_prop, logw, _, _, sum_alpha, n_leap, key) = state
            key, k_dir, k_merge, k_sub = jax.random.split(key, 4)
            v = jnp.where(jax.random.uniform(k_dir) < 0.5, -1.0, 1.0)
            n_leaves = jnp.asarray(2 ** 0, jnp.int32) << depth  # 2^depth

            z0 = jnp.where(v > 0, z_plus, z_minus)
            r0 = jnp.where(v > 0, r_plus, r_minus)
            g0 = jnp.where(v > 0, g_plus, g_minus)
            (z_end, r_end, g_end, z_psub, lnp_psub, g_psub, logw_sub,
             turn_sub, div_sub, sa, key) = build_subtree(
                k_sub, z0, r0, g0, v * eps, inv_mass, h0, n_leaves
            )
            sum_alpha = sum_alpha + sa
            n_leap = n_leap + n_leaves

            # merge proposal only if the subtree is valid
            ok = ~turn_sub & ~div_sub
            logw_new = jnp.logaddexp(logw, logw_sub)
            take = ok & (jnp.log(jax.random.uniform(k_merge)) < (logw_sub - logw_new))
            z_prop = jnp.where(take, z_psub, z_prop)
            lnp_prop = jnp.where(take, lnp_psub, lnp_prop)
            g_prop = jnp.where(take, g_psub, g_prop)
            logw = jnp.where(ok, logw_new, logw)

            z_minus2 = jnp.where(v > 0, z_minus, z_end)
            r_minus2 = jnp.where(v > 0, r_minus, r_end)
            g_minus2 = jnp.where(v > 0, g_minus, g_end)
            z_plus2 = jnp.where(v > 0, z_end, z_plus)
            r_plus2 = jnp.where(v > 0, r_end, r_plus)
            g_plus2 = jnp.where(v > 0, g_end, g_plus)

            # full-trajectory U-turn (momenta both point outward in time)
            turning = turn_sub | _uturn(z_plus2 - z_minus2, r_minus2, r_plus2, inv_mass)
            return (depth + 1, z_minus2, r_minus2, g_minus2, z_plus2, r_plus2,
                    g_plus2, z_prop, lnp_prop, g_prop, logw, turning, div_sub,
                    sum_alpha, n_leap, key)

        init = (
            jnp.asarray(0, jnp.int32), z, r0, g, z, r0, g,
            z, lnp, g, jnp.asarray(0.0, z.dtype),  # root leaf weight exp(h0-h0)=1
            jnp.asarray(False), jnp.asarray(False),
            jnp.asarray(0.0, z.dtype), jnp.asarray(0, jnp.int32), key,
        )
        out = jax.lax.while_loop(cond, body, init)
        (depth, z_minus, r_minus, g_minus, z_plus, r_plus, g_plus,
         z_prop, lnp_prop, g_prop, logw, turning, divergent, sum_alpha, n_leap, key) = out

        # (lnp, grad) of the proposal are carried through the merges —
        # recomputing vg(z_prop) here wasted one value_and_grad per
        # transition on top of the per-subtree waste above
        accept_stat = sum_alpha / jnp.maximum(n_leap, 1)
        return z_prop, lnp_prop, g_prop, accept_stat, divergent

    return kernel


@partial(jax.jit, static_argnames=("logp_batch", "dim", "n_warmup", "n_samples", "max_depth", "target_accept", "mesh", "eps_jitter"))
def _nuts_run(logp_batch, x0, key, dim, n_warmup, n_samples, max_depth, target_accept, inv_mass0=None, mesh=None, eps_jitter=1.0):
    n_chains = x0.shape[0]

    def logp_single(z):
        return logp_batch(z[None, :])[0]

    kernel = _make_kernel(logp_single, dim, max_depth)
    kernel_v = jax.vmap(kernel, in_axes=(0, 0, 0, 0, 0, 0))
    vg = jax.vmap(_safe_value_and_grad(logp_single))

    if mesh is not None:
        # chains shard over the mesh's first axis: each device advances its
        # block of independent chains (vmapped while_loops run lockstep only
        # within a shard). The pooled warmup variance (m2.mean over chains)
        # becomes a small XLA collective, so sharded != unsharded bitwise —
        # statistical equivalence is the contract (test_parallel).
        from ..parallel import mesh_wrap_fn

        kernel_v = mesh_wrap_fn(kernel_v, mesh)
        vg = mesh_wrap_fn(vg, mesh)

    lnp0, g0 = vg(x0)

    # --- warmup: dual averaging + Stan-style doubling mass windows ---
    gamma, t0, kappa = 0.05, 10.0, 0.75
    # dual-averaging floor (round-4 f32 diagnosis): in reduced precision the
    # accept statistic has a rounding-noise component, so alpha(eps) can sit
    # just below target_accept for EVERY eps below some band — dual
    # averaging then has no fixed point and walks log_eps down until
    # position updates quantize to zero against |z| ~ O(1) (a false
    # equilibrium at eps ~ 3e-7 in f32 where chains freeze but alpha looks
    # healthy). Clamp the step size three decades above the dtype's machine
    # epsilon: in f64 the floor (~2e-13) never engages; in f32 it keeps the
    # integrator in the regime where increments remain representable.
    log_eps_min = jnp.log(1e3 * jnp.finfo(x0.dtype).eps).astype(x0.dtype)

    def warm_phase(key, z, lnp, g, log_eps0, inv_mass, length, collect):
        """One adaptation phase: dual averaging (restarted) + optional
        Welford variance collection. Returns updated state + window var."""
        mu = jnp.log(10.0) + log_eps0

        def step(carry, i):
            key, z, lnp, g, log_eps, log_eps_bar, h_bar, welford = carry
            key, k = jax.random.split(key)
            keys = jax.random.split(k, n_chains)
            z, lnp, g, alpha, div = kernel_v(keys, z, lnp, g, jnp.exp(log_eps), inv_mass)
            m = i + 1.0
            eta = 1.0 / (m + t0)
            h_bar = (1 - eta) * h_bar + eta * (target_accept - alpha)
            log_eps = jnp.maximum(mu - jnp.sqrt(m) / gamma * h_bar, log_eps_min)
            w = m ** (-kappa)
            log_eps_bar = w * log_eps + (1 - w) * log_eps_bar
            count, mean, m2 = welford
            c_new = count + (1.0 if collect else 0.0)
            delta = z - mean
            if collect:
                mean = mean + delta / jnp.maximum(c_new, 1.0)
                m2 = m2 + delta * (z - mean)
            return (key, z, lnp, g, log_eps, log_eps_bar, h_bar, (c_new, mean, m2)), None

        welford0 = (jnp.zeros(()), jnp.zeros_like(x0), jnp.zeros_like(x0))
        init = (key, z, lnp, g, log_eps0, log_eps0, jnp.zeros(n_chains), welford0)
        (key, z, lnp, g, log_eps, log_eps_bar, _, welford), _ = jax.lax.scan(
            step, init, jnp.arange(length, dtype=x0.dtype)
        )
        count, mean, m2 = welford
        # Stan-style regularized variance (pooled across chains)
        var = m2.mean(axis=0) / jnp.maximum(count - 1.0, 1.0)
        var = jnp.where(
            count > 1.0,
            var * (count / (count + 5.0)) + 1e-3 * (5.0 / (count + 5.0)),
            jnp.ones(dim, dtype=x0.dtype),
        )
        return key, z, lnp, g, log_eps_bar, jnp.broadcast_to(var, (n_chains, dim))

    z, lnp, g = x0, lnp0, g0
    log_eps = jnp.full((n_chains,), jnp.log(0.1), dtype=x0.dtype)
    if inv_mass0 is None:
        inv_mass = jnp.ones_like(x0)
    else:
        inv_mass = jnp.broadcast_to(jnp.asarray(inv_mass0, dtype=x0.dtype), x0.shape)
    # phase lengths: 15% eps-only, three doubling mass windows, 10% final
    n1 = max(n_warmup * 15 // 100, 5)
    n_final = max(n_warmup * 10 // 100, 5)
    body = n_warmup - n1 - n_final
    wins = [max(body * 1 // 7, 5), max(body * 2 // 7, 5), max(body * 4 // 7, 5)]
    key, z, lnp, g, log_eps, _ = warm_phase(key, z, lnp, g, log_eps, inv_mass, n1, collect=False)
    for w_len in wins:
        key, z, lnp, g, log_eps, new_mass = warm_phase(
            key, z, lnp, g, log_eps, inv_mass, w_len, collect=True
        )
        inv_mass = new_mass
    key, z, lnp, g, log_eps, _ = warm_phase(key, z, lnp, g, log_eps, inv_mass, n_final, collect=False)
    eps = jnp.exp(log_eps)

    # --- sampling ---
    def sample_step(carry, _):
        key, z, lnp, g, acc_sum, div_sum = carry
        key, k = jax.random.split(key)
        keys = jax.random.split(k, n_chains)
        eps_t = eps
        if eps_jitter > 1.0:
            # per-transition log-uniform step-size jitter in
            # [eps/jitter, eps*jitter] (Neal 2011 §3.2): a single adapted
            # step size cannot match both the posterior bulk and a
            # boundary-compressed logit tail whose local scale differs;
            # jitter lets a fraction of transitions take the small steps
            # the stretched tail needs. Applied to SAMPLING transitions
            # only so dual averaging still adapts the unjittered center.
            key, k_j = jax.random.split(key)
            u = jax.random.uniform(k_j, (n_chains,), dtype=x0.dtype, minval=-1.0, maxval=1.0)
            eps_t = eps * eps_jitter ** u
        z, lnp, g, alpha, div = kernel_v(keys, z, lnp, g, eps_t, inv_mass)
        return (key, z, lnp, g, acc_sum + alpha, div_sum + div), (z, lnp)

    (key, z, lnp, g, acc_sum, div_sum), (chain, lnp_chain) = jax.lax.scan(
        sample_step, (key, z, lnp, g, jnp.zeros(n_chains), jnp.zeros(n_chains, jnp.int32)),
        None, length=n_samples,
    )
    return chain, lnp_chain, eps, inv_mass, acc_sum / n_samples, div_sum


def run_nuts(
    logp_batch: Callable,
    x0,
    key,
    n_warmup: int = 500,
    n_samples: int = 500,
    max_depth: int = 8,
    target_accept: float = 0.8,
    inv_mass0=None,
    ensemble_init: int = 0,
    n_chains: int = None,
    bounds=None,
    mesh=None,
    eps_jitter: float = 1.0,
) -> NutsResult:
    """Multi-chain NUTS.

    logp_batch : jittable, differentiable (B, dim) -> (B,) log-density
    x0 : (n_chains, dim) initial positions — or, with ``ensemble_init``, a
        larger (n_walkers, dim) cloud of independent draws
    inv_mass0 : optional (dim,) initial diagonal inverse mass (posterior
        variances). Strong scale heterogeneity deadlocks warmup adaptation
        (narrow dims gate the step size before wide dims ever move).
    ensemble_init : if > 0, run that many affine-invariant ensemble steps
        over the ``x0`` cloud first (gradient-free, scale-invariant) and
        derive chain starts + ``inv_mass0`` from the burned-in walkers — a
        cheap on-device analog of Pathfinder-style warmup initialization.
    bounds : optional (dim, 2) box bounds. When given, sampling runs in an
        unbounded logit reparametrization (the Stan treatment of bounded
        parameters, with the log-Jacobian added to the target): hard box
        walls (-inf outside) otherwise shed divergences and leave
        boundary-hugging marginals (e.g. A_V near 0) underdispersed.
    mesh : optional ``jax.sharding.Mesh`` — shards the chain axis across
        devices (each chip advances its block of independent chains; only
        the pooled warmup variance crosses the mesh).
    eps_jitter : per-transition log-uniform step-size jitter factor applied
        during sampling (1.0 = off): each transition draws its step size
        from [eps/eps_jitter, eps*eps_jitter] (Neal 2011 §3.2). Optional
        robustness knob when the local posterior scale varies strongly;
        not needed for the star-model fits (the round-4 A_V-tail artifact
        turned out to be a NaN-gradient bug, not a step-size pathology —
        docs/samplers.md, "The NUTS A_V-tail artifact, resolved").
    """
    x0 = jnp.asarray(x0)
    to_z = logjac = None
    if bounds is not None:
        bounds = np.asarray(bounds, dtype=float)
        lo = jnp.asarray(bounds[:, 0], dtype=x0.dtype)
        span = jnp.asarray(bounds[:, 1] - bounds[:, 0], dtype=x0.dtype)

        def to_z(y):
            return lo + span * jax.nn.sigmoid(y)

        def logjac(y):
            return jnp.sum(
                jnp.log(span) + jax.nn.log_sigmoid(y) + jax.nn.log_sigmoid(-y), axis=-1
            )

        logp_bounded_src = logp_batch

        def logp_batch(yb):  # noqa: F811 — deliberate shadowing
            return logp_bounded_src(to_z(yb)) + logjac(yb)

        p = jnp.clip((x0 - lo) / span, 1e-9, 1.0 - 1e-9)
        x0 = jnp.log(p) - jnp.log1p(-p)
        if inv_mass0 is not None:
            # caller-supplied inv_mass0 is documented as PARAMETER-space
            # posterior variances; sampling runs in logit coordinates, so
            # rescale by the transform derivative dz/dy = span*s*(1-s) at
            # the chain-start centroid (a boundary-hugging parameter's
            # logit-space scale differs by orders of magnitude)
            y_bar = jnp.mean(x0, axis=0)
            dz_dy = span * jax.nn.sigmoid(y_bar) * jax.nn.sigmoid(-y_bar)
            inv_mass0 = jnp.asarray(inv_mass0, dtype=x0.dtype) / (dz_dy * dz_dy)
    W = None  # dense-metric whitening transform (z = mu + W y)
    mu = None
    if ensemble_init and inv_mass0 is None:
        from .ensemble import run_ensemble

        n_walkers = x0.shape[0] - (x0.shape[0] % 2)
        n_chains = n_chains or min(8, n_walkers)
        key, k_run = jax.random.split(key)
        _, _, state = run_ensemble(logp_batch, x0[:n_walkers], k_run, n_steps=int(ensemble_init))
        cloud = state.walkers
        # DENSE metric from the burned-in cloud: sample in whitened
        # coordinates y with z = mu + W y, W = chol(cov(cloud)). A diagonal
        # mass matrix cannot precondition correlated ridges (e.g. the
        # EEP-age degeneracy at rho ~ 0.99 leaves a condition number of
        # hundreds and underdispersed tails); whitening by the cloud
        # covariance is a constant affine reparametrization — exactly a
        # dense Stan metric — and the diagonal adaptation inside then only
        # has to fix residual errors. Chains start at the highest-
        # probability walkers (concentrates on the dominant mode).
        #
        # ROBUST estimation (round-4 diagnosis): after a finite burn from
        # prior-wide starts the cloud still carries stuck walkers — logit-
        # saturated points at |y| ~ 20 and rejection-stranded points at
        # catastrophically low lnp (measured: min -61049 vs median -36 on
        # the parity fixture) — which overestimate the posterior scale by
        # 1e2-1e4 per axis. Whitening by that inflated covariance makes
        # the whitened posterior needle-thin: gradients are huge, an
        # eps ~ 0.3 trajectory diverges outright (measured alpha = 0), and
        # in f32 the adapted step collapses to the rounding edge where
        # POSITION updates quantize to zero while momentum updates don't —
        # a false dual-averaging equilibrium at eps ~ 3e-7 (alpha ~ 0.89)
        # that freezes every chain and silently returns the init cloud.
        # Estimate (mu, cov) from the POSTERIOR-BULK walkers instead: the
        # typical set sits within O(dim) of the best lnp, so keep walkers
        # with lnp >= max - max(2*dim, 10). Host-side numpy f64: runs
        # once, variable row count.
        dim = x0.shape[-1]
        cloud_np = np.asarray(cloud, dtype=np.float64)
        lnp_np = np.asarray(state.ln_prob, dtype=np.float64)
        finite = np.isfinite(lnp_np)
        bulk = finite & (lnp_np >= lnp_np[finite].max() - max(2.0 * dim, 10.0))
        if bulk.sum() > dim + 2:
            cloud_np = cloud_np[bulk]
        mu_np = cloud_np.mean(axis=0)
        c_np = cloud_np - mu_np
        cov_np = (c_np.T @ c_np) / cloud_np.shape[0]
        cov_np += (1e-10 * np.trace(cov_np) / dim + 1e-30) * np.eye(dim)
        mu = jnp.asarray(mu_np, dtype=x0.dtype)
        W = jnp.asarray(np.linalg.cholesky(cov_np), dtype=x0.dtype)
        order = jnp.argsort(-state.ln_prob)
        x0 = cloud[order[:n_chains]]

    if W is not None:
        from jax.scipy.linalg import solve_triangular

        logp_z = logp_batch

        def logp_batch_y(y):
            return logp_z(mu[None, :] + jnp.matmul(y, W.T, precision=jax.lax.Precision.HIGHEST))

        x0_run = solve_triangular(W, (x0 - mu[None, :]).T, lower=True).T
        logp_run = logp_batch_y
        inv_mass_run = jnp.ones(x0.shape[-1], dtype=x0.dtype)
    else:
        x0_run = x0
        logp_run = logp_batch
        inv_mass_run = inv_mass0

    chain, lnp_chain, eps, inv_mass, acc, ndiv = _nuts_run(
        logp_run, x0_run, key, x0.shape[-1], int(n_warmup), int(n_samples),
        int(max_depth), float(target_accept), inv_mass0=inv_mass_run,
        mesh=mesh, eps_jitter=float(eps_jitter),
    )
    # frozen-sampler guard: if dual averaging drove the step size down to
    # the floating-point resolution of the (O(1)-scaled) run coordinates,
    # position updates round to zero and the "chains" are the init points —
    # the failure mode a badly-scaled metric produces in f32. Warn loudly;
    # quantiles from such a run are meaningless.
    eps_floor = 100.0 * float(jnp.finfo(x0_run.dtype).eps)
    n_frozen = int(np.sum(np.asarray(eps) < eps_floor))
    if n_frozen:
        from ..logger import getLogger

        getLogger().warning(
            "NUTS: %d/%d chains adapted a step size below the %s resolution "
            "floor (%.1e) — those chains are frozen (positions cannot move) "
            "and their samples are init-cloud points, not posterior draws. "
            "Check the metric scaling / parameter bounds.",
            n_frozen, eps.shape[0], str(x0_run.dtype), eps_floor,
        )

    if W is not None:
        chain = mu[None, None, :] + jnp.einsum("scd,ed->sce", chain, W, precision=jax.lax.Precision.HIGHEST)
    if to_z is not None:
        # back to parameter space; report lnp WITHOUT the logit Jacobian
        lnp_chain = lnp_chain - logjac(chain)
        chain = to_z(chain)
    return NutsResult(
        samples=np.asarray(chain),
        lnp=np.asarray(lnp_chain),
        step_size=np.asarray(eps),
        inv_mass=np.asarray(inv_mass),
        accept_rate=np.asarray(acc),
        n_divergent=np.asarray(ndiv),
    )
