"""On-device nested sampling.

Replaces the reference's external Fortran MultiNest/PolyChord dependency
(``isochrones/starmodel.py:717-819``: ``pymultinest.run`` with uniform
unit-cube prior transform and lnpost as the NS likelihood). Same convention
here: the sampler explores the unit cube, maps through a ``prior_transform``
(bounds box, starmodel.py:1637-1640), and treats the model lnpost as the NS
log-likelihood — so evidences and equal-weight posteriors are directly
comparable to the reference's MultiNest outputs.

Algorithm: classic single-removal nested sampling driven by one ``lax.scan``:
each shrinkage replaces the worst live point with a constrained random walk
(L > L*) started from a random survivor. The walk runs ``n_chains`` chains in
parallel (vectorized likelihood fan-out — the role MPI plays for MultiNest,
SURVEY §2.8) and picks one accepted result at random; the step scale adapts
toward a target acceptance rate. Everything — shrinkage, walks, dead-point
storage — stays on device; weights/evidence are assembled on host afterward.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["CheckpointConfigError", "NestedResult", "run_nested", "run_nested_vmapped"]


class NestedResult(NamedTuple):
    samples: np.ndarray  # (n_dead + n_live, n_params) in PARAMETER space
    logl: np.ndarray  # (n_dead + n_live,)
    logwt: np.ndarray  # (n_dead + n_live,) unnormalized ln(prior mass * L)
    logz: float
    logzerr: float
    h: float  # information
    n_iter: int
    posterior: np.ndarray  # equal-weight posterior samples (n_eq, n_params)
    logl_posterior: np.ndarray  # lnpost values for the equal-weight samples
    ess: float = np.nan  # effective sample size of the posterior weights
    truncated: bool = False  # ESS still below min_ess when the budget ran out
    logz_runs: np.ndarray = None  # per-run ln Z when n_runs > 1 (else None)
    dynamic_rounds: int = 0  # posterior-bulk thread rounds run (dynamic=True)


def _ln_x_schedule(n_dead: int, n_live: int, n_batch: int = 1) -> np.ndarray:
    """E[ln X_i] for each dead point under batched-K removal.

    Removing the K worst points at once and refilling above the K-th
    smallest is statistically identical to K sequential deletions with NO
    refill in between — the live set shrinks n, n-1, …, n-K+1 within the
    batch, so the j-th removal (0-based, ascending lnL) shrinks the prior
    mass by E[ln t] = -1/(n_live - j), not -1/n_live. The naive constant
    -i/n schedule under-shrinks by ~K²/2n² per batch, which compounds to an
    O(+0.5 nat) evidence bias at K=64, n=1000. This is the same varying-live-count weight
    assignment dynamic nested sampling uses (Higson et al. 2019)."""
    return -np.cumsum(_ln_x_increments(np.arange(n_dead), n_live, n_batch))


def _ln_x_increments(idx, n_live: int, n_batch: int = 1):
    """Per-removal |E[d ln X]| for dead-point indices ``idx`` (0-based,
    ascending-lnL within each K-batch): 1/(n_live - j) at in-batch position
    j. The single shared implementation of the schedule — used by both the
    final assembly (:func:`_ln_x_schedule`) and the incremental
    :class:`_RunningEvidence` accumulator."""
    return 1.0 / (n_live - (np.asarray(idx) % n_batch))


def _logzerr_scale(n_live: int, n_batch: int = 1) -> float:
    """Effective 1/n for the classic ``logzerr = sqrt(H / n)`` estimate
    under batched-K removal. Each removal at live count n_j contributes
    shrinkage variance 1/n_j^2 against mean 1/n_j, so the constant-n 1/n
    generalizes to <1/n_j^2> / <1/n_j> over the in-batch positions — equal
    to 1/n_live at K=1 and ~(1 + K/2n)/n_live otherwise (the constant
    formula underestimates the error by ~K/2n relative)."""
    j = np.arange(n_batch, dtype=float)
    inv = 1.0 / (n_live - j)
    return float(np.sum(inv ** 2) / np.sum(inv))


def _assemble_weights(dead_lnl: np.ndarray, live_lnl: np.ndarray, n_live: int, n_batch: int = 1):
    """Skilling (2006) prior-mass weights for dead + final live points.

    Returns ``(order, all_lnl, all_logwt, logz, probs, ess)`` where ``order``
    sorts the live points by lnL (their storage order in the output arrays).
    """
    n_dead = len(dead_lnl)
    ln_x = _ln_x_schedule(n_dead, n_live, n_batch)  # E[ln X_i]
    ln_x_prev = np.concatenate([[0.0], ln_x[:-1]])
    w = np.exp(ln_x_prev) - np.exp(ln_x)  # trapezoid prior-mass weights
    logwt_dead = np.log(np.maximum(w, 1e-300)) + dead_lnl

    order = np.argsort(live_lnl)
    x_final = np.exp(ln_x[-1]) if n_dead else 1.0
    logwt_live = np.log(x_final / n_live) + live_lnl[order]

    all_lnl = np.concatenate([dead_lnl, live_lnl[order]])
    all_logwt = np.concatenate([logwt_dead, logwt_live])
    logz, probs, ess = _evidence_from_logwt(all_logwt)
    return order, all_lnl, all_logwt, logz, probs, ess


def _evidence_from_logwt(all_logwt):
    """(logz, normalized posterior probs, ESS) from unnormalized ln-weights —
    the one shared evidence tail of :func:`_assemble_weights` and
    :func:`_merge_segments`."""
    finite = np.isfinite(all_logwt)
    lw = all_logwt[finite]
    lmax = lw.max() if len(lw) else 0.0
    logz = float(lmax + np.log(np.exp(lw - lmax).sum())) if len(lw) else -np.inf
    probs = np.zeros(len(all_logwt))
    probs[finite] = np.exp(lw - logz)
    psum = probs.sum()
    if psum > 0:
        probs = probs / psum
    ess = float(1.0 / np.sum(probs ** 2)) if psum > 0 else 0.0
    return logz, probs, ess


def _merge_segments(segments):
    """Varying-live-count weight assembly for a base run merged with
    posterior-focused thread runs — dynamic nested sampling (Higson et al.
    2019; the machinery behind dynesty's ``merge_runs``), generalized to this
    engine's batched-K removal.

    Statistical picture: every segment's live points are uniform draws in the
    prior constrained above that segment's activation threshold ``L0``, so at
    any likelihood level the union of alive points across segments is uniform
    in the common constrained prior. Processing all deaths in ascending-lnL
    order, each death shrinks the prior mass by ``E[ln t] = -1/n_alive``
    where ``n_alive`` counts alive points from every active segment — the
    single-segment case reproduces :func:`_ln_x_increments` exactly (batched-K
    removal decrements within a batch and refills K at the batch boundary).
    Final live points are consumed as decrementing deaths (the standard
    varying-n treatment).

    segments : list of dicts with keys ``dead_lnl`` (ascending), ``live_lnl``,
        ``all_u`` (dead_u + live_u[argsort(live_lnl)] stacked), ``n_live``,
        ``n_batch``, ``L0`` (activation threshold; -inf for the base run).

    Returns ``(all_u, all_lnl, all_logwt, logz, probs, ess, h, logzerr)``
    with rows in ascending-lnL merged order.
    """
    lnls, prios, seg_ids, kinds, refills, srcs = [], [], [], [], [], []
    for s, seg in enumerate(segments):
        dead = np.asarray(seg["dead_lnl"], dtype=float)
        m = len(dead)
        K = max(1, int(seg.get("n_batch", 1)))
        j = np.arange(m)
        # deaths (kind 1): refill K live points at each batch boundary
        lnls.append(dead)
        prios.append(np.ones(m))
        seg_ids.append(np.full(m, s))
        kinds.append(np.ones(m))
        refills.append(np.where(j % K == K - 1, K, 0))
        srcs.append(j)
        # final live points (kind 2), ascending
        live = np.asarray(seg["live_lnl"], dtype=float)
        lo = np.argsort(live)
        n = len(live)
        lnls.append(live[lo])
        prios.append(np.full(n, 2.0))
        seg_ids.append(np.full(n, s))
        kinds.append(np.full(n, 2))
        refills.append(np.zeros(n))
        srcs.append(m + np.arange(n))
        # activation (kind 0): n_live points come alive above L0. prio 0 —
        # FIRST at its lnl: the base activation at -inf must precede any
        # -inf death (else a divide-by-zero on pathological likelihoods the
        # static path handles), and a thread's own events tied exactly at
        # L0 must see their segment's points alive. The cost is the
        # measure-zero boundary case of a base death tied exactly at L0
        # counting the thread's points — a 1/(n+m)-vs-1/n difference on one
        # event.
        lnls.append(np.array([seg["L0"]]))
        prios.append(np.array([0.0]))
        seg_ids.append(np.array([s]))
        kinds.append(np.array([0.0]))
        refills.append(np.array([seg["n_live"]]))
        srcs.append(np.array([-1]))

    lnl = np.concatenate(lnls)
    prio = np.concatenate(prios)
    seg_id = np.concatenate(seg_ids).astype(int)
    kind = np.concatenate(kinds).astype(int)
    refill = np.concatenate(refills).astype(int)
    src = np.concatenate(srcs).astype(int)
    order = np.lexsort((prio, lnl))  # ascending lnl; activation < death < live

    # vectorized alive-count accounting: per-event alive delta, prefix-summed
    lnl_s = lnl[order]
    kind_s = kind[order]
    refill_s = refill[order]
    delta = np.where(kind_s == 0, refill_s, refill_s - 1)  # live: refill 0 -> -1
    alive_after = np.cumsum(delta)
    alive_before = alive_after - delta
    is_sample = kind_s != 0
    n_at = alive_before[is_sample].astype(float)
    if not len(n_at) or n_at.min() < 1:
        raise ValueError("merge saw a death/live event with no alive points")
    ln_x = -np.cumsum(1.0 / n_at)
    ln_x_prev = np.concatenate([[0.0], ln_x[:-1]])
    w = np.exp(ln_x_prev) - np.exp(ln_x)
    with np.errstate(invalid="ignore"):
        all_logwt = np.log(np.maximum(w, 1e-300)) + lnl_s[is_sample]
    all_logwt = np.where(np.isfinite(all_logwt), all_logwt, -np.inf)
    all_lnl = lnl_s[is_sample]

    rows = order[is_sample]
    all_u = np.empty((len(rows), segments[0]["all_u"].shape[-1]))
    for s, seg in enumerate(segments):
        m = seg_id[rows] == s
        all_u[m] = seg["all_u"][src[rows[m]]]

    logz, probs, ess = _evidence_from_logwt(all_logwt)
    # information + error: the constant-n sqrt(H/n) generalizes to
    # sqrt(sum_i p_i (lnL_i - ln Z) / n_i) under varying live counts
    with np.errstate(invalid="ignore"):
        h_terms = probs * (all_lnl - logz)
    h = float(np.nansum(h_terms))
    logzerr = float(np.sqrt(max(np.nansum(h_terms / n_at), 0.0)))
    return all_u, all_lnl, all_logwt, logz, probs, ess, h, logzerr


class _RunningEvidence:
    """Incremental dead-point evidence/ESS accumulator for termination
    checks. Skilling weights are index-deterministic, so each chunk folds
    in O(chunk) — re-running the full weight assembly every chunk was
    O(n_dead^2) host work. ``logz_dead`` here is DEAD-ONLY: the dlogz test
    must compare the live upper bound against the dead evidence; using the
    live-inclusive total double-counts the live mass and loosens the
    stopping rule by up to 2x. Supports a leading batch shape (runs/stars)
    with the chunk on the trailing axis.
    """

    def __init__(self, n_live, shape=(), n_batch=1):
        self.n_live = n_live
        self.n_batch = max(1, int(n_batch))
        self.n_dead = 0
        self.ln_x = 0.0  # cumulative E[ln X] after n_dead removals
        self.log_s1 = np.full(shape, -np.inf)  # logsumexp of dead logwt
        self.log_s2 = np.full(shape, -np.inf)  # logsumexp of 2*dead logwt

    @staticmethod
    def _lse(a):
        m = np.max(a, axis=-1)
        m_safe = np.where(np.isfinite(m), m, 0.0)
        out = m_safe + np.log(np.sum(np.exp(a - m_safe[..., None]), axis=-1))
        return np.where(np.isfinite(m), out, -np.inf)

    def add(self, dead_lnl_chunk):
        """Fold in a chunk of dead points (ordered; trailing axis). Chunks
        must contain whole K-batches (each scan step emits K dead points, so
        every chunk is ``n_steps * K`` long — the ``i % K`` schedule phase
        stays aligned across chunks)."""
        k = dead_lnl_chunk.shape[-1]
        idx = np.arange(self.n_dead, self.n_dead + k)
        increments = _ln_x_increments(idx, self.n_live, self.n_batch)
        ln_x = self.ln_x - np.cumsum(increments)
        ln_x_prev = np.concatenate([[self.ln_x], ln_x[:-1]])
        w = np.exp(ln_x_prev) - np.exp(ln_x)
        logwt = np.log(np.maximum(w, 1e-300)) + dead_lnl_chunk
        logwt = np.where(np.isfinite(logwt), logwt, -np.inf)
        self.log_s1 = np.logaddexp(self.log_s1, self._lse(logwt))
        self.log_s2 = np.logaddexp(self.log_s2, self._lse(2.0 * logwt))
        self.n_dead += k
        self.ln_x = float(ln_x[-1])

    def status(self, live_lnl):
        """(dead-only logz, posterior ESS incl. live points) — identical to
        what the full ``_assemble_weights`` pass reports, in O(n_live)."""
        x_final = np.exp(self.ln_x)
        logwt_live = np.log(x_final / self.n_live) + live_lnl
        logwt_live = np.where(np.isfinite(logwt_live), logwt_live, -np.inf)
        l1 = self._lse(logwt_live)
        l2 = self._lse(2.0 * logwt_live)
        s1 = np.logaddexp(self.log_s1, l1)
        s2 = np.logaddexp(self.log_s2, l2)
        with np.errstate(invalid="ignore"):
            ess = np.where(np.isfinite(s1), np.exp(2.0 * s1 - s2), 0.0)
        return self.log_s1, ess


# v2: config carries config_tag (problem hash) and chunk (dead points per
# compiled chunk, env-dependent via ISOTPU_NS_CHUNK_MULT) — both affect
# resume semantics, so v1 checkpoints refuse with a version message
# instead of a misleading config-mismatch (self-review r5)
_CKPT_VERSION = 2


class CheckpointConfigError(ValueError):
    """A resume checkpoint was written under a different sampler config or
    for a different problem (data/bounds/seed hash mismatch). Operator
    error, not a transient fit failure — drivers re-raise it instead of
    swallowing it into per-folder logs (ADVICE r4)."""


def _ckpt_save(path, state):
    """Atomically persist a checkpoint (pickle to tmp + rename, so a kill
    mid-write can never leave a torn file — the previous checkpoint survives).
    The payload is plain numpy arrays + ints + the numpy bit-generator state."""
    import os
    import pickle

    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        pickle.dump(state, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)


def _ckpt_load(path, config):
    """Load + validate a checkpoint written by :func:`_ckpt_save`. The stored
    sampler configuration must match ``config`` exactly — resuming under a
    different n_live/n_batch/... would silently corrupt the shrinkage
    schedule, so mismatches raise."""
    import pickle

    with open(path, "rb") as f:
        state = pickle.load(f)
    if state.get("config", {}).get("version") != _CKPT_VERSION:
        raise CheckpointConfigError(
            f"nested-sampling checkpoint {path!r} has version "
            f"{state.get('config', {}).get('version')!r}, expected {_CKPT_VERSION}"
        )
    if state["config"] != config:
        raise CheckpointConfigError(
            f"nested-sampling checkpoint {path!r} was written with a different "
            f"sampler configuration:\n  stored:   {state['config']}\n"
            f"  expected: {config}\nRefusing to resume."
        )
    return state


def _chunk_dead(n_live):
    """Dead points accumulated per compiled chunk. Each chunk boundary pays
    host<->device synchronization plus host bookkeeping. The only cost of a
    larger chunk is termination-granularity overshoot — at most one chunk
    of extra dead points past the dlogz criterion. ISOTPU_NS_CHUNK_MULT
    scales it (default 1)."""
    import os

    mult = float(os.environ.get("ISOTPU_NS_CHUNK_MULT", "1"))
    return max(int(max(n_live, 256) * mult), 256)


def _mesh_wrap_lnlike(lnlike_u, mesh):
    """Shard an NS likelihood fan-out's batch axis over ``mesh``'s first axis
    — the role MPI rank-parallel likelihood evaluation plays for MultiNest
    (reference starmodel.py:755-797). The likelihood is elementwise over the
    batch, so the sharded program computes identical per-point values; XLA
    inserts the (tiny) all-gather of the (B,) result. Non-divisible
    batch sizes are fine: GSPMD pads internally. (Thin alias of the shared
    :func:`isochrones_tpu.parallel.mesh_wrap_fn` — one tracer-guard /
    constraint implementation for every engine.)"""
    from ..parallel import mesh_wrap_fn

    return mesh_wrap_fn(lnlike_u, mesh)


def _mesh_constrain_leading(tree, mesh):
    """Alias of :func:`isochrones_tpu.parallel.mesh_constrain_leading`."""
    from ..parallel import mesh_constrain_leading

    return mesh_constrain_leading(tree, mesh)


def _thread_starts(merged, posterior_frac, n_live):
    """Activation threshold + start snapshot for one dynamic-NS thread
    round: ``(L_lo, starts_u, starts_lnl)`` — the ``n_live`` merged samples
    just above the likelihood level enclosing ``1 - posterior_frac`` of the
    current posterior mass (shared by the single-problem and problem-family
    dynamic paths)."""
    all_u_m, all_lnl_m, _, _, probs_m, _, _, _ = merged
    cum = np.cumsum(probs_m)
    i_lo = int(np.searchsorted(cum, posterior_frac))
    i_lo = min(i_lo, max(len(all_lnl_m) - n_live - 1, 0))
    sl = slice(i_lo + 1, i_lo + 1 + n_live)
    return float(all_lnl_m[i_lo]), all_u_m[sl], all_lnl_m[sl]


def _live_cholesky(live_u, jitter=1e-12):
    """Cholesky factor of the live-point covariance (+ jitter) — whitens walk
    proposals so correlated/ridge-shaped constrained regions (e.g. the
    EEP-age degeneracy) mix as fast as isotropic ones. Without this the
    isotropic walk leaves replacements correlated with their start points,
    which biases the shrinkage schedule by O(1) nats on hard targets.
    (Also the slice-NS whitening in :mod:`.polychord`, with a larger jitter.)"""
    mu = jnp.mean(live_u, axis=0)
    c = live_u - mu
    cov = jnp.matmul(c.T, c, precision=jax.lax.Precision.HIGHEST) / live_u.shape[0]
    d = live_u.shape[-1]
    # relative ridge (like the ensemble KDE move's): an absolute 1e-12 is
    # unrepresentable next to O(1e-2) f32 diagonals, so duplicate rows —
    # e.g. dynamic-NS thread starts whose decorrelation stalled — would
    # leave cov singular and the factor NaN, killing every later proposal.
    ridge = jitter + 1e-6 * jnp.maximum(jnp.max(jnp.diagonal(cov)), 0.0)
    cov = cov + ridge * jnp.eye(d, dtype=live_u.dtype)
    return jnp.linalg.cholesky(cov)


def _constrained_walk(lnlike_u, key, start, lnl_start, lnl_star, scale, n_groups, n_chains, n_repeat, L=None):
    """Random-walk exploration of {u : lnlike(u) > lnl_star} in the unit cube.

    Runs ``n_groups * n_chains`` chains (one likelihood batch); per group,
    returns one accepted sample (random among that group's moved chains)
    plus the overall acceptance rate. start: (n_groups * n_chains, dim).
    ``L``: optional covariance Cholesky factor — proposals are ``L @ n``
    (whitened) instead of isotropic.
    """

    def step(carry, _):
        key, x, lnl, n_acc = carry
        key, k_prop, k_acc = jax.random.split(key, 3)
        eps = jax.random.normal(k_prop, x.shape, dtype=x.dtype)
        if L is not None:
            eps = jnp.matmul(eps, L.T, precision=jax.lax.Precision.HIGHEST)
        eps = eps * scale
        prop = x + eps
        # reflect at the cube boundary: full triangle-wave fold maps ALL of
        # R into [0, 1] (abs-then-mirror alone fails beyond |prop| > 2,
        # letting large whitened steps escape the cube when the likelihood
        # happens to be finite outside it)
        prop = jnp.abs(prop) % 2.0
        prop = 1.0 - jnp.abs(1.0 - prop)
        lnl_prop = lnlike_u(prop)
        lnl_prop = jnp.where(jnp.isnan(lnl_prop), -jnp.inf, lnl_prop)
        ok = lnl_prop > lnl_star
        x = jnp.where(ok[:, None], prop, x)
        lnl = jnp.where(ok, lnl_prop, lnl)
        return (key, x, lnl, n_acc + ok.astype(jnp.int32)), None

    total = n_groups * n_chains
    (key, xf, lnlf, n_acc), _ = jax.lax.scan(
        step, (key, start, lnl_start, jnp.zeros(total, dtype=jnp.int32)), None, length=n_repeat
    )
    moved = (n_acc > 0).reshape(n_groups, n_chains)
    # random pick among each group's moved chains (fallback: a start point,
    # which is a survivor)
    key, k_pick = jax.random.split(key)
    scores = jax.random.uniform(k_pick, (n_groups, n_chains)) + moved.astype(xf.dtype)
    pick = jnp.argmax(scores, axis=1)  # (n_groups,)
    xf = xf.reshape(n_groups, n_chains, -1)
    lnlf = lnlf.reshape(n_groups, n_chains)
    rows = jnp.arange(n_groups)
    accept_rate = jnp.sum(n_acc) / (total * n_repeat)
    return xf[rows, pick], lnlf[rows, pick], moved[rows, pick], accept_rate


@partial(jax.jit, static_argnames=("lnlike_u", "n_groups", "n_chains", "n_repeat"))
def _decorrelate_walk(lnlike_u, key, start, lnl_start, lnl_star, scale, n_groups, n_chains, n_repeat, L):
    """Standalone jitted constrained walk — decorrelates dynamic-NS thread
    starts (copies of existing samples) from their sources so thread deaths
    are fresh likelihood draws, not double-counted points."""
    return _constrained_walk(
        lnlike_u, key, start, lnl_start, lnl_star, scale, n_groups, n_chains, n_repeat, L=L
    )


@partial(jax.jit, static_argnames=("lnlike_u", "n_live", "n_iter", "n_chains", "n_repeat", "n_batch"))
def _nested_core(lnlike_u, u0, lnl0, key, scale0, n_live, n_iter, n_chains, n_repeat, n_batch=1):
    """``n_iter`` scan steps, each removing the ``n_batch`` worst live points
    and replacing them with constrained-walk draws above the highest removed
    likelihood (n_batch=1 is classic NS; larger batches give a
    ``n_batch``-times fatter likelihood batch per device dispatch at
    unchanged evidence — the host assembly assigns the exact harmonic
    batched-K shrinkage, :func:`_ln_x_schedule`). Dead points are emitted
    ascending-lnL within each batch; the schedule depends on that order."""
    K = n_batch

    def one_iter(carry, _):
        key, live_u, live_lnl, scale = carry
        neg_vals, worst_idx = jax.lax.top_k(-live_lnl, K)  # K smallest lnl, ascending
        dead_lnl = -neg_vals  # (K,) ascending
        dead_u = live_u[worst_idx]
        lnl_star = dead_lnl[-1]  # largest removed: the batch threshold

        key, k_start, k_walk = jax.random.split(key, 3)
        # seed walks from survivors only: positions K.. of the sorted order
        order = jnp.argsort(live_lnl)
        pick = jax.random.randint(k_start, (K * n_chains,), K, n_live)
        starts = order[pick]
        x0 = live_u[starts]
        l0 = live_lnl[starts]
        L = _live_cholesky(live_u)
        new_u, new_lnl, moved, acc = _constrained_walk(
            lnlike_u, k_walk, x0, l0, lnl_star, scale, K, n_chains, n_repeat, L=L
        )
        live_u = live_u.at[worst_idx].set(new_u)
        live_lnl = live_lnl.at[worst_idx].set(new_lnl)
        # adapt scale toward ~35% acceptance (dimensionless: proposals are
        # whitened by the live covariance, so O(1) scales are ideal)
        scale = jnp.clip(scale * jnp.exp(0.7 * (acc - 0.35)), 1e-4, 4.0)
        return (key, live_u, live_lnl, scale), (dead_u, dead_lnl)

    (key, live_u, live_lnl, scale), (dead_u, dead_lnl) = jax.lax.scan(
        one_iter, (key, u0, lnl0, scale0), None, length=n_iter
    )
    # (n_iter, K, ...) -> (n_iter * K, ...), preserving ascending-lnl order
    # within each batch — LOAD-BEARING: the harmonic schedule assigns the
    # j-th in-batch point (0-based, worst first) a shrinkage of
    # 1/(n_live - j) (_ln_x_increments); unordered batches mis-weight the
    # evidence. Any custom ``core=`` must emit the same ordering.
    dead_u = dead_u.reshape(-1, dead_u.shape[-1])
    dead_lnl = dead_lnl.reshape(-1)
    return dead_u, dead_lnl, live_u, live_lnl, key, scale


def run_nested(
    lnpost_u: Callable,
    prior_transform: Callable,
    n_params: int,
    key,
    n_live: int = 500,
    max_iter: int = None,
    n_chains: int = 8,
    n_repeat: int = 24,
    n_equal: int = 4000,
    dlogz: float = 0.01,
    n_batch: int = 1,
    rng=None,
    min_ess: float = 100.0,
    on_low_ess: str = "extend",
    core: Callable = None,
    n_runs: int = 1,
    mesh=None,
    dynamic: bool = False,
    posterior_frac: float = 0.025,
    max_dynamic_rounds: int = 8,
    checkpoint: str = None,
    resume: bool = False,
    config_tag: str = None,
) -> NestedResult:
    """Nested-sampling fit.

    lnpost_u : vmapped fn (n, n_params)->(n,) over PARAMETER-space points
    prior_transform : (..., n_params) unit cube -> parameter space (vectorized)
    dlogz : evidence-based termination — stop when the remaining live-point
        contribution to the evidence drops below this fraction (the MultiNest
        ``evidence_tolerance`` role). ``max_iter`` is a hard cap on top.
    n_batch : live points replaced per step (1 = classic NS). Larger batches
        keep an accelerator busy: the per-dispatch likelihood batch grows
        ``n_batch``-fold, and the evidence stays unbiased at any K because
        the weight assembly uses the exact harmonic batched-K shrinkage
        schedule (:func:`_ln_x_schedule`; clamped to n_live // 4).
    min_ess : termination additionally requires the posterior effective
        sample size to reach this value — a truncated run cannot silently
        return quantile-unreliable samples.
    on_low_ess : what to do if the iteration budget (``max_iter``) runs out
        with ESS < min_ess: "extend"/"warn" -> warn loudly and return with
        ``result.truncated = True``; "raise" -> RuntimeError. (With the
        default ``max_iter=None`` budget, extension keeps shrinking until
        the ESS criterion is met.)
    core : replacement-kernel override with the signature of
        :func:`_nested_core` (same carry/return contract). Used by
        :mod:`isochrones_tpu.samplers.polychord` to drive the chunked
        shrinkage/termination machinery with slice-sampling replacement —
        an independent constrained sampler for NS-vs-NS cross-checks.
    n_runs : > 1 runs this many INDEPENDENT nested-sampling runs vmapped in
        lockstep on the device (embarrassingly parallel live sets — one XLA
        program advances all runs). Evidence combines as ln(mean Z_r);
        ``logzerr`` is taken from the *empirical* run-to-run scatter, which —
        unlike the single-run sqrt(H/n_live) estimate — also captures the
        extra variance from finitely-correlated MCMC replacement chains.
        The posterior concatenates Z-weighted equal-weight draws from every
        run. Per-run evidences are returned in ``result.logz_runs``.
    dynamic : dynamic nested sampling (Higson et al. 2019). When the base
        run reaches the ``dlogz`` evidence criterion with posterior ESS still
        below ``min_ess``, instead of continuing terminal shrinkage (ever
        harder thresholds, far from the posterior bulk), spawn
        posterior-focused THREADS: fresh ``n_live``-point NS runs activated at
        the likelihood level enclosing ``1 - posterior_frac`` of the posterior
        mass. Threads reuse the already-compiled core at identical shapes —
        the one extra program is the small decorrelation walk, compiled once
        on the first round — and merge with the base run through the exact
        varying-live-count schedule (:func:`_merge_segments`), so the
        evidence stays unbiased while posterior ESS per likelihood call
        improves severalfold. ``dynamic=False`` (default) preserves the
        static auto-extend behavior exactly.
    posterior_frac : lower cumulative-posterior-mass cut defining each
        thread's activation threshold.
    max_dynamic_rounds : cap on thread rounds (each adds ~n_live-scale ESS).
    checkpoint : optional path — persist the full sampler state there after
        every compiled chunk (and after every dynamic thread round), written
        atomically (tmp + rename). The role MultiNest's ``chains/*`` files
        play for the reference (starmodel.py:779-797): a preempted fit loses
        at most one chunk of work.
    resume : with ``checkpoint`` set, restore from an existing checkpoint
        file and continue — the completed run is BITWISE-identical to one
        that was never interrupted (the state includes the device PRNG key,
        adapted walk scale, running-evidence accumulator, and host RNG
        state; chunk boundaries are deterministic). A missing file starts
        fresh; a checkpoint written under a different sampler configuration
        raises.
    config_tag : optional opaque string folded into the checkpoint config —
        callers hash the PROBLEM (observed data, bounds, seed) into it so a
        checkpoint written for a different problem refuses to resume instead
        of silently replaying a stale posterior (ADVICE r4).
    mesh : optional ``jax.sharding.Mesh`` — shards the NS likelihood fan-out
        across devices (the role MPI plays for MultiNest, reference
        starmodel.py:755-797). With ``n_runs > 1`` the independent runs shard
        over the mesh's first axis (zero-communication SPMD: each chip
        advances its block of runs; results are bitwise-identical to the
        unsharded program for the same seeds). With a single run, the
        constrained-walk chain batch shards instead (elementwise over the
        batch -> identical values, an all-gather of the (B,) lnl per step).
    """
    if n_runs > 1:
        if dynamic:
            raise ValueError(
                "dynamic=True supports n_runs=1 — independent runs already "
                "multiply posterior coverage; combine one or the other"
            )
        return _run_nested_multi(
            lnpost_u, prior_transform, n_params, key, n_live=n_live,
            max_iter=max_iter, n_chains=n_chains, n_repeat=n_repeat,
            n_equal=n_equal, dlogz=dlogz, n_batch=n_batch, rng=rng,
            min_ess=min_ess, on_low_ess=on_low_ess, core=core, n_runs=n_runs,
            mesh=mesh, checkpoint=checkpoint, resume=resume,
            config_tag=config_tag,
        )
    hard_cap = max_iter if max_iter is not None else 1000 * n_live
    n_batch = max(1, min(int(n_batch), n_live // 4))

    ckpt_cfg = state = None
    if checkpoint is not None:
        import os

        ckpt_cfg = dict(
            version=_CKPT_VERSION, kind="single", n_params=int(n_params),
            n_live=int(n_live), n_batch=int(n_batch), n_chains=int(n_chains),
            n_repeat=int(n_repeat), chunk=int(_chunk_dead(n_live)),
            config_tag=None if config_tag is None else str(config_tag),
        )
        if resume and os.path.exists(checkpoint):
            state = _ckpt_load(checkpoint, ckpt_cfg)

    def lnlike_u(u):
        return lnpost_u(prior_transform(u))

    if mesh is not None:
        lnlike_u = _mesh_wrap_lnlike(lnlike_u, mesh)

    rng = np.random.default_rng(rng)

    # Chunked shrinkage with evidence-based termination: each chunk is one
    # compiled lax.scan (shape-stable -> compiled once); between chunks the
    # host checks whether the remaining live-point mass still matters.
    chunk = _chunk_dead(n_live)
    chunk_steps = max(chunk // n_batch, 8)  # scan steps per compiled chunk
    core_fn = _nested_core if core is None else core
    running = _RunningEvidence(n_live, n_batch=n_batch)
    if state is not None:
        # restore the full loop-carried state at a chunk/round boundary —
        # continuing from here is bitwise-identical to never having stopped
        dead_u_chunks = [state["dead_u"]]
        dead_lnl_chunks = [state["dead_lnl"]]
        live_u_j = jnp.asarray(state["live_u"])
        live_lnl_j = jnp.asarray(state["live_lnl"])
        key = jnp.asarray(state["key"])
        scale = jnp.asarray(state["scale"])
        n_dead_total = int(state["n_dead_total"])
        running.n_dead = int(state["running_n_dead"])
        running.ln_x = float(state["running_ln_x"])
        running.log_s1 = state["running_log_s1"]
        running.log_s2 = state["running_log_s2"]
        rng.bit_generator.state = state["rng_state"]
    else:
        key = jax.random.PRNGKey(int(rng.integers(2 ** 31))) if key is None else key

        # initialize live points: uniform draws, resample any -inf starts.
        # Resample rounds always evaluate a FULL (n_live, n_params) batch — a
        # variable-size batch would trigger a fresh XLA compile per unique
        # size.
        u0 = np.array(rng.random((n_live, n_params)))
        lnl0 = np.array(lnlike_u(jnp.asarray(u0)))
        lnl0 = np.where(np.isnan(lnl0), -np.inf, lnl0)
        bad = ~np.isfinite(lnl0)
        tries = 0
        while bad.any() and tries < 200:
            u_new = rng.random((n_live, n_params))
            l_new = np.asarray(lnlike_u(jnp.asarray(u_new)))
            l_new = np.where(np.isnan(l_new), -np.inf, l_new)
            good_new = np.isfinite(l_new)
            n_take = min(int(bad.sum()), int(good_new.sum()))
            if n_take:
                bad_idx = np.where(bad)[0][:n_take]
                good_idx = np.where(good_new)[0][:n_take]
                u0[bad_idx] = u_new[good_idx]
                lnl0[bad_idx] = l_new[good_idx]
            bad = ~np.isfinite(lnl0)
            tries += 1
        live_u_j = jnp.asarray(u0)
        live_lnl_j = jnp.asarray(lnl0)
        scale = jnp.asarray(0.5, dtype=live_u_j.dtype)  # whitened units
        dead_u_chunks, dead_lnl_chunks = [], []
        n_dead_total = 0

    def _terminated():
        # termination: (a) remaining evidence bound below dlogz AND
        # (b) posterior ESS at least min_ess (auto-extend past a technically
        # converged evidence if the weights are still too concentrated).
        # dynamic mode hands low-ESS handling to posterior threads instead
        # of terminal shrinkage — the base run stops on evidence alone
        if running.n_dead == 0:
            return False
        live_lnl_now = np.asarray(live_lnl_j)
        logz_dead, ess_now = running.status(live_lnl_now)
        logz_remain = float(np.max(live_lnl_now)) + running.ln_x
        dlogz_met = np.exp(logz_remain - np.logaddexp(logz_dead, logz_remain)) < dlogz
        return bool(dlogz_met and (dynamic or ess_now >= min_ess))

    def _save(phase, thread_segments=None, dynamic_rounds=0):
        if checkpoint is None:
            return
        _ckpt_save(checkpoint, dict(
            config=ckpt_cfg, phase=phase,
            dead_u=np.concatenate(dead_u_chunks, axis=0),
            dead_lnl=np.concatenate(dead_lnl_chunks),
            live_u=np.asarray(live_u_j), live_lnl=np.asarray(live_lnl_j),
            key=np.asarray(key), scale=np.asarray(scale),
            n_dead_total=n_dead_total,
            running_n_dead=running.n_dead, running_ln_x=running.ln_x,
            running_log_s1=running.log_s1, running_log_s2=running.log_s2,
            rng_state=rng.bit_generator.state,
            thread_segments=thread_segments, dynamic_rounds=dynamic_rounds,
        ))

    base_done = state is not None and state["phase"] == "dynamic"
    while not base_done and n_dead_total < hard_cap and not _terminated():
        n_steps = min(chunk_steps, max((hard_cap - n_dead_total) // n_batch, 1))
        du, dl, live_u_j, live_lnl_j, key, scale = core_fn(
            lnlike_u, live_u_j, live_lnl_j, key, scale, n_live, n_steps,
            n_chains, n_repeat, n_batch=n_batch,
        )
        dead_u_chunks.append(np.asarray(du))
        dead_lnl_chunks.append(np.asarray(dl))
        n_dead_total += n_steps * n_batch
        running.add(dead_lnl_chunks[-1])
        _save("base")

    dead_u = np.concatenate(dead_u_chunks, axis=0)
    dead_lnl = np.concatenate(dead_lnl_chunks)
    live_u = np.asarray(live_u_j)
    live_lnl = np.asarray(live_lnl_j)
    n_dead = len(dead_lnl)

    # ---- host-side weight/evidence assembly (Skilling 2006) ----
    order, all_lnl, all_logwt, logz, probs, ess = _assemble_weights(
        dead_lnl, live_lnl, n_live, n_batch=n_batch
    )
    all_u = np.concatenate([dead_u, live_u[order]], axis=0)

    # information H and error estimate
    finite = np.isfinite(all_logwt)
    p = np.exp(all_logwt[finite] - logz)
    h = float(np.sum(p * (all_lnl[finite] - logz)))
    logzerr = float(np.sqrt(max(h, 0.0) * _logzerr_scale(n_live, n_batch)))

    # ---- dynamic posterior threads (Higson-style dynamic NS) ----
    dynamic_rounds = 0
    n_iter_total = n_dead
    if dynamic and ess < min_ess:
        segments = [dict(
            dead_lnl=dead_lnl, live_lnl=live_lnl, n_live=n_live,
            n_batch=n_batch, L0=-np.inf, all_u=all_u,
        )]
        if state is not None and state.get("thread_segments"):
            # resume mid-dynamic: completed thread rounds restore verbatim;
            # an interrupted round replays from its start (same key) bitwise
            segments.extend(state["thread_segments"])
            dynamic_rounds = int(state["dynamic_rounds"])
            n_iter_total += sum(len(s["dead_lnl"]) for s in state["thread_segments"])
        merged = None
        while n_dead_total < hard_cap and dynamic_rounds < max_dynamic_rounds:
            if merged is None:
                merged = _merge_segments(segments)
            if merged[5] >= min_ess:
                break
            # thread starts: the live-set snapshot just above the activation
            # threshold, decorrelated by a whitened constrained walk so
            # thread deaths are fresh draws. Chains that never accept would
            # stay exact copies of existing samples (double-counted by the
            # merge) — retry them at halved step scale before giving up.
            L_lo, s_u, s_lnl = _thread_starts(merged, posterior_frac, n_live)
            starts_u = jnp.asarray(s_u)
            starts_lnl = jnp.asarray(s_lnl)
            chol = _live_cholesky(starts_u)
            t_live_u, t_live_lnl = starts_u, starts_lnl
            moved_any = np.zeros(n_live, dtype=bool)
            # the core's adapted scale is only a valid whitened-RW step for
            # the walk core; the slice core (run_polychord) adapts a bracket
            # width that can sit at 5-20 whitened units — clamp to unit
            # covariance so decorrelation proposals can ever accept (the
            # retry loop below still halves from there on stalls)
            w_scale = jnp.minimum(scale, 1.0)
            for _ in range(3):
                key, k_walk = jax.random.split(key)
                t_live_u, t_live_lnl, mv, _ = _decorrelate_walk(
                    lnlike_u, k_walk, t_live_u, t_live_lnl, jnp.asarray(L_lo),
                    w_scale, n_live, 1, 4 * n_repeat, chol,
                )
                moved_any |= np.asarray(mv)
                if moved_any.all():
                    break
                w_scale = w_scale * 0.5
            if not moved_any.all():
                from ..logger import getLogger

                getLogger().warning(
                    "dynamic NS round %d: %d/%d thread starts never moved in "
                    "the decorrelation walk (duplicated samples slightly "
                    "overweight the merged posterior there).",
                    dynamic_rounds, int((~moved_any).sum()), n_live,
                )
            # thread run: same compiled core, same shapes; terminates on its
            # own dlogz criterion in thread-relative prior-mass units
            t_running = _RunningEvidence(n_live, n_batch=n_batch)
            t_dead_u, t_dead_lnl = [], []
            while n_dead_total < hard_cap:
                n_steps = min(chunk_steps, max((hard_cap - n_dead_total) // n_batch, 1))
                du, dl, t_live_u, t_live_lnl, key, scale = core_fn(
                    lnlike_u, t_live_u, t_live_lnl, key, scale, n_live,
                    n_steps, n_chains, n_repeat, n_batch=n_batch,
                )
                t_dead_u.append(np.asarray(du))
                t_dead_lnl.append(np.asarray(dl))
                n_dead_total += n_steps * n_batch
                n_iter_total += n_steps * n_batch
                t_running.add(t_dead_lnl[-1])
                t_live_now = np.asarray(t_live_lnl)
                t_z, _ = t_running.status(t_live_now)
                t_remain = float(np.max(t_live_now)) + t_running.ln_x
                if np.exp(t_remain - np.logaddexp(t_z, t_remain)) < dlogz:
                    break
            t_dead_u = np.concatenate(t_dead_u, axis=0)
            t_dead_lnl_arr = np.concatenate(t_dead_lnl)
            t_live_u_np = np.asarray(t_live_u)
            t_live_lnl_np = np.asarray(t_live_lnl)
            t_order = np.argsort(t_live_lnl_np)
            segments.append(dict(
                dead_lnl=t_dead_lnl_arr, live_lnl=t_live_lnl_np,
                n_live=n_live, n_batch=n_batch, L0=L_lo,
                all_u=np.concatenate([t_dead_u, t_live_u_np[t_order]], axis=0),
            ))
            dynamic_rounds += 1
            merged = _merge_segments(segments)
            _save("dynamic", thread_segments=segments[1:], dynamic_rounds=dynamic_rounds)
        if merged is not None:
            # adopt the merged assembly even when zero thread rounds ran:
            # the loop's convergence gate judged the single-segment merge
            # ESS, and flagging truncation from the (slightly different)
            # static-assembly ESS could contradict it
            all_u, all_lnl, all_logwt, logz, probs, ess, h, logzerr = merged

    truncated = ess < min_ess
    if truncated:
        if dynamic and dynamic_rounds >= max_dynamic_rounds:
            hint = (
                f"the dynamic thread budget ran out (max_dynamic_rounds="
                f"{max_dynamic_rounds}); raise max_dynamic_rounds or n_live."
            )
        else:
            hint = "Raise max_iter (or leave it None) or n_live."
        msg = (
            f"Nested-sampling posterior ESS is only {ess:.0f} < min_ess={min_ess:.0f} "
            f"after exhausting the iteration budget (max_iter={max_iter}); "
            f"quantiles are unreliable. {hint}"
        )
        if on_low_ess == "raise":
            raise RuntimeError(msg)
        from ..logger import getLogger

        getLogger().warning(msg)

    # equal-weight posterior resampling (the post_equal_weights.dat analog)
    params_all = np.asarray(prior_transform(jnp.asarray(all_u)))
    idx = rng.choice(len(probs), size=n_equal, replace=True, p=probs)
    posterior = params_all[idx]

    return NestedResult(
        samples=params_all,
        logl=all_lnl,
        logwt=all_logwt,
        logz=float(logz),
        logzerr=logzerr,
        h=h,
        n_iter=n_iter_total,
        posterior=posterior,
        logl_posterior=all_lnl[idx],
        ess=ess,
        truncated=truncated,
        dynamic_rounds=dynamic_rounds,
    )


def _run_nested_multi(
    lnpost_u, prior_transform, n_params, key, *, n_live, max_iter, n_chains,
    n_repeat, n_equal, dlogz, n_batch, rng, min_ess, on_low_ess, core, n_runs,
    mesh=None, checkpoint=None, resume=False, config_tag=None,
):
    """``n_runs`` independent NS runs advanced in lockstep by one vmapped XLA
    program per chunk (see :func:`run_nested`'s ``n_runs`` docs). Each run has
    its own live set, walk scale, and RNG stream; the device sees an
    ``(n_runs * batch)``-point likelihood fan-out per dispatch — near-free
    parallelism on an accelerator that single-run batches underfill."""
    R = int(n_runs)
    hard_cap = max_iter if max_iter is not None else 1000 * n_live
    n_batch = max(1, min(int(n_batch), n_live // 4))
    core_fn = _nested_core if core is None else core

    def lnlike_u(u):
        return lnpost_u(prior_transform(u))

    def lnlike_flat(u):  # (R, B, p) -> (R, B) via one 2-d dispatch
        out = lnlike_u(u.reshape(-1, n_params))
        return np.asarray(out).reshape(R, -1)

    rng = np.random.default_rng(rng)

    ckpt_cfg = state = None
    if checkpoint is not None:
        import os

        ckpt_cfg = dict(
            version=_CKPT_VERSION, kind="multi", n_params=int(n_params),
            n_live=int(n_live), n_batch=int(n_batch), n_chains=int(n_chains),
            n_repeat=int(n_repeat), n_runs=R, chunk=int(_chunk_dead(n_live)),
            config_tag=None if config_tag is None else str(config_tag),
        )
        if resume and os.path.exists(checkpoint):
            state = _ckpt_load(checkpoint, ckpt_cfg)

    if state is None:
        key = jax.random.PRNGKey(int(rng.integers(2 ** 31))) if key is None else key
        keys = jax.random.split(key, R)

        # ---- init live points per run (full-batch resampling of -inf starts)
        u0 = rng.random((R, n_live, n_params))
        lnl0 = lnlike_flat(jnp.asarray(u0))
        lnl0 = np.where(np.isnan(lnl0), -np.inf, lnl0)
        for _ in range(200):
            bad = ~np.isfinite(lnl0)
            if not bad.any():
                break
            u_new = rng.random((R, n_live, n_params))
            l_new = lnlike_flat(jnp.asarray(u_new))
            l_new = np.where(np.isnan(l_new), -np.inf, l_new)
            take = bad & np.isfinite(l_new)
            u0 = np.where(take[..., None], u_new, u0)
            lnl0 = np.where(take, l_new, lnl0)

    @partial(jax.jit, static_argnames=("n_steps",))
    def vcore(u, lnl, ks, scales, n_steps):
        if mesh is not None:
            # runs shard over the mesh: each device advances its block of
            # independent live sets with zero communication — the per-run
            # program is unchanged, so sharded == unsharded bitwise
            u, lnl, ks, scales = _mesh_constrain_leading(
                (u, lnl, ks, scales), mesh
            )

        def one(u_r, lnl_r, k_r, s_r):
            return core_fn(
                lnlike_u, u_r, lnl_r, k_r, s_r, n_live, n_steps,
                n_chains, n_repeat, n_batch=n_batch,
            )

        out = jax.vmap(one)(u, lnl, ks, scales)
        if mesh is not None:
            out = _mesh_constrain_leading(out, mesh)
        return out

    running = _RunningEvidence(n_live, shape=(R,), n_batch=n_batch)
    if state is not None:
        dead_u_chunks = [state["dead_u"]]
        dead_lnl_chunks = [state["dead_lnl"]]
        live_u = jnp.asarray(state["live_u"])
        live_lnl = jnp.asarray(state["live_lnl"])
        keys = jnp.asarray(state["key"])
        scales = jnp.asarray(state["scale"])
        n_dead_total = int(state["n_dead_total"])
        running.n_dead = int(state["running_n_dead"])
        running.ln_x = float(state["running_ln_x"])
        running.log_s1 = state["running_log_s1"]
        running.log_s2 = state["running_log_s2"]
        rng.bit_generator.state = state["rng_state"]
    else:
        live_u = jnp.asarray(u0)
        live_lnl = jnp.asarray(lnl0)
        scales = jnp.full((R,), 0.5, dtype=live_u.dtype)
        dead_u_chunks, dead_lnl_chunks = [], []
        n_dead_total = 0
    chunk_steps = max(_chunk_dead(n_live) // n_batch, 8)
    done = np.zeros(R, dtype=bool)

    def _terminated():
        nonlocal done
        if running.n_dead == 0:
            return False
        live_now = np.asarray(live_lnl)
        logz_dead, ess_now = running.status(live_now)  # (R,), (R,)
        logz_remain = np.max(live_now, axis=1) + running.ln_x
        frac = np.exp(logz_remain - np.logaddexp(logz_dead, logz_remain))
        # the ESS gate is the POOLED Z-weighted mixture ESS (same formula as
        # the final report): a per-run min_ess/R threshold would let the loop
        # stop with a Z-dominant run contributing only ~min_ess/R
        zw = np.exp(logz_dead - np.logaddexp.reduce(logz_dead)) if np.any(
            np.isfinite(logz_dead)
        ) else np.full(R, 1.0 / R)
        pooled_ess = 1.0 / np.sum(zw ** 2 / np.maximum(ess_now, 1e-12))
        done = frac < dlogz
        return bool(done.all() and pooled_ess >= min_ess)

    while n_dead_total < hard_cap and not _terminated():
        n_steps = min(chunk_steps, max((hard_cap - n_dead_total) // n_batch, 1))
        du, dl, live_u, live_lnl, keys, scales = vcore(
            live_u, live_lnl, keys, scales, n_steps
        )
        dead_u_chunks.append(np.asarray(du))  # (R, n_steps * K, p)
        dead_lnl_chunks.append(np.asarray(dl))
        n_dead_total += n_steps * n_batch
        running.add(dead_lnl_chunks[-1])
        if checkpoint is not None:
            _ckpt_save(checkpoint, dict(
                config=ckpt_cfg, phase="base",
                dead_u=np.concatenate(dead_u_chunks, axis=1),
                dead_lnl=np.concatenate(dead_lnl_chunks, axis=1),
                live_u=np.asarray(live_u), live_lnl=np.asarray(live_lnl),
                key=np.asarray(keys), scale=np.asarray(scales),
                n_dead_total=n_dead_total,
                running_n_dead=running.n_dead, running_ln_x=running.ln_x,
                running_log_s1=running.log_s1, running_log_s2=running.log_s2,
                rng_state=rng.bit_generator.state,
            ))
    # a hard-cap exit skips the loop-condition check — recompute `done` so
    # the truncation report reflects the final state (idempotent otherwise)
    _terminated()

    dead_u = np.concatenate(dead_u_chunks, axis=1)
    dead_lnl = np.concatenate(dead_lnl_chunks, axis=1)
    live_u_np = np.asarray(live_u)
    live_lnl_np = np.asarray(live_lnl)

    # ---- per-run assembly, then Z-weighted combination
    logz_runs = np.empty(R)
    h_runs = np.empty(R)
    ess_runs = np.empty(R)
    run_samples, run_logl, run_logwt, run_probs = [], [], [], []
    for r in range(R):
        order, all_lnl, all_logwt, lz, probs, e = _assemble_weights(
            dead_lnl[r], live_lnl_np[r], n_live, n_batch=n_batch
        )
        all_u = np.concatenate([dead_u[r], live_u_np[r][order]], axis=0)
        finite = np.isfinite(all_logwt)
        p = np.exp(all_logwt[finite] - lz)
        h_runs[r] = float(np.sum(p * (all_lnl[finite] - lz)))
        logz_runs[r] = lz
        ess_runs[r] = e
        run_samples.append(np.asarray(prior_transform(jnp.asarray(all_u))))
        run_logl.append(all_lnl)
        run_logwt.append(all_logwt - np.log(R))  # so exp-sum over ALL = mean Z_r
        run_probs.append(probs)

    # ln(mean Z_r): per-run Ẑ is ~unbiased in Z, so average in Z space
    logz = float(np.logaddexp.reduce(logz_runs) - np.log(R))
    # honest error: empirical scatter across independent runs (captures
    # chain-correlation variance the sqrt(H/n) estimate misses), floored by
    # the averaged shrinkage estimate
    err_emp = float(np.std(logz_runs, ddof=1) / np.sqrt(R))
    err_shrink = float(
        np.sqrt(np.mean(np.maximum(h_runs, 0.0)) * _logzerr_scale(n_live, n_batch) / R)
    )
    logzerr = max(err_emp, err_shrink)

    # Z-weighted equal-weight posterior: pick runs ∝ Z_r, then within-run
    z_w = np.exp(logz_runs - np.logaddexp.reduce(logz_runs))
    n_eq_run = rng.multinomial(n_equal, z_w)
    post_chunks, post_lnl_chunks = [], []
    for r in range(R):
        if n_eq_run[r] == 0:
            continue
        idx = rng.choice(len(run_probs[r]), size=n_eq_run[r], replace=True, p=run_probs[r])
        post_chunks.append(run_samples[r][idx])
        post_lnl_chunks.append(run_logl[r][idx])
    posterior = np.concatenate(post_chunks, axis=0)
    logl_posterior = np.concatenate(post_lnl_chunks)

    # pooled ESS of the Z-weighted mixture: 1 / sum(z_w^2 / ess_r) — sums
    # to R*ess for equal runs but collapses to the dominant run's ESS when
    # one Z dominates (a plain sum would overstate it up to R-fold there)
    ess = float(1.0 / np.sum(z_w ** 2 / np.maximum(ess_runs, 1e-12)))
    truncated = ess < min_ess
    if truncated:
        msg = (
            f"Multi-run nested sampling: combined posterior ESS {ess:.0f} < "
            f"min_ess={min_ess:.0f} after the iteration budget "
            f"(max_iter={max_iter}); quantiles are unreliable."
        )
        if on_low_ess == "raise":
            raise RuntimeError(msg)
        from ..logger import getLogger

        getLogger().warning(msg)

    return NestedResult(
        samples=np.concatenate(run_samples, axis=0),
        logl=np.concatenate(run_logl),
        logwt=np.concatenate(run_logwt),
        logz=logz,
        logzerr=logzerr,
        h=float(np.mean(h_runs)),
        n_iter=int(dead_lnl.shape[1]) * R,
        posterior=posterior,
        logl_posterior=logl_posterior,
        ess=ess,
        truncated=truncated,
        logz_runs=logz_runs,
    )

def run_nested_vmapped(
    make_lnlike_u,
    data,
    live_u,
    live_lnl,
    *,
    n_live: int,
    n_batch: int = 8,
    n_chains: int = 8,
    n_repeat: int = 24,
    n_equal: int = 2000,
    dlogz: float = 0.01,
    min_ess: float = 100.0,
    max_iter: int = None,
    seed=None,
    rng=None,
    mesh=None,
    label: str = "problem",
    dynamic: bool = False,
    posterior_frac: float = 0.025,
    max_dynamic_rounds: int = 8,
    checkpoint: str = None,
    resume: bool = False,
    config_tag: str = None,
):
    """Nested sampling over a whole FAMILY of independent problems, vmapped
    into one XLA program per shrinkage chunk.

    This is the engine behind :meth:`BatchStarFitter.fit_multinest` (the
    reference's SLURM-array-of-MultiNest-runs, scripts/batch_starfit,
    collapsed onto one chip) exposed generically: any per-problem likelihood
    — per-star models, simulated-cluster replicas for SBC, hyperparameter
    sweeps — rides the same lockstep advance. Every problem keeps its own
    live set, walk scale, and RNG stream; termination is per-problem
    (dlogz AND min_ess), and the chunk loop stops when all problems are done.

    Parameters
    ----------
    make_lnlike_u : callable(data_m) -> (lnlike_u : (B, n_params) unit-cube
        points -> (B,) ln-likelihoods) for ONE problem's data pytree slice.
    data : pytree whose every leaf has leading axis M (one row per problem).
    live_u, live_lnl : (M, n_live, n_params) / (M, n_live) initial live
        points in the unit cube with their (finite) ln-likelihoods — draw
        from the prior and rejection-resample -inf rows before calling
        (see ``BatchStarFitter.fit_multinest`` for the pattern).
    rng : optional ``np.random.Generator`` driving both the device walk
        streams and the equal-weight resampling (takes precedence over
        ``seed``, which is ignored when ``rng`` is given; lets a caller
        keep one stream across init + run).
    mesh : optional ``jax.sharding.Mesh`` — shards the problem axis over the
        mesh's first axis; problems are independent, so sharded == unsharded
        exactly (zero collectives).
    dynamic : dynamic nested sampling over the whole family (see
        :func:`run_nested`'s ``dynamic``). The base runs stop on the
        per-problem ``dlogz`` evidence criterion; while any problem's
        posterior ESS is below ``min_ess``, a ROUND of posterior-focused
        threads launches — one thread per problem, all advanced in the same
        lockstep vmapped programs (per-problem activation thresholds at
        ``1 - posterior_frac`` posterior mass, whitened decorrelation walks,
        exact varying-live-count merge via :func:`_merge_segments`).
        Problems already at target ride along (their threads just sharpen
        the posterior; the merge stays unbiased). ``dynamic=False``
        (default) preserves the static behavior and RNG stream exactly.

    Returns a dict with per-problem arrays: ``logz``, ``logzerr``, ``ess``,
    ``converged`` (bool), ``samples_u`` (M, n_equal, n_params) equal-weight
    posterior draws in the UNIT CUBE (NaN for problems with no posterior
    support), ``lnl`` (M, n_equal), the scalar ``n_dead``, and
    ``dynamic_rounds``.
    """
    from functools import partial as _partial

    from ..logger import getLogger

    M, n_live_in, n_params = live_u.shape
    if n_live_in != int(n_live):
        raise ValueError(f"live_u has {n_live_in} live points, expected n_live={n_live}")
    n_batch = max(1, min(int(n_batch), n_live // 4))
    hard_cap = max_iter if max_iter is not None else 1000 * n_live
    rng_given = rng is not None
    rng = np.random.default_rng(seed) if rng is None else rng

    if mesh is not None:
        from ..parallel import mesh_constrain_leading as _constrain
    else:
        _constrain = None

    @_partial(jax.jit, static_argnames=("n_steps",))
    def batch_core(data, u0, lnl0, keys, scales, n_steps):
        if mesh is not None:
            data, u0, lnl0, keys, scales = _constrain((data, u0, lnl0, keys, scales), mesh)

        def one(data_m, u0s, lnl0s, key, scale):
            return _nested_core(
                make_lnlike_u(data_m), u0s, lnl0s, key, scale, n_live, n_steps,
                n_chains, n_repeat, n_batch=n_batch,
            )

        out = jax.vmap(one)(data, u0, lnl0, keys, scales)
        if mesh is not None:
            out = _constrain(out, mesh)
        return out

    ckpt_cfg = state = None
    if checkpoint is not None:
        import os

        ckpt_cfg = dict(
            version=_CKPT_VERSION, kind="vmapped", n_params=int(n_params),
            n_live=int(n_live), n_batch=int(n_batch), n_chains=int(n_chains),
            n_repeat=int(n_repeat), n_problems=int(M),
            chunk=int(_chunk_dead(n_live)),
            config_tag=None if config_tag is None else str(config_tag),
        )
        if resume and os.path.exists(checkpoint):
            state = _ckpt_load(checkpoint, ckpt_cfg)

    chunk_steps = max(_chunk_dead(n_live) // n_batch, 8)
    running = _RunningEvidence(n_live, shape=(M,), n_batch=n_batch)
    if state is not None:
        dead_u_chunks = [state["dead_u"]]
        dead_lnl_chunks = [state["dead_lnl"]]
        live_u = jnp.asarray(state["live_u"])
        live_lnl = jnp.asarray(state["live_lnl"])
        keys = jnp.asarray(state["key"])
        scales = jnp.asarray(state["scale"])
        n_dead_total = int(state["n_dead_total"])
        running.n_dead = int(state["running_n_dead"])
        running.ln_x = float(state["running_ln_x"])
        running.log_s1 = state["running_log_s1"]
        running.log_s2 = state["running_log_s2"]
        rng.bit_generator.state = state["rng_state"]
    else:
        live_u = jnp.asarray(live_u)
        live_lnl = jnp.asarray(live_lnl)
        # honor rng precedence (docstring contract): whenever the caller
        # passes an rng it drives BOTH the device walk streams and the
        # equal-weight resampling (a seed passed alongside it is ignored
        # here); seed alone pins the device key directly; with neither,
        # streams are fresh-random
        keys = jax.random.split(
            jax.random.PRNGKey(
                int(rng.integers(2 ** 31)) if (rng_given or seed is None) else int(seed)
            ),
            M,
        )
        scales = jnp.full((M,), 0.5)
        dead_lnl_chunks = []
        dead_u_chunks = []
        n_dead_total = 0
    done = np.zeros(M, dtype=bool)

    def _base_terminated():
        # incremental dead-only evidence + ESS (O(chunk) per check; the
        # dlogz ratio uses the dead-only evidence rather than
        # double-counting the live bound). dynamic mode hands low-ESS
        # handling to posterior threads instead of terminal shrinkage —
        # the base runs stop on evidence alone
        nonlocal done
        if running.n_dead == 0:
            return False
        live_now = np.asarray(live_lnl)
        logz_dead, ess_now = running.status(live_now)
        logz_remain = np.max(live_now, axis=1) + running.ln_x
        frac = np.exp(logz_remain - np.logaddexp(logz_dead, logz_remain))
        done = (frac < dlogz) if dynamic else (frac < dlogz) & (ess_now >= min_ess)
        return bool(done.all())

    def _save(phase, thread_segments=None, dyn_rounds=0):
        if checkpoint is None:
            return
        _ckpt_save(checkpoint, dict(
            config=ckpt_cfg, phase=phase,
            dead_u=np.concatenate(dead_u_chunks, axis=1),
            dead_lnl=np.concatenate(dead_lnl_chunks, axis=1),
            live_u=np.asarray(live_u), live_lnl=np.asarray(live_lnl),
            key=np.asarray(keys), scale=np.asarray(scales),
            n_dead_total=n_dead_total,
            running_n_dead=running.n_dead, running_ln_x=running.ln_x,
            running_log_s1=running.log_s1, running_log_s2=running.log_s2,
            rng_state=rng.bit_generator.state,
            thread_segments=thread_segments, dynamic_rounds=dyn_rounds,
        ))

    base_done = state is not None and state["phase"] == "dynamic"
    while not base_done and n_dead_total < hard_cap and not _base_terminated():
        n_steps = min(chunk_steps, max((hard_cap - n_dead_total) // n_batch, 1))
        du, dl, live_u, live_lnl, keys, scales = batch_core(
            data, live_u, live_lnl, keys, scales, n_steps
        )
        dead_u_chunks.append(np.asarray(du))  # (M, n_steps * K, n_params)
        dead_lnl_chunks.append(np.asarray(dl))
        n_dead_total += n_steps * n_batch
        running.add(dead_lnl_chunks[-1])
        _save("base")
    # a hard-cap or dynamic-restore exit skips the loop-condition check —
    # recompute `done` for the final convergence report (idempotent)
    _base_terminated()

    dead_u = np.concatenate(dead_u_chunks, axis=1)
    dead_lnl = np.concatenate(dead_lnl_chunks, axis=1)
    live_u_np = np.asarray(live_u)
    live_lnl_np = np.asarray(live_lnl)

    # ---- dynamic posterior threads (Higson-style, whole family in lockstep)
    merged = None
    dynamic_rounds = 0
    if dynamic:
        segments = []
        for s in range(M):
            order_s = np.argsort(live_lnl_np[s])
            segments.append([dict(
                dead_lnl=dead_lnl[s], live_lnl=live_lnl_np[s], n_live=n_live,
                n_batch=n_batch, L0=-np.inf,
                all_u=np.concatenate([dead_u[s], live_u_np[s][order_s]], axis=0),
            )])
        if state is not None and state.get("thread_segments"):
            # resume mid-dynamic: completed rounds restore verbatim; an
            # interrupted round replays from its start (same keys) bitwise
            for s in range(M):
                segments[s].extend(state["thread_segments"][s])
            dynamic_rounds = int(state["dynamic_rounds"])
        merged = [_merge_segments(segs) for segs in segments]

        @jax.jit
        def decor_core(data, starts, lnl0, L_lo, w_scale, keys):
            if mesh is not None:
                data, starts, lnl0, L_lo, w_scale, keys = _constrain(
                    (data, starts, lnl0, L_lo, w_scale, keys), mesh
                )

            def one(data_m, s0, l0, Ll, ws, key):
                chol = _live_cholesky(s0)
                return _constrained_walk(
                    make_lnlike_u(data_m), key, s0, l0, Ll, ws, n_live, 1,
                    4 * n_repeat, L=chol,
                )

            out = jax.vmap(one)(data, starts, lnl0, L_lo, w_scale, keys)
            if mesh is not None:
                out = _constrain(out, mesh)
            return out

        while n_dead_total < hard_cap and dynamic_rounds < max_dynamic_rounds:
            ess_m = np.array([mg[5] for mg in merged])
            if (ess_m >= min_ess).all():
                break
            # per-problem activation threshold + thread-start snapshot
            starts = np.empty((M, n_live, n_params))
            starts_lnl = np.empty((M, n_live))
            L_los = np.empty(M)
            for s in range(M):
                L_los[s], starts[s], starts_lnl[s] = _thread_starts(
                    merged[s], posterior_frac, n_live
                )

            # decorrelate the copied starts (fresh draws, not double counts);
            # problems whose chains never accept retry at halved step scale
            t_live_u = jnp.asarray(starts)
            t_live_lnl = jnp.asarray(starts_lnl)
            L_los_j = jnp.asarray(L_los)
            moved_any = np.zeros((M, n_live), dtype=bool)
            # clamp to unit whitened covariance (see run_nested's dynamic
            # block) so oversized adapted scales can't stall decorrelation
            w_scales = np.minimum(np.asarray(scales), 1.0)
            for _ in range(3):
                split = jax.vmap(jax.random.split)(keys)  # (M, 2, key)
                keys, walk_keys = split[:, 0], split[:, 1]
                t_live_u, t_live_lnl, mv, _ = decor_core(
                    data, t_live_u, t_live_lnl, L_los_j, jnp.asarray(w_scales), walk_keys
                )
                moved_any |= np.asarray(mv)
                if moved_any.all():
                    break
                w_scales = np.where(moved_any.all(axis=1), w_scales, w_scales * 0.5)
            if not moved_any.all():
                getLogger().warning(
                    "run_nested_vmapped dynamic round %d: %d thread starts "
                    "never moved in the decorrelation walk (duplicated "
                    "samples slightly overweight the merged posterior).",
                    dynamic_rounds, int((~moved_any).sum()),
                )

            # thread runs: same vmapped core and shapes; each problem's
            # thread terminates on its own dlogz (in thread-relative
            # prior-mass units); finished threads keep shrinking until all
            # are done — extra deaths are valid NS removals the merge handles
            t_running = _RunningEvidence(n_live, shape=(M,), n_batch=n_batch)
            t_dead_u_chunks, t_dead_lnl_chunks = [], []
            while n_dead_total < hard_cap:
                n_steps = min(chunk_steps, max((hard_cap - n_dead_total) // n_batch, 1))
                du, dl, t_live_u, t_live_lnl, keys, scales = batch_core(
                    data, t_live_u, t_live_lnl, keys, scales, n_steps
                )
                t_dead_u_chunks.append(np.asarray(du))
                t_dead_lnl_chunks.append(np.asarray(dl))
                n_dead_total += n_steps * n_batch
                t_running.add(t_dead_lnl_chunks[-1])
                t_live_now = np.asarray(t_live_lnl)
                t_z, _ = t_running.status(t_live_now)
                t_remain = np.max(t_live_now, axis=1) + t_running.ln_x
                t_frac = np.exp(t_remain - np.logaddexp(t_z, t_remain))
                if (t_frac < dlogz).all():
                    break

            t_dead_u = np.concatenate(t_dead_u_chunks, axis=1)
            t_dead_lnl = np.concatenate(t_dead_lnl_chunks, axis=1)
            t_live_u_np = np.asarray(t_live_u)
            t_live_lnl_np = np.asarray(t_live_lnl)
            for s in range(M):
                t_order = np.argsort(t_live_lnl_np[s])
                segments[s].append(dict(
                    dead_lnl=t_dead_lnl[s], live_lnl=t_live_lnl_np[s],
                    n_live=n_live, n_batch=n_batch, L0=L_los[s],
                    all_u=np.concatenate(
                        [t_dead_u[s], t_live_u_np[s][t_order]], axis=0
                    ),
                ))
            merged = [_merge_segments(segs) for segs in segments]
            dynamic_rounds += 1
            _save("dynamic", thread_segments=[segs[1:] for segs in segments],
                  dyn_rounds=dynamic_rounds)
        # keep the merged assembly even when zero thread rounds ran: the
        # convergence gate above judged the single-segment merge ESS, so the
        # reported ess/converged must come from the same assembly

    # ---- per-problem evidence + equal-weight posterior assembly
    logz = np.empty(M)
    logzerr = np.empty(M)
    ess = np.empty(M)
    samples_u = np.empty((M, n_equal, n_params))
    lnl_eq = np.empty((M, n_equal))
    for s in range(M):
        if merged is not None:
            all_u, all_lnl, _, lz, probs, e, _h, lzerr = merged[s]
            logzerr[s] = lzerr
        else:
            order, all_lnl, all_logwt, lz, probs, e = _assemble_weights(
                dead_lnl[s], live_lnl_np[s], n_live, n_batch=n_batch
            )
            all_u = np.concatenate([dead_u[s], live_u_np[s][order]], axis=0)
            finite = np.isfinite(all_logwt)
            p = np.exp(all_logwt[finite] - lz)
            h = float(np.sum(p * (all_lnl[finite] - lz)))
            logzerr[s] = np.sqrt(max(h, 0.0) * _logzerr_scale(n_live, n_batch))
        logz[s] = lz
        ess[s] = e
        if not np.isfinite(lz) or probs.sum() <= 0:
            # problem with zero posterior support everywhere (e.g. data
            # inconsistent with the whole model): NaN posterior rather
            # than crashing the whole-family resampling
            getLogger().warning(
                "run_nested_vmapped: %s %d has no posterior support "
                "(logz=%s); returning NaN samples for it.", label, s, lz,
            )
            samples_u[s] = np.nan
            lnl_eq[s] = -np.inf
            continue
        idx = rng.choice(len(probs), size=n_equal, replace=True, p=probs)
        samples_u[s] = all_u[idx]
        lnl_eq[s] = all_lnl[idx]

    converged = done & (ess >= min_ess) if dynamic else done
    if not converged.all():
        hint = (
            "raise max_dynamic_rounds or n_live" if dynamic
            else "raise max_iter or n_live"
        )
        getLogger().warning(
            "run_nested_vmapped: %d/%d %ss hit the iteration budget before "
            "dlogz+ESS termination; their quantiles/evidences may be "
            "unreliable (%s).",
            int((~converged).sum()), M, label, hint,
        )

    return dict(
        logz=logz, logzerr=logzerr, ess=ess, n_dead=n_dead_total,
        converged=converged, samples_u=samples_u, lnl=lnl_eq,
        dynamic_rounds=dynamic_rounds,
    )
