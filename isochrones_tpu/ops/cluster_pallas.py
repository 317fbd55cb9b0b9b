"""Pallas kernel (Triton route) for the hierarchical-cluster marginal.

This is the fused version of ``ops/cluster.py::calc_lnlike_grid`` +
``integrate_over_eeps`` (reference ``isochrones/cluster_utils.py:9-128``).
The XLA path materializes the (Nstars, Neep, Neep) binary-mixture plane in
device memory and re-reads it once per band plus once for the trapezoids;
at the full 1710-EEP ladder that plane is ~585 MB per walker in float32,
so the walker batch has to run one walker at a time. Here the plane never
leaves the block that computes it. Each (star tile, j tile) program:

* loads its j rows of flux, single-star magnitudes and per-star row terms
  once, then loops over k tiles inside the kernel (``lax.fori_loop``),
  stopping at the diagonal: the integrand is lower-triangular (k <= j), so
  tiles above it are never visited;
* per k tile, builds the star-independent binary magnitude
  ``-2.5 log10(f1 + f2)`` once per band and reuses it for every star of
  the tile, then forms each star's band mixture in registers;
* folds the double trapezoid into one weighted sum-of-exp (see
  ``trapezoid_weights``, an exact identity with the pairwise form) and
  keeps, for every j row, a running (max, rescaled sum) across k tiles;
* writes those per-row partials. Blocks run in parallel and in no order,
  so nothing is carried between them: a log-sum-exp in XLA combines the
  j rows into each star's ln-marginal.

Device traffic drops from O(S*E^2*B) to O(S/TS * E^2) reads of the two
(E, E) weight planes; the kernel is bound by transcendentals.

Numerics: the streaming log-sum-exp is exact up to rounding at any
magnitude. The XLA path's ``integrate_over_eeps_ln`` applies the
equivalent per-star max shift, so both return finite tiny ln-marginals
where the reference's raw exp-space trapezoid (cluster_utils.py:108-128)
underflows whole marginals to -inf below ~-745 nats (f64) / ~-88 (f32).
Only that underflow behavior deviates from the reference; the
lower-triangle/q-floor/validity masking is folded into the zero pattern of
the weight matrix.

The compiled kernel is float32 only (``ops/cluster.py::kernel_path`` holds
the dispatch rule). ``interpret=True`` runs the same program on the CPU in
any dtype, which is how the tests check it without a card.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

__all__ = ["cluster_lnmarginal_pallas", "trapezoid_weights", "plan_tiles"]

#: streaming SMs on an H100 (SXM and PCIe both have 132 enabled). The
#: planner keeps at least two blocks per SM in flight for one walker.
_N_SM = 132
#: float32 tile elements the planner lets one block hold live across the
#: k loop: ``n_bands`` binary-magnitude tiles plus the q-prior, weight,
#: accumulator and exponent tiles. 4 warps x 128 threads x ~96 registers
#: of tile data keeps each thread well under the 255-register cap.
_TILE_ELEMS_BUDGET = 4 * 32 * 96
_NUM_WARPS = 4
_NEG_BIG = -1e30
_LOG2E = 1.4426950408889634
_LN2 = 0.6931471805599453
#: -2.5 log10(x) = _MAG_PER_LOG2 * log2(x)
_MAG_PER_LOG2 = -2.5 * 0.30102999566398120


def _round_up(x, m):
    return ((x + m - 1) // m) * m


def _is_pow2(n):
    return n > 0 and (n & (n - 1)) == 0


def trapezoid_weights(eeps, mask):
    """(Neep, Neep) weights W such that for any per-star plane L,

        integrate_over_eeps(where(mask, lnL, -inf), eeps)
          == sum_{j,k} exp(lnL[j,k]) * W[j,k]

    exactly (same floating-point class of operations; see
    ``ops/cluster.py::integrate_over_eeps`` for the pairwise form this
    re-expresses). ``mask`` is the combined validity x lower-triangle x
    q-floor mask — masked entries get zero weight.
    """
    n = eeps.shape[0]
    de = eeps[1:] - eeps[:-1]  # (n-1,)
    zero = jnp.zeros((1,), dtype=eeps.dtype)
    de_km1 = jnp.concatenate([zero, de])  # de[k-1], with de[-1] = 0
    de_k = jnp.concatenate([de, zero])  # de[k],   with de[n-1] = 0
    j = jnp.arange(n)[:, None]
    k = jnp.arange(n)[None, :]
    # inner trapz over k restricted to k+1 <= j (pairwise identity)
    w_inner = 0.5 * (de_k[None, :] * (k + 1 <= j) + de_km1[None, :] * (k <= j))
    # outer trapz over the full j range
    w_outer = 0.5 * (de_km1 + de_k)  # (n,)
    return jnp.where(mask, w_outer[:, None] * w_inner, 0.0)


def plan_tiles(n_eep, n_stars, n_bands):
    """(tile_s, tile_j, tile_k) for one walker's marginal.

    All three are powers of two. ``tile_j * tile_k`` elements times the
    ``n_bands + 4`` tiles a block keeps live stay under the register
    budget; ``tile_k`` is the wider side, so each k step loads contiguous
    rows. ``tile_s`` (stars per block) amortizes the binary magnitude over
    stars; 4 measured fastest on an H100 at 50 stars x 800 and 1710 EEPs
    (8 and 16 keep too many per-star carries live). It is halved until one
    walker alone launches at least two blocks per SM."""
    tile_elems = _TILE_ELEMS_BUDGET // (n_bands + 4)
    tile_k = 64
    tile_j = 32
    while tile_j * tile_k > tile_elems and tile_j > 8:
        tile_j //= 2
    while tile_j * tile_k > tile_elems and tile_k > 16:
        tile_k //= 2
    n_j = -(-max(n_eep, 1) // tile_j)
    tile_s = 4
    while tile_s > 1 and -(-n_stars // tile_s) * n_j < 2 * _N_SM:
        tile_s //= 2
    return tile_s, tile_j, tile_k


def _log2(x, interpret):
    """Base-2 log. Compiled: one ``lg2.approx.f32`` (max abs error ~2^-22,
    far below the float32 rounding of the sums it feeds); jnp has no log2
    primitive and its ``log(x) / log(2)`` lowers to the slower accurate
    ``__nv_logf``. Interpreted: ``jnp.log2`` in the caller's dtype."""
    if interpret:
        return jnp.log2(x)
    (y,) = plgpu.elementwise_inline_asm(
        "lg2.approx.f32 $0, $1;",
        args=[x],
        constraints="=f,f",
        pack=1,
        result_shape_dtypes=[jax.ShapeDtypeStruct(x.shape, x.dtype)],
    )
    return y


def _cluster_kernel(n_bands, tile_s, tile_k, n_k_tiles, interpret,
                    fluxj_ref, fluxk_ref, magsj_ref, lnq_ref, w2_ref,
                    lnjrow_ref, magv_ref, hinv_ref, lnfb_ref, m_ref, s_ref):
    """One (star tile, j tile) program. Loops over the k tiles at or below
    the diagonal and leaves, per star and j row, the running max
    ``m_ref[t, j]`` and the sum ``s_ref[t, j]`` of ``w2 * 2^(lnL - m)``
    over k. Every log-likelihood term arrives pre-scaled to base 2 (log2 e
    times the natural value), so each transcendental is one ``exp2`` or
    ``log2``. Masked cells are pinned to -1e30 so they can neither win the
    max nor overflow the exp."""
    jb = pl.program_id(1)
    tile_j = fluxj_ref.shape[1]

    ln_fb = lnfb_ref[0]
    ln_1mfb = lnfb_ref[1]
    fj = [fluxj_ref[b, :] for b in range(n_bands)]  # (TJ,) primary flux
    mv = [[magv_ref[t, b] for b in range(n_bands)] for t in range(tile_s)]
    hv = [[hinv_ref[t, b] for b in range(n_bands)] for t in range(tile_s)]
    # the single-star term depends on the primary row only
    ln_single = []
    for t in range(tile_s):
        row = []
        for b in range(n_bands):
            rs = magsj_ref[b, :] - mv[t][b]
            row.append((ln_1mfb - rs * rs * hv[t][b])[:, None])  # (TJ, 1)
        ln_single.append(row)
    lnjrow = [lnjrow_ref[t, :][:, None] for t in range(tile_s)]  # (TJ, 1)

    # k <= j <= (jb + 1) * TJ - 1: tiles past the diagonal hold no weight
    n_k = jnp.minimum(((jb + 1) * tile_j + tile_k - 1) // tile_k, n_k_tiles)

    def body(kk, carry):
        ms, ss = carry
        ks = pl.ds(kk * tile_k, tile_k)
        # -2.5 log10(f1 + f2), shared by every star of the tile
        mag_bin = [
            _MAG_PER_LOG2 * _log2(fj[b][:, None] + fluxk_ref[b, ks][None, :], interpret)
            for b in range(n_bands)
        ]  # (TJ, TK) each
        lnq = lnq_ref[:, ks]
        w2 = w2_ref[:, ks]
        live = w2 > 0
        new_ms, new_ss = [], []
        for t in range(tile_s):
            acc = None
            for b in range(n_bands):
                rb = mag_bin[b] - mv[t][b]
                x = ln_fb - rb * rb * hv[t][b]
                y = ln_single[t][b]
                # base-2 logaddexp; both sides are finite or -inf, never NaN
                mix = jnp.maximum(x, y) + _log2(1.0 + jnp.exp2(-jnp.abs(x - y)), interpret)
                acc = mix if acc is None else acc + mix
            a = jnp.where(live, acc + lnq + lnjrow[t], _NEG_BIG)
            m_new = jnp.maximum(ms[t], jnp.max(a, axis=1))
            s_new = ss[t] * jnp.exp2(ms[t] - m_new) + jnp.sum(
                jnp.exp2(a - m_new[:, None]) * w2, axis=1
            )
            new_ms.append(m_new)
            new_ss.append(s_new)
        return tuple(new_ms), tuple(new_ss)

    dt = w2_ref.dtype
    init = (
        tuple(jnp.full((tile_j,), _NEG_BIG, dtype=dt) for _ in range(tile_s)),
        tuple(jnp.zeros((tile_j,), dtype=dt) for _ in range(tile_s)),
    )
    ms, ss = jax.lax.fori_loop(0, n_k, body, init)
    for t in range(tile_s):
        m_ref[t, :] = ms[t]
        s_ref[t, :] = ss[t]


@partial(jax.jit, static_argnames=("interpret", "tile_s", "tile_j", "tile_k", "q_jacobian"))
def cluster_lnmarginal_pallas(
    lnlike_prop,  # (S, E) per-star property lnlike (may contain -inf/nan)
    model_mags,  # (E, B) model magnitudes along the EEP ladder
    masses,  # (E,) primary masses (sanitized: 1.0 where invalid)
    ln_dm_deeps,  # (E,) ln|dm/deep| (sanitized: 0.0 where invalid)
    eeps,  # (E,) EEP ladder values
    mag_values,  # (S, B) observed magnitudes
    mag_uncs,  # (S, B) magnitude uncertainties
    alpha,
    gamma,
    fB,
    mass_lo,
    mass_hi,
    q_lo,
    valid,  # (E,) bool — primary (j) rows with finite model values
    *,
    interpret=False,
    tile_s=None,  # stars per block; None = plan_tiles
    tile_j=None,  # primary-EEP rows per block; None = plan_tiles
    tile_k=None,  # secondary-EEP columns per k step; None = plan_tiles
    q_jacobian=False,
    valid_k=None,  # (E,) bool — secondary (k) rows; defaults to ``valid``
):
    """Per-star ln marginal likelihood (S,) — ``log`` of what
    ``integrate_over_eeps(calc_lnlike_grid(...), eeps)`` returns, computed
    by one fused Pallas kernel (reference cluster.py:365-378 +
    cluster_utils.py:9-128) with streaming log-sum-exp accumulation.
    Returns -inf where the marginal is zero; may return a finite tiny
    value where the grid path's raw ``exp`` underflows to zero.
    """
    dt = model_mags.dtype
    S, B = mag_values.shape
    E = model_mags.shape[0]

    auto = plan_tiles(E, S, B)
    TS = int(tile_s or auto[0])
    TJ = int(tile_j or auto[1])
    TK = int(tile_k or auto[2])
    for name, v in (("tile_s", TS), ("tile_j", TJ), ("tile_k", TK)):
        if not _is_pow2(v):
            raise ValueError(f"{name}={v} must be a power of two")

    if valid_k is None:
        valid_k = valid
    either = valid | valid_k
    safe_mags = jnp.where(either[:, None], model_mags, jnp.zeros_like(model_mags))
    flux = 10.0 ** (-0.4 * safe_mags)  # (E, B)

    a1 = alpha + 1.0
    c_mass = a1 / (mass_hi ** a1 - mass_lo ** a1)
    lnmass = jnp.log(c_mass) + alpha * jnp.log(masses) + ln_dm_deeps  # (E,)
    q = masses[None, :] / masses[:, None]  # (E_j, E_k) = m_k / m_j
    g1 = gamma + 1.0
    c_q = g1 / (1.0 - q_lo ** g1)
    lnq = jnp.log(c_q) + gamma * jnp.log(q)  # (E, E)
    if q_jacobian:
        # |dq/deep2| = (dm/deep)_k / m_j change of variables (see
        # ops/cluster.py calc_lnlike_grid docs); precomputed here so the
        # kernel body is untouched
        lnq = lnq + ln_dm_deeps[None, :] - jnp.log(masses)[:, None]

    tri = jnp.tril(jnp.ones((E, E), dtype=bool))
    mask = (q >= q_lo) & tri & valid[:, None] & valid_k[None, :]
    w2 = trapezoid_weights(eeps, mask).astype(dt)
    lnq = jnp.where(mask, lnq, 0.0)  # masked entries have w2 == 0

    lnprop = jnp.nan_to_num(lnlike_prop, nan=_NEG_BIG, neginf=_NEG_BIG)
    # fold everything j-indexed into one (S, E) row term; the kernel works
    # in base 2, so every log-likelihood term is scaled by log2(e) here
    lnjrow = (lnprop + lnmass[None, :]) * _LOG2E
    lnq = lnq * _LOG2E

    # ---- pad: both EEP axes to a common multiple of the tiles (padded
    # rows/columns carry zero weight and finite values), bands to a power
    # of two (the kernel loops over the real ones only), stars to TS
    # (padded stars carry -1e30 rows -> zero weight)
    Ep = _round_up(E, max(TJ, TK))
    Bp = pl.next_power_of_2(B)
    Sp = _round_up(S, TS)
    pe, pb, ps = Ep - E, Bp - B, Sp - S
    fluxT = jnp.pad(flux.T, ((0, pb), (0, pe)), constant_values=1.0)  # (Bp, Ep)
    magsT = jnp.pad(safe_mags.T, ((0, pb), (0, pe)))  # (Bp, Ep)
    lnq_p = jnp.pad(lnq, ((0, pe), (0, pe)))
    w2_p = jnp.pad(w2, ((0, pe), (0, pe)))
    lnjrow_p = jnp.pad(lnjrow, ((0, ps), (0, pe)), constant_values=_NEG_BIG)
    magv_p = jnp.pad(mag_values.astype(dt), ((0, ps), (0, pb)))
    unc_p = jnp.pad(mag_uncs.astype(dt), ((0, ps), (0, pb)), constant_values=1.0)
    hinv_p = (0.5 * _LOG2E) / (unc_p * unc_p)
    params = (jnp.stack([jnp.log(fB), jnp.log1p(-fB)]) * _LOG2E).astype(dt)  # (2,)

    out = jax.ShapeDtypeStruct((Sp, Ep), dt)
    n_j = Ep // TJ
    grid = (Sp // TS, n_j)
    m_out, s_out = pl.pallas_call(
        partial(_cluster_kernel, B, TS, TK, Ep // TK, interpret),
        grid=grid,
        in_specs=[
            pl.BlockSpec((Bp, TJ), lambda sb, jb: (0, jb)),  # flux, j rows
            pl.BlockSpec((Bp, Ep), lambda sb, jb: (0, 0)),  # flux, all k
            pl.BlockSpec((Bp, TJ), lambda sb, jb: (0, jb)),  # single mags
            pl.BlockSpec((TJ, Ep), lambda sb, jb: (jb, 0)),  # q prior
            pl.BlockSpec((TJ, Ep), lambda sb, jb: (jb, 0)),  # trapezoid w
            pl.BlockSpec((TS, TJ), lambda sb, jb: (sb, jb)),  # row terms
            pl.BlockSpec((TS, Bp), lambda sb, jb: (sb, 0)),  # observed mags
            pl.BlockSpec((TS, Bp), lambda sb, jb: (sb, 0)),  # log2(e) / 2unc^2
            pl.BlockSpec((2,), lambda sb, jb: (0,)),  # log2 fB, log2(1 - fB)
        ],
        out_specs=(
            pl.BlockSpec((TS, TJ), lambda sb, jb: (sb, jb)),
            pl.BlockSpec((TS, TJ), lambda sb, jb: (sb, jb)),
        ),
        out_shape=(out, out),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=_NUM_WARPS, num_stages=2),
        interpret=interpret,
        name="cluster_lnmarginal",
    )(fluxT, fluxT, magsT, lnq_p, w2_p, lnjrow_p, magv_p, hinv_p, params)

    # combine the per-row partials: ln sum_j s_j 2^m_j per star. A star
    # with no unmasked support has s == 0 -> -inf; one whose only support
    # carries the -1e30 no-data sentinel lands near -1e30 -> also -inf (no
    # physical ln-marginal approaches -1e20)
    m_out, s_out = m_out[:S], s_out[:S]
    m_max = jnp.max(m_out, axis=1)
    total = jnp.sum(s_out * jnp.exp2(m_out - m_max[:, None]), axis=1)
    res = (jnp.log2(total) + m_max) * _LN2
    return jnp.where(res > -1e20, res, -jnp.inf)
