"""Executable cross-implementation oracle: pure-numpy transliteration of the
reference's numba kernel loop bodies.

This module exists to hold the kernels to executed agreement with the
reference: every L0 kernel in ``isochrones_tpu/ops`` is parity-tested in
``tests/test_oracle_parity.py`` against a line-faithful scalar-loop
re-implementation of the reference algorithms, rather than against the
builder's *reading* of the reference. Sources transliterated:

* ``/root/reference/isochrones/interp.py:10-205``  (searchsorted, find_indices_*)
* ``/root/reference/isochrones/interp.py:208-392`` (interp_value(s)_{2,3,4}d)
* ``/root/reference/isochrones/interp.py:404-485`` (find_closest3)
* ``/root/reference/isochrones/interp.py:488-568`` (interp_eep(s))
* ``/root/reference/isochrones/mags.py:8-124``     (interp_mag(s))
* ``/root/reference/isochrones/likelihood.py:10-147`` (gauss_lnprob, star_lnlike)
* ``/root/reference/isochrones/utils.py:67-114``   (fast_addmags, trapz, polyval)
* ``/root/reference/isochrones/eep.py:5-48``       (eep_fn, eep_jac)
* ``/root/reference/isochrones/priors.py:469-480`` (powerlaw pdf/lnpdf)
* ``/root/reference/isochrones/cluster_utils.py:9-128`` (calc_lnlike_grid,
  integrate_over_eeps) — a second, independent loop oracle also lives in
  ``tests/test_cluster.py``.

Deliberate, documented carve-outs where the reference invokes undefined
behavior (numba reads past the end of an array):

1. **Exact top-knot queries** (interp.py:77-82 + corner offset +1): the upper
   corner index equals ``n`` — OOB. Its lerp weight is exactly 0, so the
   reference *usually* returns the clamped grid value by accident. The oracle
   clamps the index explicitly (weight-0 corner contributes 0), which matches
   ``isochrones_tpu.ops.interp`` (see its module docstring, "top-knot
   deviation").
2. **interp_eep at the exact top feh knot** (interp.py:515-518): row index
   ``(i0+1)*n1`` walks off the padded track matrix (UB). The oracle clamps
   the +1 neighbor *per dimension* (blend weight is 0), matching
   ``ops/eep.py``. Relatedly, at the exact top *mass* knot the reference's
   flattened ``i0*n1 + (i1+1)`` lands in-bounds but on the *next feh row's
   first mass* — weight-0, yet its track length can leak through the
   end-of-track substitution chain. The rebuild (and this oracle) clamp to
   the same-row top mass instead; parity tests avoid exact top-mass knots
   combined with past-end ages.

Everything here is float64 scalar-loop numpy — slow on purpose, simple on
purpose.
"""

from __future__ import annotations

import math

import numpy as np

# ---------------------------------------------------------------------------
# interp.py:10-35 — bisection search returning (insertion_index, exact_match)
# ---------------------------------------------------------------------------


def ref_searchsorted(arr, x, N=-1):
    if N == -1:
        N = len(arr)
    L = 0
    R = N - 1
    eq = False
    m = (L + R) // 2
    while True:
        xm = arr[m]
        if xm < x:
            L = m + 1
        elif xm > x:
            R = m - 1
        else:  # xm == x
            L = m
            eq = True
            break
        m = (L + R) // 2
        if L > R:
            break
    return L, eq


# ---------------------------------------------------------------------------
# interp.py:64-205 — find_indices_{2,3,4}d, generalized over ndim (the three
# reference bodies are identical modulo arity)
# ---------------------------------------------------------------------------


def ref_find_indices(point, knots):
    ndim = len(point)
    indices = np.zeros(ndim, dtype=np.int64)
    norm = np.zeros(ndim, dtype=np.float64)
    for d in range(ndim):
        ii = knots[d]
        n = len(ii)
        x = point[d]
        if x < ii[0] or x > ii[n - 1]:
            return indices, norm, True  # out of bounds (interp.py:72,106,157)
        ix, eq = ref_searchsorted(ii, x)
        if eq:
            indices[d] = ix
            norm[d] = 0.0
        else:
            indices[d] = ix - 1
            c0 = ii[ix - 1]
            norm[d] = (x - c0) / (ii[ix] - c0)
    return indices, norm, False


# ---------------------------------------------------------------------------
# interp.py:208-338 — interp_value_{2,3,4}d generalized over ndim
# ---------------------------------------------------------------------------


def ref_interp_value(point, grid, icols, knots):
    ndim = len(knots)
    icols = list(icols)
    for x in point:
        if x != x:  # NaN in -> NaN out (interp.py:210,254,298)
            return np.full(len(icols), np.nan)

    indices, norm, oob = ref_find_indices(point, knots)
    if oob:
        return np.full(len(icols), np.nan)

    n_edges = 2 ** ndim
    values = np.zeros(len(icols), dtype=np.float64)
    for i in range(n_edges):
        weight = 1.0
        edge = []
        for j in range(ndim):
            o = (i >> (ndim - 1 - j)) & 1  # corner enumeration, interp.py:225
            ei = indices[j] + o
            weight *= norm[j] if o else (1.0 - norm[j])
            # carve-out #1: clamp the (weight-0) OOB corner at an exact
            # top-knot match instead of reading past the grid
            edge.append(min(ei, grid.shape[j] - 1))
        for c, icol in enumerate(icols):
            values[c] += grid[tuple(edge) + (icol,)] * weight
    return values


def ref_interp_values(points, grid, icols, knots):
    """interp.py:341-392 — serial loop over points."""
    out = np.empty((len(points), len(icols)), dtype=np.float64)
    for i, p in enumerate(points):
        out[i] = ref_interp_value(p, grid, icols, knots)
    return out


# ---------------------------------------------------------------------------
# interp.py:395-485 — sign + find_closest3 (bisect seed + Newton-secant)
# ---------------------------------------------------------------------------


def _sign(x):
    return -1 if x < 0 else 1


def ref_find_closest3(val, a, b, v1, v2, grid, icol, knots, bisect_tol=0.5, newton_tol=0.01, max_iter=100):
    def f(x):
        return ref_interp_value((v1, v2, x), grid, [icol], knots)[0] - val

    ya = f(a)
    yb = f(b)
    if ya != ya or yb != yb:
        return np.nan
    if abs(ya) < newton_tol:
        return float(a)
    if abs(yb) < newton_tol:
        return float(b)
    if ya > 0 and yb > 0:
        return np.nan
    if ya < 0 and yb < 0:
        return np.nan

    while True:
        c = (a + b) / 2
        yc = f(c)
        done = yc == 0 or (b - a) / 2 < bisect_tol
        if _sign(yc) == _sign(ya):
            a, ya = c, yc
        else:
            b, yb = c, yc
        if done:
            break

    tol = 1000.0
    i = 0
    x0, y0 = c, yc
    x1 = x0 + 0.1
    y1 = f(x1)
    while tol > newton_tol and i < max_iter:
        newx = (x0 * y1 - x1 * y0) / (y1 - y0)
        x0, y0 = x1, y1
        x1 = newx
        y1 = f(x1)
        if y1 != y1:
            return np.nan  # reference raises here (interp.py:472-475)
        tol = y1 if y1 >= 0 else -y1
        i += 1
    return x1


# ---------------------------------------------------------------------------
# interp.py:488-568 — interp_eep(s): ragged-track (age, feh, mass) -> EEP
# ---------------------------------------------------------------------------


def ref_interp_eep(x, x0, x1, ii0, ii1, n1, arrays, weight_arrays, lengths):
    if x != x or x0 != x0 or x1 != x1:
        return np.nan

    (i0, i1), (d0, d1), oob = ref_find_indices((x0, x1), (ii0, ii1))
    if oob:
        return np.nan

    n0 = len(ii0)
    # carve-out #2: clamp the +1 neighbors per dimension at exact top knots
    # (blend weight 0; the reference reads past the matrix / wraps rows)
    i0p = min(i0 + 1, n0 - 1)
    i1p = min(i1 + 1, n1 - 1)
    ind_00 = i0 * n1 + i1
    ind_01 = i0 * n1 + i1p
    ind_10 = i0p * n1 + i1
    ind_11 = i0p * n1 + i1p

    i_eep_00, _ = ref_searchsorted(arrays[ind_00, :], x, N=lengths[ind_00])
    i_eep_01, _ = ref_searchsorted(arrays[ind_01, :], x, N=lengths[ind_01])
    i_eep_10, _ = ref_searchsorted(arrays[ind_10, :], x, N=lengths[ind_10])
    i_eep_11, _ = ref_searchsorted(arrays[ind_11, :], x, N=lengths[ind_11])

    max_i_eep = weight_arrays.shape[1] - 1
    if (i_eep_00 > max_i_eep) or (i_eep_01 > max_i_eep) or (i_eep_10 > max_i_eep) or (i_eep_11 > max_i_eep):
        return np.nan

    eep_00 = i_eep_00 + 1
    eep_01 = i_eep_01 + 1
    eep_10 = i_eep_10 + 1
    eep_11 = i_eep_11 + 1

    # end-of-track neighbor substitution, in the reference's exact order
    # (interp.py:540-551); note 01 may pick up an already-substituted 00
    if i_eep_00 >= lengths[ind_00]:
        eep_00 = eep_01
    if i_eep_01 >= lengths[ind_01]:
        eep_01 = eep_00
    if i_eep_10 >= lengths[ind_10]:
        eep_10 = eep_11
    if i_eep_11 >= lengths[ind_11]:
        eep_11 = eep_10

    eep_0 = (1 - d1) * eep_00 + d1 * eep_01
    eep_1 = (1 - d1) * eep_10 + d1 * eep_11
    return (1 - d0) * eep_0 + d0 * eep_1


def ref_interp_eeps(xs, x0s, x1s, ii0, ii1, n1, arrays, weight_arrays, lengths):
    return np.array(
        [ref_interp_eep(x, x0, x1, ii0, ii1, n1, arrays, weight_arrays, lengths) for x, x0, x1 in zip(xs, x0s, x1s)]
    )


# ---------------------------------------------------------------------------
# mags.py:8-124 — interp_mag(s): model-grid 3d interp -> BC 4d interp -> mags
# ---------------------------------------------------------------------------


def ref_interp_mag(pars, index_order, model_grid, model_icols, model_knots, bc_grid, bc_cols, bc_knots):
    """model_icols = (i_Teff, i_logg, i_feh, i_Mbol)."""
    p0 = pars[index_order[0]]
    p1 = pars[index_order[1]]
    p2 = pars[index_order[2]]
    star_props = ref_interp_value((p0, p1, p2), model_grid, list(model_icols), model_knots)
    Teff, logg, feh, mBol = star_props
    AV = pars[index_order[4]]
    bc = ref_interp_value((Teff, logg, feh, AV), bc_grid, list(bc_cols), bc_knots)
    dist_mod = 5 * math.log10(pars[index_order[3]] / 10.0)
    mags = np.array([mBol + dist_mod - bc[i] for i in range(len(bc_cols))])
    return Teff, logg, feh, mags


def ref_interp_mags(pars, index_order, model_grid, model_icols, model_knots, bc_grid, bc_cols, bc_knots):
    """pars is (n_pars, n_values) — column-major points as in mags.py:64-124."""
    n_values = pars.shape[1]
    n_bands = len(bc_cols)
    Teffs = np.empty(n_values)
    loggs = np.empty(n_values)
    fehs = np.empty(n_values)
    mags = np.empty((n_values, n_bands))
    for i in range(n_values):
        t, g, f, m = ref_interp_mag(
            pars[:, i], index_order, model_grid, model_icols, model_knots, bc_grid, bc_cols, bc_knots
        )
        Teffs[i], loggs[i], fehs[i] = t, g, f
        mags[i] = m
    return Teffs, loggs, fehs, mags


# ---------------------------------------------------------------------------
# utils.py:67-114 — fast_addmags, trapz, polyval
# ---------------------------------------------------------------------------


def ref_fast_addmags(mags):
    tot = 0.0
    for mag in mags:
        tot += 10 ** (-0.4 * mag)
    return -2.5 * math.log10(tot)


def ref_trapz(y, x):
    tot = 0.0
    for i in range(len(y) - 1):
        tot += 0.5 * (y[i] + y[i + 1]) * (x[i + 1] - x[i])
    return tot


def ref_polyval(p, x):
    N = len(p)
    result = 0.0
    for i in range(N):
        result += p[i] * x ** (N - 1 - i)
    return result


# ---------------------------------------------------------------------------
# likelihood.py:10-147 — gauss_lnprob, star_lnlike
# ---------------------------------------------------------------------------

LOG_ONE_OVER_ROOT_2PI = math.log(1.0 / math.sqrt(2 * math.pi))


def ref_gauss_lnprob(val, unc, model_val):
    resid = val - model_val
    return LOG_ONE_OVER_ROOT_2PI + math.log(unc) - 0.5 * resid * resid / (unc * unc)


def ref_star_lnlike(
    pars,
    index_order,
    spec_vals,
    spec_uncs,
    mag_vals,
    mag_uncs,
    i_mags,
    model_grid,
    model_icols,
    model_knots,
    bc_grid,
    bc_knots,
):
    n_pars = len(pars)
    has_binary = n_pars >= 6
    has_triple = n_pars == 7
    if n_pars == 5:
        single_pars = [pars[0], pars[1], pars[2], pars[3], pars[4]]
    elif n_pars == 6:
        single_pars = [pars[0], pars[2], pars[3], pars[4], pars[5]]
        binary_pars = [pars[1], pars[2], pars[3], pars[4], pars[5]]
    elif n_pars == 7:
        single_pars = [pars[0], pars[3], pars[4], pars[5], pars[6]]
        binary_pars = [pars[1], pars[3], pars[4], pars[5], pars[6]]
        triple_pars = [pars[2], pars[3], pars[4], pars[5], pars[6]]

    Teff, logg, feh, mags = ref_interp_mag(
        single_pars, index_order, model_grid, model_icols, model_knots, bc_grid, i_mags, bc_knots
    )
    if has_binary:
        _, _, _, mags_binary = ref_interp_mag(
            binary_pars, index_order, model_grid, model_icols, model_knots, bc_grid, i_mags, bc_knots
        )
    if has_triple:
        _, _, _, mags_triple = ref_interp_mag(
            triple_pars, index_order, model_grid, model_icols, model_knots, bc_grid, i_mags, bc_knots
        )

    mags = np.array(mags, dtype=float)
    if n_pars == 6:
        for i in range(len(mags)):
            mags[i] = ref_fast_addmags([mags[i], mags_binary[i]])
    elif n_pars == 7:
        for i in range(len(mags)):
            mags[i] = ref_fast_addmags([mags[i], mags_binary[i], mags_triple[i]])

    lnlike = 0.0
    for k, model_val in enumerate((Teff, logg, feh)):
        val = spec_vals[k]
        unc = spec_uncs[k]
        if val == val:  # skip NaN
            lnlike += ref_gauss_lnprob(val, unc, model_val)
    for i in range(len(mag_vals)):
        lnlike += ref_gauss_lnprob(mag_vals[i], mag_uncs[i], mags[i])
    return lnlike


# ---------------------------------------------------------------------------
# eep.py:5-48 — eep_fn, eep_jac
# ---------------------------------------------------------------------------


def ref_eep_fn(x, p5, p4, p3, p2, p1, p0, A, x0, tau, order=5):
    if order < 5:
        p5 = 0
        if order < 4:
            p4 = 0
            if order < 3:
                p3 = 0
                if order < 2:
                    p2 = 0
    return p5 * x ** 5 + p4 * x ** 4 + p3 * x ** 3 + p2 * x ** 2 + p1 * x + p0 + A * np.exp((x - x0) / tau)


def ref_eep_jac(x, p5, p4, p3, p2, p1, p0, A, x0, tau, order=5):
    n = len(x)
    out = np.empty((n, 9))
    for i in range(n):
        xi = x[i]
        e = np.exp((xi - x0) / tau)
        out[i] = [xi ** 5, xi ** 4, xi ** 3, xi ** 2, xi, 0.0, e, -1.0 / tau * A * e, -1.0 / tau ** 2 * (xi - x0) * A * e]
    return out


# ---------------------------------------------------------------------------
# priors.py:469-480 — powerlaw pdf/lnpdf
# ---------------------------------------------------------------------------


def ref_powerlaw_pdf(x, alpha, lo, hi):
    a1 = alpha + 1
    C = a1 / (hi ** a1 - lo ** a1)
    return C * x ** alpha


def ref_powerlaw_lnpdf(x, alpha, lo, hi):
    a1 = alpha + 1
    C = a1 / (hi ** a1 - lo ** a1)
    return math.log(C) + alpha * math.log(x)


# ---------------------------------------------------------------------------
# cluster_utils.py:9-128 — logaddexp/logsumexp/calc_lnlike_grid/integrate
# (a second independent loop oracle also lives in tests/test_cluster.py)
# ---------------------------------------------------------------------------


def ref_logaddexp(x1, x2):
    xmax = max(x1, x2)
    return xmax + math.log(math.exp(x1 - xmax) + math.exp(x2 - xmax))


def ref_calc_lnlike_grid(
    lnlike_prop, model_mags, Nbands, masses, ln_dm_deeps, eeps, mag_values, mag_uncs,
    alpha, gamma, fB, mass_lo, mass_hi, q_lo,
):
    n = len(model_mags)
    n_stars = len(mag_values)
    lnlikes = np.zeros((n_stars, n, n))
    for i in range(n_stars):
        for j in range(n):
            for k in range(j + 1):
                if masses[k] / masses[j] < q_lo:
                    lnlikes[i, j, k] = -np.inf
                    continue
                lnlike_phot = 0.0
                for b in range(Nbands):
                    f1 = 10 ** (-0.4 * model_mags[j, b])
                    f2 = 10 ** (-0.4 * model_mags[k, b])
                    mag_value = mag_values[i, b]
                    mag_unc = mag_uncs[i, b]
                    tot_mag_binary = -2.5 * math.log10(f1 + f2)
                    resid_binary = tot_mag_binary - mag_value
                    lnlike_phot_binary = -0.5 * resid_binary ** 2 / mag_unc ** 2
                    resid_single = model_mags[j, b] - mag_value
                    lnlike_phot_single = -0.5 * resid_single ** 2 / mag_unc ** 2
                    lnlike_phot += ref_logaddexp(
                        math.log(fB) + lnlike_phot_binary, math.log(1 - fB) + lnlike_phot_single
                    )
                lnlike_mass = ref_powerlaw_lnpdf(masses[j], alpha, mass_lo, mass_hi) + ln_dm_deeps[j]
                lnlike_q = ref_powerlaw_lnpdf(masses[k] / masses[j], gamma, q_lo, 1.0)
                lnlikes[i, j, k] = lnlike_phot + lnlike_mass + lnlike_q + lnlike_prop[i, j]
    return lnlikes


def ref_integrate_over_eeps(lnlike_grid, eeps, Nstars):
    out = np.zeros(Nstars)
    n = len(eeps)
    for i in range(Nstars):
        row = np.zeros(n)
        for j in range(n):
            tot = 0.0
            for k in range(j):
                tot += 0.5 * (math.exp(lnlike_grid[i, j, k]) + math.exp(lnlike_grid[i, j, k + 1])) * (
                    eeps[k + 1] - eeps[k]
                )
            row[j] = tot
        out[i] = ref_trapz(row, eeps)
    return out
