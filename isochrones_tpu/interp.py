"""Reference-named interpolation API (compat layer).

Drop-in equivalents for the public names of the reference's numba kernel
module (``isochrones/interp.py``), so code written against the reference
imports unchanged::

    from isochrones_tpu.interp import DFInterpolator, interp_value_3d

These are host-convenience wrappers: the scalar index utilities run in
plain numpy; the value/EEP interpolators delegate to the batched device
kernels in :mod:`isochrones_tpu.ops` (``interp_nd``, ``interp_eep``,
``find_closest_grid``), which are the jittable compute path. Semantics
match the reference (cell location, NaN/OOB handling, end-of-track
neighbor substitution) as pinned by ``tests/test_oracle_parity.py``;
the one documented deviation is exact top-knot queries (clamped here,
out-of-bounds-read UB in the reference).
"""

from __future__ import annotations

import numpy as np

from .ops.interp import (  # noqa: F401  (re-exported)
    GridData,
    GridInterpolator,
    compute_axis_maps,
    interp_nd,
)

__all__ = [
    "DFInterpolator",
    "searchsorted",
    "find_indices",
    "find_indices_2d",
    "find_indices_3d",
    "find_indices_4d",
    "interp_value_2d",
    "interp_value_3d",
    "interp_value_4d",
    "interp_values_2d",
    "interp_values_3d",
    "interp_values_4d",
    "sign",
    "find_closest3",
    "interp_eep",
    "interp_eeps",
]

#: The reference's ``DFInterpolator`` (interp.py:571-698) is the same
#: object as :class:`~isochrones_tpu.ops.interp.GridInterpolator` here —
#: constructed from a MultiIndex DataFrame, densifies to a NaN-padded
#: grid, callable with ``(p, cols)``.
DFInterpolator = GridInterpolator


def searchsorted(arr, x, N=-1):
    """Binary search returning ``(index, exact_match)``
    (reference interp.py:10-36)."""
    arr = np.asarray(arr)
    if N == -1:
        N = len(arr)
    L = int(np.searchsorted(arr[:N], x, side="left"))
    eq = bool(L < N and arr[L] == x)
    return L, eq


def _find_indices_nd(xs, iis):
    # zero-initialized like the reference's variants, so out-of-bounds
    # dimensions report (0, 0.0) rather than uninitialized memory
    ndim = len(xs)
    indices = np.zeros(ndim, dtype=np.uint32)
    norm = np.zeros(ndim, dtype=np.float64)
    oob = False
    for i, (x, ii) in enumerate(zip(xs, iis)):
        ii = np.asarray(ii, dtype=float)
        if x < ii[0] or x > ii[-1]:
            oob = True
            continue
        ix, eq = searchsorted(ii, x)
        if eq:
            indices[i] = ix
            norm[i] = 0.0
        else:
            indices[i] = ix - 1
            c0 = ii[ix - 1]
            norm[i] = (x - c0) / (ii[ix] - c0)
    return indices, norm, oob


def find_indices(point, iis):
    """Cell indices + normalized distances for one N-d point (reference
    interp.py:38-61; its out-of-bounds flag is computed correctly here —
    the reference's ``&=`` accumulator can never become True)."""
    return _find_indices_nd(list(point), list(iis))


def find_indices_2d(x0, x1, ii0, ii1):
    """reference interp.py:63-94"""
    return _find_indices_nd((x0, x1), (ii0, ii1))


def find_indices_3d(x0, x1, x2, ii0, ii1, ii2):
    """reference interp.py:96-144"""
    return _find_indices_nd((x0, x1, x2), (ii0, ii1, ii2))


def find_indices_4d(x0, x1, x2, x3, ii0, ii1, ii2, ii3):
    """reference interp.py:146-205"""
    return _find_indices_nd((x0, x1, x2, x3), (ii0, ii1, ii2, ii3))


def _interp_values(xs, grid, icols, iis):
    import jax.numpy as jnp

    grid = np.asarray(grid, dtype=float)
    knots = tuple(np.asarray(ii, dtype=float) for ii in iis)
    bcast = np.broadcast(*xs)
    pts = np.stack(
        # broadcast_to, NOT resize: resize fills cyclically, silently wrong
        # for genuinely 2-d broadcast shapes like (3,1) x (1,4) (ADVICE r2)
        [np.broadcast_to(np.asarray(x, dtype=float), bcast.shape).ravel() for x in xs],
        axis=-1,
    )
    out = interp_nd(
        jnp.asarray(grid),
        tuple(jnp.asarray(k) for k in knots),
        jnp.asarray(pts),
        icols=tuple(int(i) for i in np.atleast_1d(icols)),
        axis_maps=compute_axis_maps(knots),
    )
    return np.asarray(out)


def interp_value_2d(x0, x1, grid, icols, ii0, ii1):
    """reference interp.py:208-250"""
    return _interp_values((x0, x1), grid, icols, (ii0, ii1))[0]


def interp_value_3d(x0, x1, x2, grid, icols, ii0, ii1, ii2):
    """reference interp.py:252-294"""
    return _interp_values((x0, x1, x2), grid, icols, (ii0, ii1, ii2))[0]


def interp_value_4d(x0, x1, x2, x3, grid, icols, ii0, ii1, ii2, ii3):
    """reference interp.py:296-339"""
    return _interp_values((x0, x1, x2, x3), grid, icols, (ii0, ii1, ii2, ii3))[0]


def interp_values_2d(xx0, xx1, grid, icols, ii0, ii1):
    """reference interp.py:341-357"""
    return _interp_values((xx0, xx1), grid, icols, (ii0, ii1))


def interp_values_3d(xx0, xx1, xx2, grid, icols, ii0, ii1, ii2):
    """reference interp.py:359-376"""
    return _interp_values((xx0, xx1, xx2), grid, icols, (ii0, ii1, ii2))


def interp_values_4d(xx0, xx1, xx2, xx3, grid, icols, ii0, ii1, ii2, ii3):
    """reference interp.py:378-393"""
    return _interp_values((xx0, xx1, xx2, xx3), grid, icols, (ii0, ii1, ii2, ii3))


def sign(x):
    """reference interp.py:395-401 (note: sign(0) == 1 there, matched)."""
    return -1 if x < 0 else 1


def find_closest3(val, lo, hi, v1, v2, grid, icol, ii0, ii1, ii2, debug=False):
    """Root-find along the third grid axis (reference interp.py:404-485),
    via the capped bisect+secant kernel in :mod:`isochrones_tpu.ops.rootfind`."""
    import jax.numpy as jnp

    from .ops.rootfind import find_closest_grid

    knots = tuple(jnp.asarray(np.asarray(ii, dtype=float)) for ii in (ii0, ii1, ii2))
    gd = GridData(
        values=jnp.asarray(np.asarray(grid, dtype=float)),
        knots=knots,
        columns=tuple(str(i) for i in range(np.asarray(grid).shape[-1])),
        axis_maps=compute_axis_maps([np.asarray(k) for k in knots]),
    )
    return float(find_closest_grid(gd, val, lo, hi, v1, v2, int(icol)))


def interp_eep(x, x0, x1, ii0, ii1, n1, arrays, weight_arrays, lengths):
    """Fast (age, feh, mass) -> EEP inversion for one point (reference
    interp.py:502-558). ``weight_arrays`` is accepted for signature parity;
    the reference computes weights from it but never uses them in the
    returned blend (interp.py:546-556)."""
    return float(interp_eeps([x], [x0], [x1], ii0, ii1, n1, arrays, weight_arrays, lengths)[0])


def interp_eeps(xs, x0s, x1s, ii0, ii1, n1, arrays, weight_arrays, lengths):
    """Batched fast EEP inversion (reference interp.py:488-500)."""
    import jax.numpy as jnp

    from .ops.eep import interp_eep as _interp_eep_batch

    del n1, weight_arrays  # shape-derived / unused (see interp_eep docstring)
    out = _interp_eep_batch(
        jnp.asarray(np.asarray(xs, dtype=float)),
        jnp.asarray(np.asarray(x0s, dtype=float)),
        jnp.asarray(np.asarray(x1s, dtype=float)),
        jnp.asarray(np.asarray(ii0, dtype=float)),
        jnp.asarray(np.asarray(ii1, dtype=float)),
        jnp.asarray(np.asarray(arrays, dtype=float)),
        jnp.asarray(np.asarray(lengths)),
        eep0=1.0,
    )
    return np.asarray(out)
