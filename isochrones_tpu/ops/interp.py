"""Accelerator-native N-dimensional regular-grid multilinear interpolation.

This is the rebuild of the reference's Numba kernel layer
(``isochrones/interp.py:10-392``: ``searchsorted``, ``find_indices_{2,3,4}d``,
``interp_value(s)_{2,3,4}d``) as batched, jit/vmap-friendly XLA code:

* One generic N-d implementation instead of per-ndim specializations — JAX
  traces static ``ndim``, so the 2**ndim corner fan-out unrolls at compile
  time and XLA fuses the gathers + lerp into a single HBM-bound kernel.
* Batch-first layout: ``points`` has shape ``(..., ndim)`` and all leading
  axes are vectorized on-device (the reference loops serially in
  ``interp_values_*``, interp.py:341-392).
* Semantics match the reference exactly:
  - NaN in any coordinate -> NaN row out (interp.py:210,254,298).
  - Out of bounds (x < knots[0] or x > knots[-1]) -> NaN row (interp.py:72,106,157).
  - Exact knot match -> cell = match index with weight 0 on the upper corner
    (interp.py:77-82). IEEE ``0 * NaN = NaN`` propagation of NaN-padded
    neighbors is preserved; the one divergence is at the *top* knot, where the
    reference reads out-of-bounds memory with weight 0 (numba UB) — here the
    upper corner is clamped, which returns the exact grid value instead.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

__all__ = [
    "GridData",
    "compute_axis_maps",
    "find_cells_1d",
    "interp_nd",
    "corner_data",
    "pair_innermost_columns",
    "GridInterpolator",
    "REFERENCE_DEVIATIONS",
]

#: Machine-readable registry of intentional semantic deviations from the
#: reference implementation. Golden-value / parity harnesses should consult
#: this before comparing outputs point-by-point (tests/reference_oracle.py and
#: tests/test_realdata.py carry the corresponding carve-outs).
REFERENCE_DEVIATIONS = {
    "top_knot_clamp": {
        "where": "interp_nd exact top-knot queries",
        "reference": "isochrones/interp.py:77-82 — numba kernel reads one row "
                     "past the axis end with weight 0 (undefined behavior; in "
                     "practice returns garbage*0 or poisons with NaN)",
        "here": "upper corner index clamped to the last knot; an exact "
                "top-knot query returns the exact grid value",
        "impact": "only queries with a coordinate exactly equal to the LAST "
                  "knot of any axis differ; interior and OOB semantics match "
                  "bit-for-bit",
    },
}

#: precision of the corner-weight contractions. Pinned to full float32:
#: under the default, a GPU may run a float32 contraction in TF32 (~3
#: decimal digits), i.e. ~5 mmag at magnitude 10 — the size of the
#: photometric errors the fits use.
LERP_PRECISION = lax.Precision.HIGHEST


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class GridData:
    """Device-resident dense rectilinear grid: ``values[(i0..ik), c]`` + axis knots.

    The device-resident equivalent of the reference's ``DFInterpolator`` state
    (``interp.py:571-614``): ``values`` is the NaN-padded dense array, ``knots``
    are the sorted axis coordinate arrays, ``columns`` the value-column names.
    Registered as a pytree so it can be passed through ``jit``/``pjit``
    boundaries and sharded with ``jax.sharding``.
    """

    values: jnp.ndarray  # (n0, ..., nk, ncols)
    knots: Tuple[jnp.ndarray, ...]  # len k+1, each (n_i,)
    columns: Tuple[str, ...] = ()
    # Optional host-side numpy mirror of ``values`` for metadata queries
    # (column limits etc.). NOT part of the pytree — grid builders stash the
    # numpy array they already have, so no metadata query reads the full
    # grid back from the device. Dropped (None) after
    # a jit flatten/unflatten roundtrip, which only loses the cache.
    host_values: Optional[np.ndarray] = dataclasses.field(
        default=None, compare=False, repr=False
    )
    # Static per-axis analytic index maps: ("affine", lo, step) or
    # ("log", log_lo, log_step) or None (general searchsorted). Knot search
    # via jnp.searchsorted is a sequential scan, while uniform/log-uniform axes (EEP,
    # feh, age ladders) reduce to one multiply+floor. Computed from host
    # knots at construction (see :func:`compute_axis_maps`).
    axis_maps: Optional[Tuple] = None
    # ``values`` was packed by :func:`pair_innermost_columns` (innermost
    # axis has n_k - 1 rows, columns doubled): interp consumers must pass
    # ``paired=True`` to :func:`interp_nd`. ``columns`` keeps the LOGICAL
    # (undoubled) names.
    paired: bool = False

    def tree_flatten(self):
        return (self.values, self.knots), (self.columns, self.axis_maps, self.paired)

    @classmethod
    def tree_unflatten(cls, aux, children):
        values, knots = children
        return cls(values=values, knots=knots, columns=aux[0], axis_maps=aux[1],
                   paired=aux[2] if len(aux) > 2 else False)

    @property
    def ndim_grid(self) -> int:
        return len(self.knots)

    @property
    def n_columns(self) -> int:
        return self.values.shape[-1] // 2 if self.paired else self.values.shape[-1]

    @property
    def column_index(self):
        return {c: i for i, c in enumerate(self.columns)}

    def icols(self, cols) -> Tuple[int, ...]:
        if cols is None or cols == "all":
            return tuple(range(self.n_columns))
        ci = self.column_index
        return tuple(ci[c] if isinstance(c, str) else int(c) for c in cols)

    def astype(self, dtype) -> "GridData":
        return GridData(
            values=self.values.astype(dtype),
            knots=tuple(k.astype(dtype) for k in self.knots),
            columns=self.columns,
            host_values=None if self.host_values is None else self.host_values.astype(dtype),
            axis_maps=self.axis_maps,
            paired=self.paired,
        )


def compute_axis_maps(knots, rtol=1e-5) -> Tuple:
    """Detect per-axis analytic index maps from host-side knot arrays.

    Returns a static tuple with one entry per axis: ``("affine", lo, step)``
    for uniform knots, ``("log", log_lo, log_step)`` for log-uniform knots,
    or ``None`` (fall back to searchsorted)."""
    maps = []
    for k in knots:
        k = np.asarray(k, dtype=float)
        if len(k) < 3:
            maps.append(None)
            continue
        d = np.diff(k)
        if np.allclose(d, d[0], rtol=rtol, atol=0.0) and d[0] > 0:
            step = float(d[0])
            lo0 = float(k[0])
            # bit-exact ladder (e.g. the integer EEP axis): gather-free path
            exact32 = np.array_equal(
                k.astype(np.float32),
                (np.float32(lo0) + np.arange(len(k), dtype=np.float32) * np.float32(step)),
            )
            exact64 = np.array_equal(k, lo0 + np.arange(len(k)) * step)
            if exact32 and exact64:
                maps.append(("exact_affine", lo0, step))
            else:
                maps.append(("affine", lo0, step))
            continue
        if (k > 0).all():
            ld = np.diff(np.log(k))
            if np.allclose(ld, ld[0], rtol=rtol, atol=0.0) and ld[0] > 0:
                maps.append(("log", float(np.log(k[0])), float(ld[0])))
                continue
        if len(k) <= 256 and (np.diff(k) > 0).all():
            # small irregular axis (BC Teff ladder, real-MIST mass ladder):
            # one vectorized broadcast compare beats the searchsorted scan
            maps.append(("compare", 0.0, 0.0))
            continue
        maps.append(None)
    return tuple(maps)


def find_cells_1d(knots: jnp.ndarray, x: jnp.ndarray, axis_map=None):
    """Locate each ``x`` in sorted ``knots``.

    Returns ``(cell, t, oob)`` where ``cell`` is the lower cell index,
    ``t`` the normalized in-cell coordinate (0 at an exact knot match —
    mirroring interp.py:77-82), and ``oob`` the out-of-bounds flag
    (interp.py:72: strictly ``x < knots[0] or x > knots[-1]``).

    ``axis_map`` (static, from :func:`compute_axis_maps`) selects an O(1)
    analytic index computation for uniform/log-uniform axes instead of a
    searchsorted scan.
    """
    n = knots.shape[0]
    oob = (x < knots[0]) | (x > knots[-1])

    if axis_map is not None and n > 1:
        kind, lo0, step = axis_map

        def _pin_top(cell, t):
            # Exact top-knot queries must behave like the searchsorted path
            # (cell = n-1, t = 0, both corners clamped onto the top row) —
            # otherwise the weight-0 LOWER corner of the last cell can poison
            # the lerp with 0 * NaN. Caught by tests/test_oracle_parity.py.
            top = x == knots[-1]
            cell = jnp.where(top, n - 1, cell)
            t = jnp.where(top, jnp.zeros_like(t), t)
            return cell, t

        if kind == "exact_affine":
            # knots are BIT-exactly lo0 + i*step (verified at build time):
            # fully gather-free. floor() may land one cell low near a knot
            # (division rounding), giving t ~= 1.0 instead of 0.0 — the lerp
            # endpoints are bit-exact either way, so values are identical.
            raw = (x - lo0) / step
            cell = jnp.clip(jnp.floor(raw).astype(jnp.int32), 0, n - 2)
            lo = lo0 + cell.astype(x.dtype) * step
            t = (x - lo) / step
            # one arithmetic fix-up (no gathers): keep t in [0, 1)
            shift_up = t >= 1.0
            shift_dn = t < 0.0
            cell = jnp.clip(cell + shift_up.astype(jnp.int32) - shift_dn.astype(jnp.int32), 0, n - 2)
            lo = lo0 + cell.astype(x.dtype) * step
            t = (x - lo) / step
            cell, t = _pin_top(cell, t)
            return cell, t, oob
        if kind == "compare":
            # small irregular axis: one vectorized (B, n) broadcast compare
            # replaces the sequential searchsorted scan
            cell = jnp.sum(x[..., None] >= knots, axis=-1).astype(jnp.int32) - 1
            cell = jnp.clip(cell, 0, n - 2)
            lo = knots[cell]
            hi = knots[cell + 1]
            denom = hi - lo
            t = (x - lo) / jnp.where(denom == 0, jnp.ones_like(denom), denom)
            cell, t = _pin_top(cell, t)
            return cell, t, oob
        xs = jnp.log(jnp.maximum(x, 1e-300)) if kind == "log" else x
        raw = (xs - lo0) / step
        cell = jnp.clip(jnp.floor(raw).astype(jnp.int32), 0, n - 2)
        # two-step fix-up against the true knots absorbs fp rounding in raw
        cell = jnp.where(x < knots[cell], cell - 1, cell)
        cell = jnp.clip(cell, 0, n - 2)
        cell = jnp.where(x >= knots[jnp.clip(cell + 1, 0, n - 1)], cell + 1, cell)
        cell = jnp.clip(cell, 0, n - 2)
        lo = knots[cell]
        hi = knots[cell + 1]
        denom = hi - lo
        t = (x - lo) / jnp.where(denom == 0, jnp.ones_like(denom), denom)
        # exact-knot semantics of the searchsorted path: t == 0 at a match
        # (x == lo gives t = 0 exactly); exact top knot pinned to
        # (n-1, t=0) so the last cell's NaN lower corner can't poison it.
        cell, t = _pin_top(cell, t)
        return cell, t, oob

    i_ins = jnp.searchsorted(knots, x, side="left")
    i_safe = jnp.clip(i_ins, 0, n - 1)
    eq = knots[i_safe] == x
    cell = jnp.where(eq, i_safe, i_ins - 1)
    cell_safe = jnp.clip(cell, 0, n - 2) if n > 1 else jnp.zeros_like(cell)
    lo = knots[cell_safe]
    hi = knots[jnp.clip(cell_safe + 1, 0, n - 1)]
    denom = hi - lo
    t_lerp = (x - lo) / jnp.where(denom == 0, jnp.ones_like(denom), denom)
    t = jnp.where(eq, jnp.zeros_like(x), t_lerp)
    # exact top knot: keep cell = n-1, t = 0 (upper corner clamps to itself)
    cell = jnp.where(eq, cell, cell_safe)
    return cell, t, oob


def corner_data(
    values: jnp.ndarray,
    knots: Sequence[jnp.ndarray],
    points: jnp.ndarray,
    icols: Optional[Tuple[int, ...]] = None,
    axis_maps: Optional[Tuple] = None,
):
    """Gather the 2**ndim corner rows and lerp weights for a batch of points.

    values : (n0..nk, C); points : (B, ndim).
    Returns ``(corners (B, 2**ndim, n_icols), weights (B, 2**ndim), bad (B,))``.
    """
    ndim = len(knots)
    dims = values.shape[:-1]
    ncols = values.shape[-1]
    assert points.shape[-1] == ndim

    cells, ts, oobs = [], [], []
    for d in range(ndim):
        amap = axis_maps[d] if axis_maps is not None else None
        cell, t, oob = find_cells_1d(knots[d], points[..., d], axis_map=amap)
        cells.append(cell)
        ts.append(t)
        oobs.append(oob)

    nan_in = jnp.any(jnp.isnan(points), axis=-1)
    bad = nan_in
    for oob in oobs:
        bad = bad | oob

    # static corner offsets (2^ndim, ndim), bit j of corner i -> offset in dim j
    offsets = np.stack(
        [[(i >> (ndim - 1 - j)) & 1 for j in range(ndim)] for i in range(2 ** ndim)]
    )  # matches edge enumeration at interp.py:223-225

    strides = np.ones(ndim, dtype=np.int64)
    for d in range(ndim - 2, -1, -1):
        strides[d] = strides[d + 1] * dims[d + 1]

    flat_vals = values.reshape(-1, ncols)
    if icols is not None and tuple(icols) != tuple(range(ncols)):
        flat_vals = flat_vals[:, np.asarray(icols, dtype=np.int64)]

    dt = points.dtype
    corner_w = []
    corner_flat_idx = []
    for i in range(2 ** ndim):
        w = jnp.ones(points.shape[:-1], dtype=dt)
        idx = jnp.zeros(points.shape[:-1], dtype=jnp.int32)
        for d in range(ndim):
            o = int(offsets[i, d])
            w = w * (ts[d] if o else (1.0 - ts[d]))
            cd = jnp.clip(cells[d] + o, 0, dims[d] - 1)
            idx = idx + cd.astype(jnp.int32) * np.int32(strides[d])
        corner_w.append(w)
        corner_flat_idx.append(idx)

    weights = jnp.stack(corner_w, axis=-1)  # (B, 2^ndim)
    flat_idx = jnp.stack(corner_flat_idx, axis=-1)  # (B, 2^ndim)
    corners = jnp.take(flat_vals, flat_idx, axis=0)  # (B, 2^ndim, n_icols)
    return corners, weights, bad


def _interp_nd_block(values, knots, points, icols, axis_maps):
    """Block-gather interpolation path: ONE ``lax.gather`` fetches each
    point's full ``(2,)*ndim`` corner neighborhood (the corners are adjacent
    along the innermost axis, so the slice coalesces), then the lerp is a
    sequential per-dim contraction — replacing the ``2**ndim`` independent
    row-gathers of :func:`corner_data`. NOT the default anywhere; retained
    behind ``block=True`` / ISOTPU_INTERP_BLOCK=1 as a design point to
    measure.

    Semantics are IDENTICAL to the corner_data path, including IEEE
    ``0 * NaN`` poisoning by weight-0 neighbors at interior exact-knot
    matches, and the top-knot clamp (REFERENCE_DEVIATIONS): an exact
    top-knot hit in dim d SELECTS the upper block row instead of lerping,
    so the (possibly NaN) row below cannot poison it.
    """
    ndim = len(knots)
    dims = values.shape[:-1]
    ncols = values.shape[-1]

    cells, ts, tops = [], [], []
    bad = jnp.any(jnp.isnan(points), axis=-1)
    for d in range(ndim):
        amap = axis_maps[d] if axis_maps is not None else None
        cell, t, oob = find_cells_1d(knots[d], points[..., d], axis_map=amap)
        bad = bad | oob
        # exact-top pin returns cell = n-1 (both corners clamped); the block
        # starts one row lower and SELECTS its upper row in that dim
        tops.append(cell == dims[d] - 1)
        cells.append(jnp.clip(cell, 0, max(dims[d] - 2, 0)))
        ts.append(t)

    if icols is not None and tuple(icols) != tuple(range(ncols)):
        values = values[..., np.asarray(icols, dtype=np.int64)]
        ncols = len(icols)

    starts = jnp.stack(cells, axis=-1)  # (B, ndim)
    block = jax.lax.gather(
        values,
        starts,
        jax.lax.GatherDimensionNumbers(
            offset_dims=tuple(range(1, ndim + 2)),
            collapsed_slice_dims=(),
            start_index_map=tuple(range(ndim)),
        ),
        slice_sizes=(2,) * ndim + (ncols,),
        mode=jax.lax.GatherScatterMode.CLIP,
    )  # (B, 2, ..., 2, C)

    dt = points.dtype
    out = block.astype(dt)
    for d in range(ndim):
        lo = out[:, 0]
        hi = out[:, 1]
        t = ts[d].reshape(ts[d].shape + (1,) * (out.ndim - 2))
        top = tops[d].reshape(tops[d].shape + (1,) * (out.ndim - 2))
        out = jnp.where(top, hi, (1.0 - t) * lo + t * hi)
    return jnp.where(bad[:, None], jnp.full_like(out, jnp.nan), out)


def pair_innermost_columns(values: np.ndarray) -> np.ndarray:
    """Pre-pair adjacent innermost-axis rows into doubled columns:

        out[..., e, :C] = values[..., e, :]
        out[..., e, C:] = values[..., e + 1, :]     (out has n_k - 1 rows)

    Feeds :func:`interp_nd` ``paired=True`` — the per-point corner fetch
    along the innermost axis (the EEP ladder / the BC AV axis) becomes ONE
    row gather instead of two. Costs one extra copy of the packed table in
    device memory.
    """
    return np.concatenate([values[..., :-1, :], values[..., 1:, :]], axis=-1)


def _interp_nd_paired(values, knots, points, icols, axis_maps):
    """Gather path for :func:`pair_innermost_columns`-packed tables:
    ``2**(ndim-1)`` row gathers per point (corners of the OUTER dims), each
    fetching both innermost-axis corners at once, then the innermost lerp
    selects/blends the two column halves. Semantics identical to the
    row-gather path: interior exact-knot matches keep IEEE ``0 * NaN``
    poisoning by the weight-0 neighbor; an exact TOP-knot hit on the
    innermost axis SELECTS the upper half (the clamp in
    REFERENCE_DEVIATIONS), and other axes clamp corners as usual."""
    ndim = len(knots)
    dims = tuple(int(k.shape[0]) for k in knots)
    C2 = values.shape[-1]
    C = C2 // 2
    assert values.shape[:-1] == tuple(dims[:-1]) + (dims[-1] - 1,), (
        "paired values must have n_k - 1 innermost rows"
    )
    if C == 0 or (icols is not None and len(icols) == 0):
        # zero-band models interp an empty column set (e.g. spectroscopy-
        # only star_lnlike); nothing to gather
        return jnp.zeros(points.shape[:-1] + (0,), dtype=points.dtype)

    cells, ts = [], []
    bad = jnp.any(jnp.isnan(points), axis=-1)
    for d in range(ndim):
        amap = axis_maps[d] if axis_maps is not None else None
        cell, t, oob = find_cells_1d(knots[d], points[..., d], axis_map=amap)
        bad = bad | oob
        cells.append(cell)
        ts.append(t)

    if icols is not None and tuple(icols) != tuple(range(C)):
        sel = list(icols) + [i + C for i in icols]
        values = values[..., np.asarray(sel, dtype=np.int64)]
        C = len(icols)

    nk = dims[-1]
    top_k = cells[-1] == nk - 1  # exact top-knot pin (find_cells_1d)
    cell_k = jnp.clip(cells[-1], 0, max(nk - 2, 0))

    pdims = tuple(dims[:-1]) + (nk - 1,)
    strides = np.ones(ndim, dtype=np.int64)
    for d in range(ndim - 2, -1, -1):
        strides[d] = strides[d + 1] * pdims[d + 1]

    flat_vals = values.reshape(-1, 2 * C)
    n_outer = 2 ** (ndim - 1)
    offsets = np.stack(
        [[(i >> (ndim - 2 - j)) & 1 for j in range(ndim - 1)] for i in range(n_outer)]
    ) if ndim > 1 else np.zeros((1, 0), dtype=np.int64)

    dt = points.dtype
    corner_w = []
    corner_idx = []
    base_k = cell_k.astype(jnp.int32) * np.int32(strides[ndim - 1])
    for i in range(n_outer):
        w = jnp.ones(points.shape[:-1], dtype=dt)
        idx = base_k
        for d in range(ndim - 1):
            o = int(offsets[i, d])
            w = w * (ts[d] if o else (1.0 - ts[d]))
            cd = jnp.clip(cells[d] + o, 0, dims[d] - 1)
            idx = idx + cd.astype(jnp.int32) * np.int32(strides[d])
        corner_w.append(w)
        corner_idx.append(idx)

    weights = jnp.stack(corner_w, axis=-1)  # (B, 2^(ndim-1))
    flat_idx = jnp.stack(corner_idx, axis=-1)
    pairs = jnp.take(flat_vals, flat_idx, axis=0)  # (B, 2^(ndim-1), 2C)
    lo = pairs[..., :C].astype(dt)
    hi = pairs[..., C:].astype(dt)
    tk = ts[-1][:, None, None]
    blend = (1.0 - tk) * lo + tk * hi
    corners = jnp.where(top_k[:, None, None], hi, blend)
    out = jnp.einsum("bj,bjc->bc", weights, corners, precision=LERP_PRECISION)
    return jnp.where(bad[:, None], jnp.full_like(out, jnp.nan), out)


def interp_nd(
    values: jnp.ndarray,
    knots: Sequence[jnp.ndarray],
    points: jnp.ndarray,
    icols: Optional[Tuple[int, ...]] = None,
    axis_maps: Optional[Tuple] = None,
    block: Optional[bool] = None,
    paired: bool = False,
) -> jnp.ndarray:
    """Batched multilinear interpolation on a dense rectilinear grid.

    The unified replacement for ``interp_value_{2,3,4}d`` /
    ``interp_values_{2,3,4}d`` (interp.py:208-392) at any ndim >= 1.

    values : (n0, ..., nk, C) dense grid (NaN-padded holes)
    knots  : k+1 sorted 1-D axis arrays
    points : (..., ndim) query coordinates
    icols  : static tuple of column indices (None = all columns)
    axis_maps : static per-axis analytic index maps (compute_axis_maps)
    block : gather strategy — True: one block gather of the ``(2,)*ndim``
        corner neighborhood per point + per-dim contraction; False
        (default): 2**ndim independent row gathers + einsum. Kept as an
        option because the semantics survey (one fetch per point) documents
        the design space; env ISOTPU_INTERP_BLOCK=1 force-enables it for
        measurement. Its speed on the GPU is not measured.

    paired : ``values`` was packed by :func:`pair_innermost_columns`
        (shape ``(n0..n_{k-1}, n_k - 1, 2C)``): fetch both innermost-axis
        corners per row gather — half the gathers of the row path.

    Returns (..., n_icols); NaN rows for NaN/out-of-bounds queries.
    """
    batch_shape = points.shape[:-1]
    pts = points.reshape(-1, points.shape[-1])
    if paired:
        out = _interp_nd_paired(values, knots, pts, icols, axis_maps)
        return out.reshape(batch_shape + (out.shape[-1],))
    if block is None:
        import os

        block = os.environ.get("ISOTPU_INTERP_BLOCK", "") in ("1", "true")
    if block and all(d >= 2 for d in values.shape[:-1]):
        out = _interp_nd_block(values, knots, pts, icols, axis_maps)
    else:
        corners, weights, bad = corner_data(values, knots, pts, icols=icols, axis_maps=axis_maps)
        out = jnp.einsum(
            "bj,bjc->bc", weights, corners.astype(weights.dtype), precision=LERP_PRECISION
        )
        out = jnp.where(bad[:, None], jnp.full_like(out, jnp.nan), out)
    n_out = out.shape[-1]
    return out.reshape(batch_shape + (n_out,))


def interp_grid(grid: GridData, points: jnp.ndarray, cols=None) -> jnp.ndarray:
    """Interpolate named/indexed columns of a :class:`GridData`."""
    return interp_nd(
        grid.values, grid.knots, points, icols=grid.icols(cols), axis_maps=grid.axis_maps
    )


class GridInterpolator:
    """Host-facing convenience wrapper — the ``DFInterpolator`` equivalent
    (reference: interp.py:571-698).

    Built from a pandas DataFrame with a full- or partial-product MultiIndex;
    densifies to a NaN-padded ndarray (interp.py:598-609) and exposes a
    callable returning numpy. The jittable path is :func:`interp_nd` on
    ``self.grid_data``.
    """

    def __init__(self, df=None, filename=None, recalc=False, is_full=False, grid_data=None, dtype=None):
        import pandas as pd  # host-only dependency

        if grid_data is not None:
            if grid_data.axis_maps is None:
                grid_data = dataclasses.replace(
                    grid_data, axis_maps=compute_axis_maps([np.asarray(k) for k in grid_data.knots])
                )
            self.grid_data = grid_data if dtype is None else grid_data.astype(dtype)
            self.columns = list(grid_data.columns)
            self.index_names = None
        else:
            self.columns = list(df.columns)
            values, knots = self._densify(df, filename=filename, recalc=recalc, is_full=is_full)
            if dtype is not None:
                values = values.astype(dtype)
                knots = tuple(k.astype(dtype) for k in knots)
            self.grid_data = GridData(
                values=jnp.asarray(values),
                knots=tuple(jnp.asarray(k) for k in knots),
                columns=tuple(self.columns),
                host_values=np.asarray(values),
                axis_maps=compute_axis_maps(knots),
            )
            self.index_names = list(df.index.names)

        self.n_columns = len(self.columns)
        self.column_index = {c: i for i, c in enumerate(self.columns)}
        self.ndim = self.grid_data.ndim_grid

    @property
    def grid(self):
        if self.grid_data.host_values is not None:
            return self.grid_data.host_values
        return np.asarray(self.grid_data.values)

    @property
    def index_columns(self):
        return tuple(np.asarray(k) for k in self.grid_data.knots)

    @staticmethod
    def _densify(df, filename=None, recalc=False, is_full=False):
        import itertools
        import os

        import pandas as pd

        levels = [np.asarray(l, dtype=float) for l in df.index.levels]
        if filename is not None and os.path.exists(filename) and not recalc:
            d = np.load(filename, allow_pickle=True)
            grid = d["grid"]
            columns = [str(c) for c in d["columns"]]
            if columns != [str(c) for c in df.columns]:
                raise ValueError("DataFrame columns do not match columns loaded from full grid!")
            return grid, tuple(levels)

        if not is_full:
            idx = pd.MultiIndex.from_product(df.index.levels)
            grid_df = df.reindex(idx)
        else:
            grid_df = df
        shape = [len(l) for l in df.index.levels] + [len(df.columns)]
        grid = np.asarray(grid_df.values, dtype=float).reshape(shape)
        if filename is not None:
            np.savez(filename, grid=grid, columns=np.asarray(df.columns, dtype=object))
        return grid, tuple(levels)

    def add_column(self, values, name):
        """reference: interp.py:616-623"""
        host = None
        if self.grid_data.host_values is not None:
            hv = np.asarray(values, dtype=self.grid_data.host_values.dtype)
            host = np.concatenate(
                [self.grid_data.host_values, hv.reshape(self.grid_data.host_values.shape[:-1] + (1,))],
                axis=-1,
            )
        values = jnp.asarray(values, dtype=self.grid_data.values.dtype)
        new_vals = jnp.concatenate(
            [self.grid_data.values, values.reshape(self.grid_data.values.shape[:-1] + (1,))], axis=-1
        )
        self.columns = self.columns + [name]
        self.grid_data = GridData(
            values=new_vals, knots=self.grid_data.knots, columns=tuple(self.columns),
            host_values=host, axis_maps=self.grid_data.axis_maps,
        )
        self.n_columns += 1
        self.column_index[name] = self.n_columns - 1

    def __call__(self, p, cols="all"):
        icols = self.grid_data.icols(None if cols == "all" else cols)
        scalar_in = all(np.ndim(x) == 0 for x in p)
        pts = np.broadcast_arrays(*[np.asarray(x, dtype=float) for x in p])
        points = jnp.stack([jnp.asarray(x) for x in pts], axis=-1)
        if points.ndim == 1:
            points = points[None, :]
        out = np.asarray(interp_nd(self.grid_data.values, self.grid_data.knots, points, icols=icols, axis_maps=self.grid_data.axis_maps))
        if scalar_in:
            return out[0]
        return out

    def find_closest(self, val, lo, hi, v1, v2, col="initial_mass", **kwargs):
        """Root-find along the last grid axis (reference: interp.py:404-485,625-629)."""
        from .rootfind import find_closest_grid

        icol = self.column_index[col]
        return find_closest_grid(self.grid_data, val, lo, hi, v1, v2, icol, **kwargs)
