"""Fused synthetic-magnitude kernel.

Rebuild of ``isochrones/mags.py:8-124`` (``interp_mag`` / ``interp_mags``):
3-d interpolation of (Teff, logg, feh, Mbol) from the stellar model grid,
composed with 4-d interpolation of per-band bolometric corrections at
(Teff, logg, feh, AV), then ``mag = Mbol + 5 log10(d/10) - BC``.

Everything is batch-first and jittable: one call handles an arbitrary leading
batch shape (the reference loops serially per point, mags.py:96-123). The two
grid interpolations are chained gathers that XLA keeps on the device.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

from .interp import GridData, interp_nd

__all__ = ["interp_mag", "interp_mags"]


def interp_mag(
    params: jnp.ndarray,
    index_order: Tuple[int, ...],
    model: GridData,
    model_icols: Tuple[int, int, int, int],
    bc: GridData,
    bc_icols: Tuple[int, ...],
):
    """Fused model-grid + BC-grid magnitude evaluation.

    params : (..., 5) in user parameter order (e.g. (eep, age, feh, distance, AV)
        for isochrone grids, (mass, eep, feh, distance, AV) for track grids).
    index_order : static permutation mapping user order -> grid axis order
        (reference ``_param_index_order``, models.py:259,669,696).
    model_icols : static (i_Teff, i_logg, i_feh, i_Mbol) column indices.
    bc_icols : static band column indices into the BC grid.

    Returns ``(Teff, logg, feh, mags)`` with ``mags`` shaped ``(..., n_bands)``.
    """
    i0, i1, i2, i_dist, i_av = (
        index_order[0],
        index_order[1],
        index_order[2],
        index_order[3],
        index_order[4],
    )
    grid_pts = jnp.stack([params[..., i0], params[..., i1], params[..., i2]], axis=-1)
    star_props = interp_nd(model.values, model.knots, grid_pts, icols=tuple(model_icols),
                           axis_maps=model.axis_maps, paired=getattr(model, "paired", False))
    Teff = star_props[..., 0]
    logg = star_props[..., 1]
    feh = star_props[..., 2]
    mbol = star_props[..., 3]

    AV = params[..., i_av]
    bc_pts = jnp.stack([Teff, logg, feh, AV], axis=-1)
    bc_vals = interp_nd(bc.values, bc.knots, bc_pts, icols=tuple(bc_icols),
                        axis_maps=bc.axis_maps, paired=getattr(bc, "paired", False))

    dist_mod = 5.0 * jnp.log10(params[..., i_dist] / 10.0)
    mags = mbol[..., None] + dist_mod[..., None] - bc_vals
    return Teff, logg, feh, mags


# Batched alias — the reference distinguishes scalar ``interp_mag`` from the
# serial-loop ``interp_mags`` (mags.py:64-124); here one vectorized kernel
# covers both.
interp_mags = interp_mag
