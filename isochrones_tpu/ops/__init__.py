"""Jittable device kernel layer — the rebuild of the reference's Numba L0
(``isochrones/interp.py``, ``mags.py``, ``likelihood.py``, ``cluster_utils.py``)."""

from .interp import GridData, GridInterpolator, compute_axis_maps, interp_nd, interp_grid, find_cells_1d
from .mags import interp_mag, interp_mags
from .likelihood import gauss_lnprob, star_lnlike, stack_components, LOG_ONE_OVER_ROOT_2PI
from .rootfind import find_closest_grid, find_closest_grid_batch
from .cluster import (
    calc_lnlike_grid,
    cluster_lnlike,
    cluster_lnmarginal,
    integrate_over_eeps,
    integrate_over_eeps_ln,
)
from .eep import interp_eep, get_eep_newton, searchsorted_rows

__all__ = [
    "GridData",
    "GridInterpolator",
    "interp_nd",
    "interp_grid",
    "find_cells_1d",
    "interp_mag",
    "interp_mags",
    "gauss_lnprob",
    "star_lnlike",
    "stack_components",
    "LOG_ONE_OVER_ROOT_2PI",
    "find_closest_grid",
    "find_closest_grid_batch",
    "compute_axis_maps",
    "calc_lnlike_grid",
    "integrate_over_eeps",
    "integrate_over_eeps_ln",
    "cluster_lnlike",
    "cluster_lnmarginal",
    "interp_eep",
    "get_eep_newton",
    "searchsorted_rows",
]
