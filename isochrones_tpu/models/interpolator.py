"""User-facing interpolator API (L2).

Rebuild of ``isochrones/models.py:253-718`` (``ModelGridInterpolator``,
``EvolutionTrackInterpolator``, ``IsochroneInterpolator``): joins one stellar
model grid with one bolometric-correction grid and exposes property
interpolation, synthetic magnitudes, EEP inversion, and forward generation.

Accelerator-first differences from the reference:
* the hot paths (`interp_value`, `interp_mag`, `get_eep`, `generate`) are
  batched jitted functions over device-resident :class:`GridData` pytrees —
  one call handles any batch shape (the reference dispatches scalar-vs-loop
  per point, models.py:402-445);
* "accurate" EEP inversion is a vmapped autodiff-Newton solve
  (ops/eep.py) instead of per-scalar scipy Nelder-Mead (models.py:544-578);
* host conveniences (DataFrame assembly) wrap the jitted core.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.eep import get_eep_newton, interp_eep
from ..ops.interp import GridData, interp_nd
from ..ops.mags import interp_mag as _interp_mag_kernel
from ..utils import addmags

__all__ = [
    "ModelGridInterpolator",
    "EvolutionTrackInterpolator",
    "IsochroneInterpolator",
]


def _broadcast_pars(pars, n):
    arrs = [np.asarray(p, dtype=float) for p in pars[:n]]
    b = np.broadcast(*arrs)
    scalar = b.ndim == 0
    stacked = np.stack([np.broadcast_to(a, b.shape).reshape(-1) for a in arrs], axis=-1)
    return jnp.asarray(stacked), scalar, b.shape


#: Host-entry batch chunk: every host-facing call is evaluated in fixed
#: (padded) chunks of this many rows, so (a) each wrapper compiles at most
#: two programs ever (small exact shape + the chunk shape) regardless of
#: request sizes, and (b) huge batches stay under the remote-compile
#: service's request-size limit (1e6-row programs hit HTTP 413 there).
HOST_CHUNK = 1 << 18


def _chunked_rows(fn, points_np, n_chunk=HOST_CHUNK):
    """Evaluate ``fn`` (jnp (B, k) -> array-or-tuple with leading B) over
    fixed-size padded chunks of host rows; returns numpy outputs.

    Readback uses one ``jax.device_get`` per chunk (pipelined multi-buffer
    transfer) rather than serial per-array ``np.asarray``."""
    import jax

    B = points_np.shape[0]
    if B <= n_chunk:
        return jax.device_get(fn(jnp.asarray(points_np)))
    outs = []
    for start in range(0, B, n_chunk):
        chunk = points_np[start : start + n_chunk]
        if chunk.shape[0] < n_chunk:  # pad to the compiled chunk shape
            pad = n_chunk - chunk.shape[0]
            chunk = np.concatenate([chunk, np.broadcast_to(chunk[:1], (pad,) + chunk.shape[1:])])
            out = jax.device_get(fn(jnp.asarray(chunk)))
            if isinstance(out, tuple):
                out = tuple(o[: n_chunk - pad] for o in out)
            else:
                out = out[: n_chunk - pad]
        else:
            out = jax.device_get(fn(jnp.asarray(chunk)))
        outs.append(out)
    if isinstance(outs[0], tuple):
        return tuple(np.concatenate([o[i] for o in outs]) for i in range(len(outs[0])))
    return np.concatenate(outs)


@partial(jax.jit, static_argnames=("eep0",))
def _interp_eep_g(ages, fehs, masses, feh_knots, mass_knots, age_arrays, lengths, eep0):
    return interp_eep(ages, fehs, masses, feh_knots, mass_knots, age_arrays, lengths, eep0=eep0)


@partial(jax.jit, static_argnames=("icols", "io"))
def _interp_value_g(model: GridData, points, icols, io):
    grid_pts = jnp.stack([points[..., io[0]], points[..., io[1]], points[..., io[2]]], axis=-1)
    return interp_nd(model.values, model.knots, grid_pts, icols=icols, axis_maps=model.axis_maps)


@partial(jax.jit, static_argnames=("model_icols", "band_icols", "io"))
def _interp_mag_g(model: GridData, bc: GridData, points, model_icols, band_icols, io):
    return _interp_mag_kernel(points, io, model, model_icols, bc, band_icols)


@partial(
    jax.jit,
    static_argnames=(
        "prop_icols", "model_icols", "band_icols", "io", "eep0",
        "all_As", "accurate", "i_age", "resid_tol",
    ),
)
def _generate_g(
    model: GridData,
    model_packed: GridData,
    bc: GridData,
    feh_knots,
    mass_knots,
    age_arrays,
    lengths,
    points3,  # (..., 3) = (mass, age, feh)
    distance,
    AV,
    prop_icols,
    model_icols,
    band_icols,
    io,
    eep0,
    all_As,
    accurate,
    i_age,
    resid_tol,
):
    """Fused forward model: (mass, age, feh, d, AV) -> (eep, props, mags[, mags@AV=0])
    in ONE device program.

    The reference's ``generate`` (models.py:580-631) chains get_eep ->
    interp_value -> interp_mag (-> interp_mag at AV=0 for all_As) as separate
    host calls, each paying a dispatch and a host round trip. Fusing them
    makes host latency amortize over the whole pipeline."""
    mass = points3[..., 0]
    age = points3[..., 1]
    feh = points3[..., 2]
    eeps = interp_eep(age, feh, mass, feh_knots, mass_knots, age_arrays, lengths, eep0=eep0)
    if accurate:
        eeps_n, resid = get_eep_newton(model, eeps, age, feh, mass, i_age)
        eeps = jnp.where(jnp.abs(resid) < resid_tol, eeps_n, jnp.nan)
    pts5 = jnp.stack([mass, eeps, feh, distance, AV], axis=-1)
    grid_pts = jnp.stack([pts5[..., io[0]], pts5[..., io[1]], pts5[..., io[2]]], axis=-1)
    props = interp_nd(model.values, model.knots, grid_pts, icols=prop_icols, axis_maps=model.axis_maps)
    _, _, _, mags = _interp_mag_kernel(pts5, io, model_packed, model_icols, bc, band_icols)
    if all_As:
        pts5_0 = pts5.at[..., 4].set(0.0)
        _, _, _, mags0 = _interp_mag_kernel(pts5_0, io, model_packed, model_icols, bc, band_icols)
        return eeps, props, mags, mags0
    # no duplicate mags buffer when AV=0 mags aren't requested: every
    # returned byte is read back to the host
    return eeps, props, mags


class ModelGridInterpolator:
    """Base interpolator joining a model grid and a BC grid.

    Parameters are given in *user order* (``param_names``); the static
    ``_param_index_order`` permutation maps them to grid-axis order
    (reference models.py:259).
    """

    param_names: Tuple[str, ...] = ("p0", "p1", "p2", "distance", "AV")
    eep_replaces: Optional[str] = None
    _param_index_order: Tuple[int, ...] = (1, 2, 0, 3, 4)
    name = "model"
    #: reference models.py:255-257 class hooks (grid classes the factory
    #: pairing uses); None here — the MIST factory functions set them on the
    #: instances they build
    grid_type = None
    bc_type = None

    def __init__(self, model: GridData, bc: GridData, bands: Optional[Sequence[str]] = None, eep_support=None):
        self.model = model
        self.bc = bc
        self.bands = list(bands) if bands is not None else list(bc.columns)
        self.param_index_order = list(self._param_index_order)
        # (feh_knots, mass_knots, age_arrays(+inf padded), lengths) for fast EEP inversion
        self.eep_support = eep_support

        ci = model.column_index
        self._model_icols = (ci["Teff"], ci["logg"], ci["feh"], ci["Mbol"])
        bci = bc.column_index
        self._band_icols = tuple(bci[b] for b in self.bands)
        self._limits_cache = {}

        # Packed copy of the 4 hot columns: interp_mag gathers 2^3 corner rows
        # per point; with (Teff, logg, feh, Mbol) contiguous each gather is one
        # row read instead of 4 scattered column reads. Additionally PAIRED
        # along the innermost (EEP) axis (pair_innermost_columns): each row
        # carries both EEP corners, halving the gather count.
        import os

        import jax.numpy as jnp

        from ..ops.interp import pair_innermost_columns

        # OPT-IN (ISOTPU_PAIR_GRIDS=1): the paired gather's reverse-mode
        # cost is higher than the unpaired one's, and models are
        # differentiated by fit_nuts, so unpaired is the default. Its speed
        # on the GPU is not measured.
        can_pair = (
            model.values.shape[-2] >= 2
            and os.environ.get("ISOTPU_PAIR_GRIDS", "0") in ("1", "true")
        )
        if model.host_values is not None:
            packed_np = np.ascontiguousarray(model.host_values[..., list(self._model_icols)])
            if can_pair:
                packed_np = np.ascontiguousarray(pair_innermost_columns(packed_np))
            packed = jnp.asarray(packed_np)
        elif can_pair:
            # pairing needs a host pass over the grid (see
            # GridData.host_values) — pay it only for the opt-in
            packed_np = np.ascontiguousarray(pair_innermost_columns(
                np.asarray(model.values[..., jnp.asarray(self._model_icols)])
            ))
            packed = jnp.asarray(packed_np)
        else:
            # default path: subset on DEVICE, no host round trip
            packed_np = None
            packed = model.values[..., jnp.asarray(self._model_icols)]
        self.model_packed = GridData(
            values=packed, knots=model.knots,
            columns=("Teff", "logg", "feh", "Mbol"),
            host_values=packed_np, axis_maps=model.axis_maps, paired=can_pair,
        )
        self._packed_icols = (0, 1, 2, 3)

        # paired copy of the BC table for the hot kernels (AV is the
        # innermost axis); the general-API ``self.bc`` stays unpaired
        self.bc_paired = None
        if can_pair and bc.values.shape[-2] >= 2:
            if bc.host_values is not None:
                bc_np = bc.host_values
            else:
                bc_np = np.asarray(bc.values)
            bc_np = np.ascontiguousarray(pair_innermost_columns(bc_np))
            self.bc_paired = GridData(
                values=jnp.asarray(bc_np), knots=bc.knots, columns=bc.columns,
                host_values=bc_np, axis_maps=bc.axis_maps, paired=True,
            )

        # 6-column variant additionally packing the EEP-prior change-of-
        # variables columns (orig quantity + its d/dEEP derivative), so a
        # fused lnpost shares ONE corner-gather pass between the magnitude
        # model and the EEP prior (they interpolate the same grid points).
        self.model_packed6 = None
        if self.eep_replaces == "age" and "age" in ci and "dt_deep" in ci:
            prior_cols = (ci["age"], ci["dt_deep"])
            prior_names = ("age", "dt_deep")
        elif self.eep_replaces == "mass" and "initial_mass" in ci and "dm_deep" in ci:
            prior_cols = (ci["initial_mass"], ci["dm_deep"])
            prior_names = ("initial_mass", "dm_deep")
        else:
            prior_cols = None
        if prior_cols is not None:
            icols6 = self._model_icols + prior_cols
            if model.host_values is not None:
                p6_np = np.ascontiguousarray(model.host_values[..., list(icols6)])
                p6 = jnp.asarray(p6_np)
            else:
                # subset on DEVICE (no host round trip; see model_packed)
                p6_np = None
                p6 = model.values[..., jnp.asarray(icols6)]
            # NOT paired: pairing the 6-column table doubles its device
            # footprint (48 B rows) for a halved gather count; the trade
            # is not measured on the GPU.
            self.model_packed6 = GridData(
                values=p6, knots=model.knots,
                columns=("Teff", "logg", "feh", "Mbol") + prior_names,
                host_values=p6_np, axis_maps=model.axis_maps, paired=False,
            )

    # ------------------------------------------------------------------ limits
    @property
    def _host_values(self):
        """Host-side copy of the model grid for metadata queries. Column
        min/max on device would trigger a fresh XLA compile per grid shape
        for a one-time scalar."""
        if getattr(self, "_host_values_cache", None) is None:
            if self.model.host_values is not None:
                self._host_values_cache = self.model.host_values
            else:
                self._host_values_cache = np.asarray(self.model.values)
        return self._host_values_cache

    def get_limits(self, prop):
        """Axis/value ranges (reference grid.py:58, models.py:276-305)."""
        if prop in self._limits_cache:
            return self._limits_cache[prop]
        axis_names = self._axis_names()
        if prop in axis_names:
            k = np.asarray(self.model.knots[axis_names.index(prop)])
            lim = (float(k[0]), float(k[-1]))
        else:
            icol = self.model.column_index[prop]
            col = self._host_values[..., icol]
            lim = (float(np.nanmin(col)), float(np.nanmax(col)))
        self._limits_cache[prop] = lim
        return lim

    def _axis_names(self):
        raise NotImplementedError

    @property
    def eep_bounds(self):
        return self.get_limits("eep")

    @property
    def minfeh(self):
        return self.get_limits("feh")[0]

    @property
    def maxfeh(self):
        return self.get_limits("feh")[1]

    @property
    def mineep(self):
        return self.get_limits("eep")[0]

    @property
    def maxeep(self):
        return self.get_limits("eep")[1]

    @property
    def minage(self):
        return self.get_limits("age")[0]

    @property
    def maxage(self):
        return self.get_limits("age")[1]

    @property
    def minmass(self):
        return self.get_limits("mass")[0]

    @property
    def maxmass(self):
        return self.get_limits("mass")[1]

    @property
    def fehs(self):
        ax = self._axis_names()
        return np.asarray(self.model.knots[ax.index("feh")])

    @property
    def ages(self):
        """Age knots (isochrone grids only; reference models.py:313-319)."""
        if self.eep_replaces != "mass":
            raise AttributeError(
                "Age is not a dimension of model grid type {}!".format(self.name)
            )
        ax = self._axis_names()
        return np.asarray(self.model.knots[ax.index("age")])

    @property
    def masses(self):
        """Mass knots (track grids only; reference models.py:321-327)."""
        if self.eep_replaces != "age":
            raise AttributeError("Mass is not a dimension of this model grid!")
        ax = self._axis_names()
        return np.asarray(self.model.knots[ax.index("mass")])

    @property
    def model_grid(self):
        """The stellar-model grid (here the device-resident :class:`GridData`
        rather than the reference's lazy pandas grid; reference
        models.py:337-341)."""
        return self.model

    @property
    def bc_grid(self):
        """The bolometric-correction grid (reference models.py:343-347)."""
        return self.bc

    @property
    def prop_map(self):
        """Canonical property name -> grid column name, for the standard
        properties present in this grid (reference models.py:43-54; our
        columns already carry canonical names, so this is the identity over
        available columns, with the grid axes included)."""
        axes = set(self._axis_names())
        cols = set(self.model.columns)
        std = ("eep", "age", "feh", "mass", "initial_mass", "logTeff", "logg", "logL")
        return {p: p for p in std if p in cols or p in axes}

    @property
    def column_map(self):
        """Inverse of :attr:`prop_map` (reference models.py:56-58)."""
        return {v: k for k, v in self.prop_map.items()}

    # -------------------------------------------------------------- core jit fns
    # Grids are passed as pytree ARGUMENTS, never closure-captured: a captured
    # device array becomes an embedded constant in the compiled program — the
    # remote-compile service serializes it into every compile request (tens of
    # MB per grid; >44MB requests are rejected outright with HTTP 413), and
    # the compile cache can't be shared across interpolator instances.

    def interp_value_batch(self, points: jnp.ndarray, props=None) -> jnp.ndarray:
        """Jittable: (..., >=3) user-order params -> (..., n_props)."""
        icols = self.model.icols(props)
        return _interp_value_g(self.model, points, icols, self._param_index_order)

    def interp_mag_batch(self, points: jnp.ndarray, bands=None):
        """Jittable: (..., 5) user-order params -> (Teff, logg, feh, mags)."""
        band_icols = self._band_icols if bands is None else tuple(self.bc.column_index[b] for b in bands)
        return _interp_mag_g(
            self.model_packed, self.bc, points, self._packed_icols, band_icols,
            self._param_index_order,
        )

    # --------------------------------------------------------------- host wrappers
    def interp_value(self, pars, props=None):
        """reference: models.py:390-400"""
        points, scalar, shape = _broadcast_pars(pars, 3)
        out = _chunked_rows(lambda p: self.interp_value_batch(p, props), np.asarray(points))
        if scalar:
            return out[0]
        return out.reshape(shape + (out.shape[-1],))

    def interp_mag(self, pars, bands=None):
        """reference: models.py:402-445; returns (Teff, logg, feh, mags)."""
        points, scalar, shape = _broadcast_pars(pars, 5)
        Teff, logg, feh, mags = _chunked_rows(
            lambda p: self.interp_mag_batch(p, bands), np.asarray(points)
        )
        if scalar:
            return float(Teff[0]), float(logg[0]), float(feh[0]), mags[0]
        return (
            Teff.reshape(shape),
            logg.reshape(shape),
            feh.reshape(shape),
            mags.reshape(shape + (mags.shape[-1],)),
        )

    def _prop(self, prop, *pars):
        out = self.interp_value(list(pars), [prop])
        return out.squeeze(-1) if out.ndim else float(np.asarray(out).squeeze())

    def mass(self, *pars):
        return self._prop("mass", *pars)

    def initial_mass(self, *pars):
        return self._prop("initial_mass", *pars)

    def radius(self, *pars):
        return self._prop("radius", *pars)

    def Teff(self, *pars):
        return self._prop("Teff", *pars)

    def logg(self, *pars):
        return self._prop("logg", *pars)

    def feh(self, *pars):
        return self._prop("feh", *pars)

    def density(self, *pars):
        return self._prop("density", *pars)

    def nu_max(self, *pars):
        return self._prop("nu_max", *pars)

    def delta_nu(self, *pars):
        return self._prop("delta_nu", *pars)

    @property
    def mag(self):
        """Dict-like per-band magnitude callables (reference ``ic.mag[band]``
        usage at observation.py:578, cluster.py:148-152)."""
        ic = self

        class _MagAccessor:
            def __getitem__(self, band):
                def mag_fn(*pars):
                    _, _, _, mags = ic.interp_mag(list(pars), [band])
                    out = np.asarray(mags)[..., 0]
                    return float(out) if out.ndim == 0 or out.size == 1 else out

                return mag_fn

            def keys(self):
                return list(ic.bands)

        return _MagAccessor()

    def initialize(self, pars=None):
        """Warm-up compile + sanity check (reference models.py:349-358)."""
        if pars is None:
            if self.eep_replaces == "age":
                pars = [1.04, 150.0, -0.35, 1000.0, 0.2]
            else:
                pars = [150.0, 9.7, -0.35, 1000.0, 0.2]
        Teff, logg, feh, mags = self.interp_mag(pars, self.bands)
        assert np.isfinite([Teff, logg, feh]).all(), (Teff, logg, feh)
        assert np.isfinite(mags).all(), mags

    # ------------------------------------------------------------------ EEP
    def max_eep(self, mass, feh):
        if self.eep_support is None:
            return self.maxeep
        feh_knots, mass_knots, age_arrays, lengths = self.eep_support
        # side="right" - 1 selects the knot ITSELF on an exact match (the
        # common case — queries usually sit on grid values) and the lower
        # knot in a cell interior; side="left" - 1 picked the bin below an
        # exact knot
        i_f = int(np.clip(np.searchsorted(np.asarray(feh_knots), feh, side="right") - 1, 0, len(np.asarray(feh_knots)) - 1))
        i_m = int(np.clip(np.searchsorted(np.asarray(mass_knots), mass, side="right") - 1, 0, len(np.asarray(mass_knots)) - 1))
        n_mass = len(np.asarray(mass_knots))
        return float(np.asarray(lengths)[i_f * n_mass + i_m])

    def get_eep_batch(self, mass, age, feh, accurate=False, resid_tol=0.02):
        """Jittable batched EEP inversion. Track grids only for the fast path
        (reference models.py:501-542)."""
        mass = jnp.asarray(mass)
        age = jnp.asarray(age)
        feh = jnp.asarray(feh)
        if self.eep_replaces == "age":
            if self.eep_support is None:
                raise ValueError("No EEP support arrays on this grid")
            feh_knots, mass_knots, age_arrays, lengths = self.eep_support
            eep0 = float(np.asarray(self.model.knots[-1])[0])
            fast = _interp_eep_g(age, feh, mass, feh_knots, mass_knots, age_arrays, lengths, eep0)
            if not accurate:
                return fast
            i_age = self.model.column_index["age"]
            eep, resid = get_eep_newton(self.model, fast, age, feh, mass, i_age)
            return jnp.where(jnp.abs(resid) < resid_tol, eep, jnp.nan)
        elif self.eep_replaces == "mass":
            if not accurate:
                raise NotImplementedError("Fast EEP inversion not implemented for isochrone grids (as in reference)")
            i_mass = self.model.column_index["initial_mass"]
            seed = jnp.full(jnp.broadcast_shapes(mass.shape, age.shape, feh.shape), 300.0, dtype=mass.dtype)
            eep, resid = get_eep_newton(self.model, seed, mass, age, feh, i_mass)
            return jnp.where(jnp.abs(resid) < resid_tol, eep, jnp.nan)
        raise NotImplementedError(
            f"EEP inversion needs eep_replaces in ('age', 'mass'); this "
            f"interpolator has eep_replaces={self.eep_replaces!r}"
        )

    def get_eep(self, mass, age, feh, accurate=False, resid_tol=0.02, **kwargs):
        b = np.broadcast(np.asarray(mass, dtype=float), np.asarray(age, dtype=float), np.asarray(feh, dtype=float))
        scalar = b.ndim == 0
        stacked = np.stack(
            [np.broadcast_to(np.asarray(x, dtype=float), b.shape).reshape(-1) for x in (mass, age, feh)],
            axis=-1,
        )
        out = _chunked_rows(
            lambda p: self.get_eep_batch(
                p[:, 0], p[:, 1], p[:, 2], accurate=accurate, resid_tol=resid_tol
            ),
            stacked,
        )
        if scalar:
            return float(out[0])
        return out.reshape(b.shape)

    def get_eep_accurate(self, mass, age, feh, **kwargs):
        return self.get_eep(mass, age, feh, accurate=True, **kwargs)

    # ------------------------------------------------------------- generation
    def generate(
        self,
        mass,
        age,
        feh,
        props="all",
        bands=None,
        eeps=None,
        return_df=True,
        return_dict=False,
        distance=10.0,
        AV=0.0,
        all_As=False,
        accurate=False,
        **kwargs,
    ):
        """Forward model: (mass, age, feh) -> properties + apparent mags
        (reference models.py:580-631)."""
        import pandas as pd

        if self.eep_replaces == "mass":
            return self.track.generate(
                mass, age, feh, props=props, bands=bands, eeps=eeps, return_df=return_df,
                return_dict=return_dict, distance=distance, AV=AV, all_As=all_As, accurate=accurate, **kwargs
            )

        bands = self.bands if bands is None else list(bands)
        b = np.broadcast(*[np.asarray(x, dtype=float) for x in (mass, age, feh, distance, AV)])
        shape = b.shape if b.ndim else (1,)
        mass_, age_, feh_, dist_, av_ = (
            np.broadcast_to(np.asarray(x, dtype=float), shape).reshape(-1) for x in (mass, age, feh, distance, AV)
        )
        prop_names = list(self.model.columns) if props == "all" else list(props)
        true_mags = None
        if eeps is None and self.eep_support is not None:
            # fused single-dispatch path: eep inversion + property interp +
            # mag composition (+ AV=0 mags for all_As) in one device program
            feh_knots, mass_knots, age_arrays, lengths = self.eep_support
            eep0 = float(np.asarray(self.model.knots[-1])[0])
            i_age = self.model.column_index["age"]
            prop_icols = self.model.icols(prop_names)
            band_icols = tuple(self.bc.column_index[b] for b in bands)
            pts = np.stack([mass_, age_, feh_, dist_, av_], axis=-1)

            def run(p):
                return _generate_g(
                    self.model, self.model_packed, self.bc,
                    feh_knots, mass_knots, age_arrays, lengths,
                    p[:, :3], p[:, 3], p[:, 4],
                    prop_icols, self._packed_icols, band_icols,
                    self._param_index_order, eep0, bool(all_As), bool(accurate),
                    i_age, 0.02,
                )

            out = _chunked_rows(run, pts)
            if all_As:
                eeps_, values, mags, mags0 = out
                true_mags = mags0
            else:
                eeps_, values, mags = out
        else:
            if eeps is None:
                eeps_ = _chunked_rows(
                    lambda p: self.get_eep_batch(p[:, 0], p[:, 1], p[:, 2], accurate=accurate),
                    np.stack([mass_, age_, feh_], axis=-1),
                )
            else:
                eeps_ = np.broadcast_to(np.asarray(eeps, dtype=float), shape).reshape(-1)
            pts5 = np.stack([mass_, eeps_, feh_, dist_, av_], axis=-1)
            values = _chunked_rows(lambda p: self.interp_value_batch(p, prop_names), pts5)
            _, _, _, mags = _chunked_rows(lambda p: self.interp_mag_batch(p, bands), pts5)
            if all_As:
                pts0 = np.stack([mass_, eeps_, feh_, dist_, np.zeros_like(av_)], axis=-1)
                _, _, _, true_mags = _chunked_rows(lambda p: self.interp_mag_batch(p, bands), pts0)

        columns = prop_names + [f"{b_}_mag" for b_ in bands]
        data = np.concatenate([values, mags], axis=-1)
        df = pd.DataFrame(data, columns=columns)
        df["distance"] = dist_
        df["AV"] = av_
        df["initial_feh"] = feh_
        df["requested_age"] = age_

        if all_As:
            for i, b_ in enumerate(bands):
                df[f"A_{b_}"] = df[f"{b_}_mag"] - true_mags[:, i]

        if return_dict:
            return {c: df[c].values for c in df.columns}
        return df

    def generate_device(
        self, mass, age, feh, props="all", bands=None, distance=10.0, AV=0.0,
        accurate=False,
    ):
        """Device-resident forward model: the same fused single-dispatch
        program as :meth:`generate` (EEP inversion + property interp + mag
        composition), but returning JAX device arrays ``(eeps, values,
        mags)`` WITHOUT host readback. For device-resident consumers
        (population pipelines, samplers) and for measuring the kernel free
        of the host link, whose readback would otherwise hide device-side
        regressions."""
        import jax.numpy as jnp

        if self.eep_replaces == "mass":
            return self.track.generate_device(
                mass, age, feh, props=props, bands=bands, distance=distance,
                AV=AV, accurate=accurate,
            )
        if self.eep_support is None:
            raise NotImplementedError("generate_device needs baked EEP support arrays")
        bands = self.bands if bands is None else list(bands)
        # broadcast/stack stay in jnp: np.asarray on a device array forces a
        # blocking device->host copy (and jnp.asarray would then re-upload),
        # which both breaks the "no host readback" contract for
        # device-resident callers and makes the device bench row measure the
        # host link. Shapes are static metadata — no sync happens here.
        dt = jnp.result_type(float)
        arrs = [jnp.asarray(x, dtype=dt) for x in (mass, age, feh, distance, AV)]
        shape = jnp.broadcast_shapes(*(a.shape for a in arrs)) or (1,)
        mass_, age_, feh_, dist_, av_ = (
            jnp.broadcast_to(a, shape).reshape(-1) for a in arrs
        )
        prop_names = list(self.model.columns) if props == "all" else list(props)
        feh_knots, mass_knots, age_arrays, lengths = self.eep_support
        eep0 = float(np.asarray(self.model.knots[-1])[0])
        i_age = self.model.column_index["age"]
        pts = jnp.stack([mass_, age_, feh_, dist_, av_], axis=-1)
        return _generate_g(
            self.model, self.model_packed, self.bc,
            feh_knots, mass_knots, age_arrays, lengths,
            pts[:, :3], pts[:, 3], pts[:, 4],
            self.model.icols(prop_names), self._packed_icols,
            tuple(self.bc.column_index[b_] for b_ in bands),
            self._param_index_order, eep0, False, bool(accurate), i_age, 0.02,
        )

    def generate_binary(self, mass_A, mass_B, age, feh, **kwargs):
        """reference: models.py:633-661 — but both components run in ONE
        device program (a stacked 2N-row batch) instead of the reference's
        two generate calls, saving a dispatch and a host round trip."""
        import pandas as pd

        bands = kwargs.get("bands", None) or self.bands
        mass_A, mass_B = np.broadcast_arrays(np.asarray(mass_A, dtype=float), np.asarray(mass_B, dtype=float))
        n = mass_A.size
        shape = mass_A.shape
        age_b, feh_b = (np.broadcast_to(np.asarray(x, dtype=float), shape) for x in (age, feh))
        dist_b = np.broadcast_to(np.asarray(kwargs.pop("distance", 10.0), dtype=float), shape)
        av_b = np.broadcast_to(np.asarray(kwargs.pop("AV", 0.0), dtype=float), shape)

        both = self.generate(
            np.concatenate([mass_A.ravel(), mass_B.ravel()]),
            np.tile(age_b.ravel(), 2),
            np.tile(feh_b.ravel(), 2),
            distance=np.tile(dist_b.ravel(), 2),
            AV=np.tile(av_b.ravel(), 2),
            **kwargs,
        )
        values_A = both.iloc[:n].reset_index(drop=True)
        values_B = both.iloc[n:].reset_index(drop=True)

        values = pd.concat(
            [
                values_A.rename(columns={c: f"{c}_0" for c in values_A.columns}),
                values_B.rename(columns={c: f"{c}_1" for c in values_B.columns}),
            ],
            axis=1,
        )
        for b in bands:
            m0 = values_A[f"{b}_mag"].values
            m1 = np.nan_to_num(values_B[f"{b}_mag"].values, nan=np.inf)
            values[f"{b}_mag"] = addmags(m0, m1)
            if kwargs.get("all_As", False):
                A0 = values[f"A_{b}_0"].values
                A1 = np.nan_to_num(values[f"A_{b}_1"].values, nan=0.0)
                values[f"A_{b}"] = values[f"{b}_mag"] - addmags(m0 - A0, m1 - A1)
        return values

    def __call__(self, p1, p2, p3, distance=10.0, AV=0.0):
        """Full property+mag table at given params (reference models.py:471-482)."""
        import pandas as pd

        b = np.broadcast(*[np.asarray(x, dtype=float) for x in (p1, p2, p3, distance, AV)])
        shape = b.shape if b.ndim else (1,)
        cols = list(self.model.columns)
        arrs = [np.broadcast_to(np.asarray(x, dtype=float), shape).reshape(-1) for x in (p1, p2, p3, distance, AV)]
        pts = np.stack(arrs, axis=-1)
        props = _chunked_rows(lambda p: self.interp_value_batch(p, cols), pts)
        _, _, _, mags = _chunked_rows(lambda p: self.interp_mag_batch(p, None), pts)
        values = np.concatenate([props, np.asarray(mags)], axis=1)
        return pd.DataFrame(values, columns=cols + [f"{b_}_mag" for b_ in self.bands])

    def isochrone(self, age, feh=0.0, eep_range=None, distance=10.0, AV=0.0, dropna=True):
        """reference: models.py:484-493"""
        if eep_range is None:
            eep_range = self.get_limits("eep")
        eeps = np.arange(*eep_range)
        df = self(eeps, age, feh, distance=distance, AV=AV)
        return df.dropna() if dropna else df

    def model_value(self, mass, age, feh, props, approx=False):
        """reference models.py:447-455; unlike the reference, this delegates
        iso -> track exactly as model_mag does (models.py:458-459) — the
        [mass, eep, feh] ordering below is the TRACK grid's user order, and
        feeding it to an isochrone interpolator reads (eep=mass, age=eep)."""
        if self.eep_replaces == "mass":
            return self.track.model_value(mass, age, feh, props, approx=approx)
        if isinstance(props, str):
            props = [props]
        eep = self.get_eep(mass, age, feh, accurate=not approx)
        values = self.interp_value([mass, eep, feh], props)
        return float(np.squeeze(values)) if np.size(values) == 1 else values

    def model_mag(self, mass, age, feh, distance=10.0, AV=0.0, bands=None, approx=False):
        if self.eep_replaces == "mass":
            return self.track.model_mag(mass, age, feh, distance=distance, AV=AV, bands=bands, approx=approx)
        bands = bands or self.bands
        eep = self.get_eep(mass, age, feh, accurate=not approx)
        _, _, _, mags = self.interp_mag([mass, eep, feh, distance, AV], bands)
        return float(np.squeeze(mags)) if np.size(mags) == 1 else mags

    def mass_age_resid(self, *args, **kwargs):
        raise NotImplementedError


class EvolutionTrackInterpolator(ModelGridInterpolator):
    """Params (mass, eep, feh, distance, AV); grid axes (feh, mass, eep)
    (reference models.py:664-688)."""

    param_names = ("mass", "eep", "feh", "distance", "AV")
    eep_replaces = "age"
    _param_index_order = (2, 0, 1, 3, 4)
    name = "track"

    def __init__(self, *args, iso=None, **kwargs):
        super().__init__(*args, **kwargs)
        self._iso = iso

    def _axis_names(self):
        return ["feh", "mass", "eep"]

    @property
    def iso(self):
        return self._iso

    def mass_age_resid(self, eep, mass, age, feh):
        age_interp = self.interp_value([mass, eep, feh], ["age"])
        return float((age - age_interp) ** 2)

    @property
    def masses(self):
        return np.asarray(self.model.knots[1])


class IsochroneInterpolator(ModelGridInterpolator):
    """Params (eep, age, feh, distance, AV); grid axes (age, feh, eep)
    (reference models.py:691-718)."""

    param_names = ("eep", "age", "feh", "distance", "AV")
    eep_replaces = "mass"
    _param_index_order = (1, 2, 0, 3, 4)
    name = "iso"

    def __init__(self, *args, track=None, **kwargs):
        super().__init__(*args, **kwargs)
        self._track = track

    def _axis_names(self):
        return ["age", "feh", "eep"]

    @property
    def track(self):
        if self._track is None:
            raise ValueError(
                "This IsochroneInterpolator has no linked track interpolator "
                "(construct it with track=..., or use get_ichrone, which "
                "wires both); mass-parameterized entry points (generate, "
                "model_value, model_mag) delegate to it."
            )
        return self._track

    def mass_age_resid(self, eep, mass, age, feh):
        mass_interp = self.interp_value([eep, age, feh], ["initial_mass"])
        return float((mass - mass_interp) ** 2)

    @property
    def ages(self):
        return np.asarray(self.model.knots[0])
