"""Star models (L3) + on-device inference (L4).

Rebuild of ``isochrones/starmodel.py:1361-2127`` (``BasicStarModel``,
``SingleStarModel``, ``BinaryStarModel``, ``TripleStarModel``,
``IsoTrackModel``, ``N_options``/``index_options``) — the modern flat
single/binary/triple fitting path.

Accelerator-first design (vs. the reference's scalar-callback architecture):

* ``lnprior``/``lnlike``/``lnpost`` compose into ONE pure jitted function
  ``lnpost_batch: (B, n_params) -> (B,)`` — the reference evaluates Python
  prior objects and a scalar numba kernel once per MultiNest/emcee callback
  (starmodel.py:1563-1635); here the full posterior stack (grid gathers, BC
  composition, Gaussian terms, prior change-of-variables) is fused by XLA and
  vmapped across walkers/live points, so a whole fit runs on the device.
* ``fit()`` drives fully on-device samplers (``samplers.nested`` replacing
  MultiNest, ``samplers.ensemble`` replacing emcee) instead of crossing into
  Fortran per evaluation (starmodel.py:717-802).
* Reference behavioral quirks are reproduced intentionally (documented below):
  the ``+log(sigma)`` Gaussian constant (likelihood.py:13), the N=3 EEP
  ordering condition (starmodel.py:1621-1624), and the ``delta_nu`` term using
  the *value* as its uncertainty (starmodel.py:1612).
"""

from __future__ import annotations

import itertools
import json
import os
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .device import on_accelerator
from .logger import getLogger
from .ops.likelihood import gauss_lnprob, star_lnlike
from .priors import (
    AgePrior,
    AVPrior,
    ChabrierPrior,
    DistancePrior,
    EEP_prior,
    FehPrior,
)
from .utils import addmags

__all__ = [
    "BasicStarModel",
    "SingleStarModel",
    "BinaryStarModel",
    "TripleStarModel",
    "IsoTrackModel",
    "N_options",
    "index_options",
]


class BasicStarModel:
    """Flat single/binary/triple star model (reference starmodel.py:1361-1989).

    Observations are passed as keyword ``name=(value, uncertainty)`` pairs:
    photometric bands (must exist in the interpolator's BC grid), spectroscopy
    (``Teff``, ``logg``, ``feh``), ``parallax`` [mas], and asteroseismic
    ``nu_max``/``delta_nu`` [uHz].
    """

    use_emcee = False
    #: subclasses with EXPENSIVE likelihoods (cluster marginals, tree
    #: models) set True: fit_multinest then defaults to dynamic NS, where
    #: the ~6x likelihood-call saving is real wall-clock (docs/samplers.md)
    _default_dynamic = False

    # Allowable non-band observation keys (reference starmodel.py:95-116)
    _not_a_band = (
        "RA", "dec", "ra", "Dec", "maxAV", "parallax", "AV", "logg", "Teff",
        "feh", "density", "separation", "PA", "resolution", "relative", "N",
        "index", "id", "nu_max", "delta_nu",
    )

    def __init__(
        self,
        ic,
        eep_bounds=None,
        name="",
        directory=".",
        N=1,
        maxAV=None,
        max_distance=None,
        halo_fraction=None,
        ra=None,
        dec=None,
        obs=None,
        use_emcee=False,
        **kwargs,
    ):
        self._ic = ic
        self._jit_cache: Dict[str, object] = {}
        self.eep_bounds = eep_bounds if eep_bounds is not None else tuple(ic.eep_bounds)
        self.name = str(name)
        self.use_emcee = use_emcee
        self.ra = ra
        self.dec = dec
        self.obs = None

        if N > 1 and ic.eep_replaces == "age":
            raise ValueError("Can only fit multiple stars with IsochroneInterpolator!")
        # Shared-parameter indices per multiplicity (reference starmodel.py:1396-1419)
        if N == 1:
            if ic.eep_replaces == "age":
                self.mass_index = 0
                self.eep_index = 1
            else:
                self.age_index = 1
                self.eep_index = 0
            self.feh_index = 2
            self.distance_index = 3
            self.AV_index = 4
        elif N == 2:
            self.age_index, self.feh_index, self.distance_index, self.AV_index = 2, 3, 4, 5
        elif N == 3:
            self.age_index, self.feh_index, self.distance_index, self.AV_index = 3, 4, 5, 6
        self.N = N

        kwargs.pop("use_emcee", None)
        self.kwargs = {}
        for k, v in kwargs.items():
            try:
                val, unc = v
                if not (np.isnan(float(val)) or np.isnan(float(unc))):
                    self.kwargs[k] = (np.float64(val), np.float64(unc))
            except (TypeError, ValueError):
                getLogger().warning("kwarg %s=%s ignored!", k, v)

        self._bands = None
        self._spec_props = None
        self._props = None
        self._param_names = None

        # Default prior stack (reference starmodel.py:1437-1445)
        self._priors = {
            "mass": ChabrierPrior(),
            "feh": FehPrior(),
            "age": AgePrior(),
            "distance": DistancePrior(),
            "AV": AVPrior(),
        }
        self._priors["eep"] = EEP_prior(self.ic, self._priors[self.ic.eep_replaces], bounds=eep_bounds)

        self._bounds = {
            "mass": None,
            "feh": None,
            "age": None,
            "distance": DistancePrior().bounds,
            "AV": AVPrior().bounds,
            "eep": self._priors["eep"].bounds,
        }
        for par in ["mass", "feh", "age"]:
            self.bounds(par)

        if maxAV is not None:
            self.set_bounds(AV=(0, maxAV))
        if max_distance is not None:
            self.set_bounds(distance=(0, max_distance))
        elif "parallax" in self.kwargs:
            # parallax-derived max distance (reference starmodel.py:1465-1477)
            value, unc = self.kwargs["parallax"]
            if value > 0:
                self.set_bounds(distance=(0, 1.0 / value * 2000))
            elif value < 0:
                self.set_bounds(distance=(0, 1.0 / abs(unc) * 2000))

        if halo_fraction is not None:
            self._priors["feh"] = FehPrior(halo_fraction=halo_fraction)
            self._priors["feh"].bounds = self._bounds["feh"]

        self._directory = str(directory)
        self._samples = None
        self._derived_samples = None
        self._evidence = None
        self._jit_cache: Dict[str, object] = {}

    # ------------------------------------------------------------------ basics
    @property
    def ic(self):
        return self._ic

    @property
    def directory(self):
        return self._directory

    @property
    def labelstring(self):
        return {1: "single", 2: "binary", 3: "triple"}[self.N]

    @property
    def param_names(self) -> Tuple[str, ...]:
        if self._param_names is None:
            names = tuple(self.ic.param_names)
            if self.N == 2:
                names = ("eep_0", "eep_1") + tuple(self.ic.param_names[1:])
            elif self.N == 3:
                names = ("eep_0", "eep_1", "eep_2") + tuple(self.ic.param_names[1:])
            self._param_names = names
        return self._param_names

    @property
    def n_params(self):
        return len(self.param_names)

    @property
    def bands(self):
        if self._bands is None:
            bc_cols = set(self.ic.bc.column_index)
            self._bands = [k for k in self.kwargs if k in bc_cols]
        return self._bands

    @property
    def props(self):
        if self._props is None:
            self._props = [k for k in self.kwargs if k in self._not_a_band]
        return self._props

    @property
    def spec_props(self):
        if self._spec_props is None:
            self._spec_props = [self.kwargs.get(k, (np.nan, np.nan)) for k in ["Teff", "logg", "feh"]]
        return self._spec_props

    # ------------------------------------------------------------- priors/bounds
    def bounds(self, prop):
        """Per-parameter bounds, lazily tightened to grid limits
        (reference starmodel.py:1536-1556)."""
        if prop in ("eep_0", "eep_1", "eep_2"):
            prop = "eep"
        if self._bounds[prop] is not None:
            return self._bounds[prop]
        if prop in ("mass", "feh", "age"):
            lo, hi = self.ic.get_limits(prop)
            self._bounds[prop] = (lo, hi)
            self._priors[prop].bounds = (lo, hi)
        else:
            raise ValueError(f"Unknown property {prop}")
        return self._bounds[prop]

    def set_bounds(self, **kwargs):
        for k, v in kwargs.items():
            self._bounds[k] = tuple(v)
            if k in self._priors and hasattr(self._priors[k], "bounds"):
                try:
                    self._priors[k].bounds = tuple(v)
                except ValueError:
                    pass
        self._jit_cache.clear()

    def set_prior(self, **kwargs):
        for prop, prior in kwargs.items():
            self._priors[prop] = prior
            self._bounds[prop] = prior.bounds
        self._jit_cache.clear()

    # ----------------------------------------------------------- batched kernels
    def _static_obs(self):
        """Gather static observation arrays for closure capture."""
        spec_vals = np.array([v for v, _ in self.spec_props], dtype=float)
        spec_uncs = np.array([u for _, u in self.spec_props], dtype=float)
        if self.bands:
            mag_vals = np.array([self.kwargs[b][0] for b in self.bands], dtype=float)
            mag_uncs = np.array([self.kwargs[b][1] for b in self.bands], dtype=float)
            band_icols = tuple(self.ic.bc.column_index[b] for b in self.bands)
        else:
            mag_vals = np.zeros(0)
            mag_uncs = np.zeros(0)
            band_icols = ()
        return spec_vals, spec_uncs, mag_vals, mag_uncs, band_icols

    def _primary_pars(self, pars):
        """(..., n_params) -> (..., 5) primary-star user-order params."""
        if self.N == 1:
            return pars
        return jnp.concatenate([pars[..., 0:1], pars[..., self.N :]], axis=-1)

    def _build_lnlike_batch(self):
        ic = self.ic
        N = self.N
        spec_vals, spec_uncs, mag_vals, mag_uncs, band_icols = self._static_obs()
        spec_vals = jnp.asarray(spec_vals)
        spec_uncs = jnp.asarray(spec_uncs)
        mag_vals = jnp.asarray(mag_vals)
        mag_uncs = jnp.asarray(mag_uncs)
        index_order = tuple(ic._param_index_order)
        model = ic.model_packed  # hot columns packed contiguously (+EEP-paired)
        bc = getattr(ic, "bc_paired", None) or ic.bc
        model_icols = ic._packed_icols
        full_model = ic.model
        dist_idx = self.distance_index
        kw = self.kwargs
        has_parallax = "parallax" in kw
        has_numax = "nu_max" in kw
        has_delnu = "delta_nu" in kw
        seismo_icols = (
            (full_model.column_index["nu_max"], full_model.column_index["delta_nu"]) if has_numax else None
        )
        from .ops.interp import interp_nd

        def lnlike_batch(pars):
            ll = star_lnlike(
                pars, index_order, spec_vals, spec_uncs, mag_vals, mag_uncs,
                model, model_icols, bc, band_icols, n_stars=N,
            )
            if has_parallax:
                plax, plax_unc = kw["parallax"]
                ll = ll + gauss_lnprob(plax, plax_unc, 1000.0 / pars[..., dist_idx])
            if has_numax:
                prim = self._primary_pars(pars)
                io = index_order
                grid_pts = jnp.stack([prim[..., io[0]], prim[..., io[1]], prim[..., io[2]]], axis=-1)
                vals = interp_nd(
                    full_model.values, full_model.knots, grid_pts,
                    icols=seismo_icols, axis_maps=full_model.axis_maps,
                )
                nu_max, nu_max_unc = kw["nu_max"]
                ll = ll + gauss_lnprob(nu_max, nu_max_unc, vals[..., 0])
                if has_delnu:
                    # NB: reference passes the VALUE as the uncertainty
                    # (starmodel.py:1612) — reproduced for parity.
                    delta_nu, _delta_nu_unc = kw["delta_nu"]
                    ll = ll + gauss_lnprob(delta_nu, delta_nu, vals[..., 1])
            return ll

        return lnlike_batch

    def _build_lnprior_batch(self):
        N = self.N
        priors = self._priors
        param_names = self.param_names
        eep_replaces = self.ic.eep_replaces
        feh_index = self.feh_index
        cond_index = self.mass_index if eep_replaces == "age" else self.age_index

        def lnprior_batch(pars):
            lnp = jnp.zeros(pars.shape[:-1], dtype=pars.dtype)
            # EEP ordering constraints (reference starmodel.py:1617-1624;
            # the N=3 condition is reproduced verbatim, including its
            # `and` instead of `or`).
            if N == 2:
                lnp = jnp.where(pars[..., 1] > pars[..., 0], -jnp.inf, lnp)
            elif N == 3:
                bad = (~(pars[..., 0] > pars[..., 1])) & (pars[..., 1] > pars[..., 2])
                lnp = jnp.where(bad, -jnp.inf, lnp)
            cond_val = pars[..., cond_index]
            feh_val = pars[..., feh_index]
            for i, par in enumerate(param_names):
                val = pars[..., i]
                if par in ("eep", "eep_0", "eep_1", "eep_2"):
                    if eep_replaces == "age":
                        lnp = lnp + priors["eep"].lnpdf_jax(val, mass=cond_val, feh=feh_val)
                    else:
                        lnp = lnp + priors["eep"].lnpdf_jax(val, age=cond_val, feh=feh_val)
                else:
                    lnp = lnp + priors[par].lnpdf_jax(val)
            return lnp

        return lnprior_batch

    def _get_jit(self, name):
        if name not in self._jit_cache:
            lnlike = self._build_lnlike_batch()
            lnprior = self._build_lnprior_batch()
            fused = self._build_lnpost_fused()

            def lnpost(pars):
                lnpr = lnprior(pars)
                ll = lnlike(pars)
                ll = jnp.where(jnp.isnan(ll), -jnp.inf, ll)
                return jnp.where(jnp.isfinite(lnpr), lnpr + ll, -jnp.inf)

            self._jit_cache["lnlike"] = jax.jit(lnlike)
            self._jit_cache["lnprior"] = jax.jit(lnprior)
            self._jit_cache["lnpost"] = jax.jit(fused if fused is not None else lnpost)
        return self._jit_cache[name]

    def _build_lnpost_fused(self):
        """Fused lnprior+lnlike sharing ONE model-grid corner-gather pass:
        the magnitude model and the EEP change-of-variables prior interpolate
        the same (per-component) grid points, so the 2^3 corner gathers are
        paid once over a 6-column packed grid. Falls back to the composed
        path (None) for customized priors or subclasses."""
        from .priors import EEP_prior as _EEP

        ic = self.ic
        if type(self)._build_lnlike_batch is not BasicStarModel._build_lnlike_batch:
            return None
        if type(self)._build_lnprior_batch is not BasicStarModel._build_lnprior_batch:
            return None
        if getattr(ic, "model_packed6", None) is None:
            return None
        eep_prior = self._priors.get("eep")
        if not isinstance(eep_prior, _EEP) or eep_prior.ic is not ic:
            return None

        from .ops.interp import interp_nd

        N = self.N
        spec_vals, spec_uncs, mag_vals, mag_uncs, band_icols = self._static_obs()
        spec_vals = jnp.asarray(spec_vals)
        spec_uncs = jnp.asarray(spec_uncs)
        mag_vals = jnp.asarray(mag_vals)
        mag_uncs = jnp.asarray(mag_uncs)
        io = tuple(ic._param_index_order)
        pack6 = ic.model_packed6
        full_model = ic.model
        bc = getattr(ic, "bc_paired", None) or ic.bc
        kw = self.kwargs
        has_parallax = "parallax" in kw
        has_numax = "nu_max" in kw
        has_delnu = "delta_nu" in kw
        seismo_icols = (
            (full_model.column_index["nu_max"], full_model.column_index["delta_nu"])
            if has_numax else None
        )
        dist_idx = self.distance_index
        priors = self._priors
        param_names = self.param_names
        eep_lo, eep_hi = eep_prior.bounds
        orig_prior = eep_prior.orig_prior
        eep_replaces = ic.eep_replaces
        from .ops.likelihood import stack_components

        def lnpost(pars):
            comp_pars = stack_components(pars, N)  # (..., N, 5) user order
            grid_pts = jnp.stack(
                [comp_pars[..., io[0]], comp_pars[..., io[1]], comp_pars[..., io[2]]], axis=-1
            )
            vals6 = interp_nd(
                pack6.values, pack6.knots, grid_pts, icols=(0, 1, 2, 3, 4, 5),
                axis_maps=pack6.axis_maps, paired=pack6.paired,
            )  # (..., N, 6)
            Teff = vals6[..., 0, 0]
            logg = vals6[..., 0, 1]
            feh = vals6[..., 0, 2]
            mbol = vals6[..., 3]
            orig_val = vals6[..., 4]
            deriv = vals6[..., 5]

            AV = comp_pars[..., io[4]]
            bc_pts = jnp.stack([vals6[..., 0], vals6[..., 1], vals6[..., 2], AV], axis=-1)
            bc_vals = interp_nd(bc.values, bc.knots, bc_pts, icols=band_icols,
                                axis_maps=bc.axis_maps, paired=bc.paired)
            dist_mod = 5.0 * jnp.log10(comp_pars[..., io[3]] / 10.0)
            comp_mags = mbol[..., None] + dist_mod[..., None] - bc_vals  # (..., N, n_bands)
            if N == 1:
                mags = comp_mags[..., 0, :]
            else:
                mags = -2.5 * jnp.log10(jnp.sum(10.0 ** (-0.4 * comp_mags), axis=-2))

            ll = jnp.zeros(pars.shape[:-1], dtype=pars.dtype)
            for k, model_val in enumerate((Teff, logg, feh)):
                # double-where (NaN-safe gradient) — same trap as
                # ops/likelihood.py::star_lnlike: a missing channel is
                # val = NaN, and masking only the forward value still lets
                # reverse-mode multiply the zero cotangent into the NaN
                # d(term)/d(model_val), poisoning the gradient of every
                # parameter the interp depends on (this fused lnpost is the
                # one NUTS differentiates). Substitute a finite dummy
                # INSIDE the term before masking.
                missing = jnp.isnan(spec_vals[k]) | jnp.isnan(spec_uncs[k])
                safe_val = jnp.where(missing, model_val, spec_vals[k])
                safe_unc = jnp.where(missing, jnp.ones_like(spec_uncs[k]), spec_uncs[k])
                term = gauss_lnprob(safe_val, safe_unc, model_val)
                ll = ll + jnp.where(missing, jnp.zeros_like(term), term)
            if len(band_icols):
                ll = ll + jnp.sum(gauss_lnprob(mag_vals, mag_uncs, mags), axis=-1)
            if has_parallax:
                plax, plax_unc = kw["parallax"]
                ll = ll + gauss_lnprob(plax, plax_unc, 1000.0 / pars[..., dist_idx])
            if has_numax:
                prim = self._primary_pars(pars)
                gp = jnp.stack([prim[..., io[0]], prim[..., io[1]], prim[..., io[2]]], axis=-1)
                sv = interp_nd(full_model.values, full_model.knots, gp, icols=seismo_icols,
                               axis_maps=full_model.axis_maps)
                nu_max, nu_max_unc = kw["nu_max"]
                ll = ll + gauss_lnprob(nu_max, nu_max_unc, sv[..., 0])
                if has_delnu:
                    delta_nu, _ = kw["delta_nu"]  # value-as-unc quirk preserved
                    ll = ll + gauss_lnprob(delta_nu, delta_nu, sv[..., 1])

            # ---- prior: shared params + ordering + fused EEP change-of-vars
            lnp = jnp.zeros(pars.shape[:-1], dtype=pars.dtype)
            if N == 2:
                lnp = jnp.where(pars[..., 1] > pars[..., 0], -jnp.inf, lnp)
            elif N == 3:
                bad = (~(pars[..., 0] > pars[..., 1])) & (pars[..., 1] > pars[..., 2])
                lnp = jnp.where(bad, -jnp.inf, lnp)
            eep_j = 0
            for i, par in enumerate(param_names):
                val = pars[..., i]
                if par in ("eep", "eep_0", "eep_1", "eep_2"):
                    ov = orig_val[..., eep_j]
                    dv = deriv[..., eep_j]
                    term = orig_prior.lnpdf_jax(ov) + jnp.log(jnp.maximum(dv, 1e-300))
                    term = jnp.where(jnp.isfinite(ov) & (dv > 0), term, -jnp.inf)
                    term = jnp.where((val < eep_lo) | (val > eep_hi), -jnp.inf, term)
                    lnp = lnp + term
                    eep_j += 1
                else:
                    lnp = lnp + priors[par].lnpdf_jax(val)

            ll = jnp.where(jnp.isnan(ll), -jnp.inf, ll)
            return jnp.where(jnp.isfinite(lnp), lnp + ll, -jnp.inf)

        return lnpost

    @property
    def lnpost_batch(self):
        """Jitted (B, n_params) -> (B,) fused posterior — the hot function."""
        return self._get_jit("lnpost")

    @property
    def lnlike_batch(self):
        return self._get_jit("lnlike")

    @property
    def lnprior_batch(self):
        return self._get_jit("lnprior")

    # ------------------------------------------------------- host scalar API
    def _eval_scalar(self, fn, p):
        p = jnp.asarray(np.asarray(p, dtype=float))[None, :]
        return float(np.asarray(fn(p))[0])

    def lnlike(self, p):
        return self._eval_scalar(self.lnlike_batch, p)

    def lnprior(self, p):
        return self._eval_scalar(self.lnprior_batch, p)

    def lnpost(self, p, **kwargs):
        return self._eval_scalar(self.lnpost_batch, p)

    # ------------------------------------------------------------ transforms
    def _bounds_arrays(self):
        los, his = [], []
        for par in self.param_names:
            lo, hi = self.bounds(par)
            los.append(lo)
            his.append(hi)
        return np.array(los), np.array(his)

    def prior_transform_batch(self, u):
        """Unit cube -> uniform box over parameter bounds
        (reference mnest_prior, starmodel.py:1637-1640). Pure jnp."""
        los, his = self._bounds_arrays()
        los = jnp.asarray(los, dtype=u.dtype)
        his = jnp.asarray(his, dtype=u.dtype)
        return los + (his - los) * u

    def mnest_prior(self, cube, ndim=None, nparams=None):
        """In-place scalar version for API parity."""
        los, his = self._bounds_arrays()
        for i in range(len(self.param_names)):
            cube[i] = (his[i] - los[i]) * cube[i] + los[i]
        return cube

    def mnest_loglike(self, cube, ndim=None, nparams=None):
        return self.lnpost(np.asarray(cube[: self.n_params]))

    # ----------------------------------------------------------------- sampling
    def sample_from_prior(self, n, values=False, require_valid=True, rng=None):
        """Prior predictive draws (reference starmodel.py:1716-1748).

        Unlike the reference (which breaks for N>1), each ``eep_i`` is drawn
        from the conditional EEP prior and sorted descending to satisfy the
        ordering constraint.
        """
        import pandas as pd

        if n == 0:
            return pd.DataFrame(columns=self.param_names)
        rng = np.random.default_rng(rng) if not isinstance(rng, np.random.Generator) else rng

        shared = [p for p in self.param_names if not p.startswith("eep")]
        df = pd.DataFrame({p: self._priors[p].sample(n, rng=rng) for p in shared})

        cond_kw = {"feh": df["feh"].values}
        if self.ic.eep_replaces == "age":
            cond_kw["mass"] = df["mass"].values
        else:
            cond_kw["age"] = df["age"].values

        n_eep = sum(1 for p in self.param_names if p.startswith("eep"))
        eep_draws = np.stack(
            [self._priors["eep"].sample(n, rng=rng, **cond_kw) for _ in range(n_eep)], axis=-1
        )
        eep_draws = -np.sort(-eep_draws, axis=-1)  # descending
        if n_eep == 1:
            df["eep"] = eep_draws[:, 0]
        else:
            for j in range(n_eep):
                df[f"eep_{j}"] = eep_draws[:, j]
        df = df[list(self.param_names)]

        if require_valid:
            lnprob = np.asarray(self.lnpost_batch(jnp.asarray(df.values)))
            bad = ~np.isfinite(lnprob)
            if bad.any():
                new = self.sample_from_prior(int(bad.sum()), require_valid=True, rng=rng)
                df.iloc[np.where(bad)[0], :] = new.values

        return df.values if values else df

    def emcee_p0(self, nwalkers, rng=None):
        """reference starmodel.py:838-884"""
        return self.sample_from_prior(nwalkers, values=True, require_valid=True, rng=rng)

    def maxlike(self, p0, **kwargs):
        """MAP point via scipy Nelder-Mead on -lnpost (reference starmodel.py:821-833)."""
        from scipy.optimize import minimize

        res = minimize(lambda p: -self.lnpost(p), np.asarray(p0, dtype=float), method="Nelder-Mead", **kwargs)
        return res.x

    # ----------------------------------------------------------------- fitting
    def _config_data_repr(self):
        """Stable textual representation of the OBSERVED DATA this model is
        conditioned on; subclasses whose data lives outside ``self.kwargs``
        (the tree model's observation tree, the cluster model's catalog)
        override it so :meth:`_fit_config_hash` actually covers their data."""
        return repr(sorted((k, float(v), float(u)) for k, (v, u) in self.kwargs.items()))

    def _fit_config_hash(self, seed=None):
        """Stable hash of the fitted PROBLEM — observed data
        (:meth:`_config_data_repr`), parameter list, per-parameter bounds,
        and the sampler seed — folded into the NS checkpoint config
        (ADVICE r4: without it, a user who edits star.ini or changes --seed
        and reruns with --resume silently gets the old posterior replayed)."""
        import hashlib

        parts = [
            self._config_data_repr(),
            repr(list(self.param_names)),
            repr([tuple(float(b) for b in self.bounds(p)) for p in self.param_names]),
            repr(None if seed is None else int(seed)),
        ]
        return hashlib.sha256("|".join(parts).encode()).hexdigest()[:16]

    def fit(self, **kwargs):
        """reference dispatch starmodel.py:667-671."""
        if self.use_emcee:
            return self.fit_mcmc(**kwargs)
        return self.fit_multinest(**kwargs)

    def fit_multinest(
        self,
        n_live_points=1000,
        basename=None,
        verbose=False,
        refit=False,
        overwrite=False,
        max_iter=None,
        seed=None,
        **kwargs,
    ):
        """On-device nested sampling (replaces pymultinest.run,
        reference starmodel.py:717-802). Evidence + equal-weight posterior
        conventions match MultiNest outputs.

        Accepts ``mesh=`` (forwarded to :func:`~.samplers.nested.run_nested`):
        a ``jax.sharding.Mesh`` sharding the likelihood fan-out — independent
        runs with ``n_runs > 1``, else the constrained-walk chain batch —
        across devices (the MPI-rank role in the reference's MultiNest).
        Also accepts ``dynamic=True`` (+ ``min_ess=``) for dynamic nested
        sampling: posterior-focused thread runs that reach a posterior-ESS
        target in several times fewer likelihood calls than static
        extension — little wall-clock gain for single cheap-likelihood
        fits, whose batched calls are nearly free, a real win where calls
        are expensive (cluster marginals, tree models, catalog batches;
        docs/samplers.md).

        Checkpoint/resume (the role MultiNest's ``chains/*`` files play in
        the reference, starmodel.py:779-797): ``checkpoint=True`` persists
        the sampler state after every compiled chunk under
        ``<basename or mnest_basename>checkpoint.pkl``; ``checkpoint=<path>``
        uses that path. ``resume=True`` restores from it (implies
        checkpointing) — the completed fit is bitwise-identical to one that
        was never interrupted. ``refit``/``overwrite`` delete the
        checkpoint first (the reference deletes the chains files,
        starmodel.py:775-777), so ``resume`` can never replay a stale fit;
        independently, the checkpoint carries a hash of the observed data,
        bounds, and seed, so resuming after editing star.ini (or changing
        the seed) refuses with a config-mismatch error instead of silently
        returning the old posterior."""
        from .samplers.nested import run_nested

        ckpt = kwargs.pop("checkpoint", None)
        if kwargs.get("resume") and ckpt is None:
            ckpt = True
        if ckpt is True:
            base = basename if basename is not None else self.mnest_basename
            os.makedirs(os.path.dirname(base) or ".", exist_ok=True)
            ckpt = f"{base}checkpoint.pkl"
        if ckpt is not None:
            if (refit or overwrite) and os.path.exists(ckpt):
                os.remove(ckpt)
            kwargs["checkpoint"] = ckpt
            kwargs.setdefault("config_tag", self._fit_config_hash(seed))

        if on_accelerator():
            # fatten the per-step likelihood fan-out by default: 64 live
            # points replaced per scan step x 16 walk chains each = 1024
            # points/dispatch per run (x n_runs) — 8x the engine default's
            # 128, cutting sequential scan steps 64-fold. An accelerator
            # fills only with wide batches; use n_runs=2 and/or larger
            # n_batch to widen further. Statistically safe at any K: the
            # shrinkage schedule uses the exact harmonic batched-K
            # increments (_ln_x_schedule).
            kwargs.setdefault("n_batch", 64)
            kwargs.setdefault("n_chains", 16)
        if (
            self._default_dynamic
            and "dynamic" not in kwargs
            and kwargs.get("n_runs", 1) == 1
        ):
            # expensive-likelihood models (cluster marginals, tree models)
            # default to dynamic NS: its call saving is a wall-clock wash
            # only when calls are nearly free (docs/samplers.md) — here
            # they are not
            kwargs["dynamic"] = True
        key = jax.random.PRNGKey(seed if seed is not None else 0)
        result = run_nested(
            self.lnpost_batch,
            self.prior_transform_batch,
            self.n_params,
            key,
            n_live=n_live_points,
            max_iter=max_iter,
            rng=seed,
            **kwargs,
        )
        self._nested_result = result
        self._evidence = (result.logz, result.logzerr)
        if getattr(result, "truncated", False):
            from .logger import getLogger

            getLogger().warning(
                "fit_multinest: run was ESS-truncated (ess=%.0f) — posterior "
                "quantiles in .samples are unreliable; refit with a larger "
                "max_iter or n_live_points.", result.ess,
            )

        import pandas as pd

        df = pd.DataFrame(result.posterior, columns=list(self.param_names))
        df["lnprob"] = result.logl_posterior
        self._samples = df
        self._derived_samples = None
        return result

    def fit_nuts(
        self,
        n_chains=8,
        n_warmup=500,
        n_samples=500,
        max_depth=8,
        target_accept=0.8,
        seed=None,
        mesh=None,
        eps_jitter=1.0,
    ):
        """On-device No-U-Turn sampling of the posterior (the SURVEY §7
        build-plan NUTS stage). The fused lnpost is differentiable (grid
        interpolation is piecewise-multilinear), so gradients come free from
        autodiff. Sampling runs in a logit-reparametrized unbounded space
        (box bounds -> sigmoid + log-Jacobian) with a dense whitened metric
        from an ensemble warm start. target_accept defaults to Stan's 0.8,
        NOT higher: on gridded posteriors the accept statistic plateaus
        around ~0.85 independent of step size (grid-validity -inf cliffs —
        e.g. past the end-of-track EEP boundary — reject a fixed fraction
        of trajectories no matter how small eps gets), so a target above
        the plateau has no dual-averaging fixed point and the step size
        collapses to the dtype floor (measured, docs/samplers.md "The NUTS
        A_V-tail artifact, resolved"). At 0.8 all five parameters match
        nested sampling at the shared 0.35-sigma parity bar
        (tests/test_sampler_parity.py)."""
        from .samplers.nuts import run_nuts

        n_cloud = max(64, 8 * self.n_params, 2 * n_chains)
        p0 = self.sample_from_prior(n_cloud, values=True, require_valid=True, rng=seed)
        key = jax.random.PRNGKey(seed if seed is not None else 0)
        los, his = self._bounds_arrays()
        res = run_nuts(
            self.lnpost_batch, jnp.asarray(np.asarray(p0, dtype=float)), key,
            n_warmup=n_warmup, n_samples=n_samples, max_depth=max_depth,
            target_accept=target_accept, ensemble_init=500, n_chains=n_chains,
            bounds=np.stack([np.asarray(los, dtype=float), np.asarray(his, dtype=float)], axis=-1),
            mesh=mesh, eps_jitter=eps_jitter,
        )
        import pandas as pd

        flat = res.samples.reshape(-1, self.n_params)
        df = pd.DataFrame(flat, columns=list(self.param_names))
        df["lnprob"] = res.lnp.reshape(-1)
        self._samples = df
        self._derived_samples = None
        self._nuts_result = res
        return df

    def fit_polychord(
        self,
        basename=None,
        verbose=False,
        n_live_points=1000,
        max_iter=None,
        seed=None,
        **kwargs,
    ):
        """On-device PolyChord-parity nested sampling (reference shells out
        to the Fortran PolyChord, starmodel.py:703-715). Independent
        slice-sampling replacement implementation (samplers/polychord.py) —
        cross-checks the MultiNest-role sampler's evidence/posteriors.
        Accepts ``mesh=`` like :meth:`fit_multinest` (forwarded through
        ``run_polychord`` to the shared NS driver)."""
        from .samplers.polychord import run_polychord

        if on_accelerator():
            # same underfill economics as fit_multinest: fatter batched-K
            # replacement per slice step (schedule exact at any K,
            # _ln_x_schedule); slice chains stay at the engine's own default
            kwargs.setdefault("n_batch", 64)
        key = jax.random.PRNGKey(seed if seed is not None else 0)
        result = run_polychord(
            self.lnpost_batch,
            self.prior_transform_batch,
            self.n_params,
            key,
            n_live=n_live_points,
            max_iter=max_iter,
            rng=seed,
            **kwargs,
        )
        self._nested_result = result
        self._evidence = (result.logz, result.logzerr)

        import pandas as pd

        df = pd.DataFrame(result.posterior, columns=list(self.param_names))
        df["lnprob"] = result.logl_posterior
        self._samples = df
        self._derived_samples = None
        return result

    def fit_mcmc(
        self,
        nwalkers=300,
        nburn=200,
        niter=100,
        thin=1,
        p0=None,
        seed=None,
        mesh=None,
        moves="stretch",
        **kwargs,
    ):
        """On-device affine-invariant ensemble MCMC (replaces emcee,
        reference starmodel.py:886-972).

        mesh : optional ``jax.sharding.Mesh`` with a ``walkers`` axis — the
        walker batch shards across devices (data-parallel lnpost; the
        stretch move's complementary-half access becomes an all-gather).
        moves : "stretch" (emcee default), "de", "snooker", "kde", or
        "mixed" (KDE/DE/snooker 0.4/0.4/0.2 — the reference emcee3
        harness mixture, fit.py:110-120; better on correlated posteriors).
        """
        from .samplers.ensemble import run_ensemble

        if p0 is None:
            p0 = self.emcee_p0(nwalkers, rng=seed)
        p0 = jnp.asarray(np.asarray(p0, dtype=float))
        if mesh is not None:
            from .parallel import shard_batch

            p0 = shard_batch(p0, mesh, axis="walkers")
        key = jax.random.PRNGKey(seed if seed is not None else 0)

        key, k_burn = jax.random.split(key)
        _, _, state = run_ensemble(self.lnpost_batch, p0, k_burn, n_steps=nburn, moves=moves)
        chain, ln_chain, state = run_ensemble(
            self.lnpost_batch, state.walkers, state.key, n_steps=niter, thin=thin, moves=moves
        )

        import pandas as pd

        flat = np.asarray(chain).reshape(-1, self.n_params)
        lnp = np.asarray(ln_chain).reshape(-1)
        df = pd.DataFrame(flat, columns=list(self.param_names))
        df["lnprob"] = lnp
        self._samples = df
        self._derived_samples = None
        self._sampler_state = state
        return df

    @property
    def evidence(self):
        """(logZ, logZerr) from the nested-sampling fit (reference
        starmodel.py:804-819 pulls these from the MultiNest Analyzer)."""
        return self._evidence

    @property
    def samples(self):
        if self._samples is None:
            raise AttributeError("No samples yet; run .fit()")
        return self._samples

    @property
    def derived_samples(self):
        if self._derived_samples is None:
            self._make_samples()
        return self._derived_samples

    @property
    def map_pars(self):
        i_max = self.samples.lnprob.idxmax()
        return self.samples.loc[i_max].drop("lnprob").values

    # --------------------------------------------------------- derived samples
    def _make_samples(self):
        """Posterior post-processing: vectorized interpolator calls
        (reference starmodel.py:1653-1714)."""
        import pandas as pd

        df = self.samples
        if self.N == 1:
            self._derived_samples = self.ic(*[df[c].values for c in self.param_names])
        else:
            self._derived_samples = df.copy()
            shared = list(self.ic.param_names[1:])
            comp_dfs = []
            for j in range(self.N):
                comp_params = [f"eep_{j}"] + shared
                comp_df = self.ic(*[df[c].values for c in comp_params])
                column_map = {
                    c: f"{c}_{j}"
                    for c in comp_df.columns
                    if c not in ["eep", f"eep_{j}", "age", "distance", "AV"]
                }
                comp_df = comp_df.rename(columns=column_map).drop(["age", "eep"], axis=1)
                comp_dfs.append(comp_df)
            self._derived_samples = pd.concat([self._derived_samples] + comp_dfs, axis=1)
            for b in self.bands:
                mags = [self._derived_samples[f"{b}_mag_{j}"] for j in range(self.N)]
                self._derived_samples[f"{b}_mag"] = addmags(*mags)

        self._derived_samples["parallax"] = 1000.0 / df["distance"]
        self._derived_samples["distance"] = df["distance"].values
        self._derived_samples["AV"] = df["AV"].values

    @property
    def physical_quantities(self):
        """reference starmodel.py:1756-1794"""
        if self.N == 1:
            return ["mass", "radius", "age", "Teff", "logg", "feh", "distance", "AV"]
        per = [f"{q}_{j}" for q in ("mass", "radius") for j in range(self.N)]
        per += [f"{q}_{j}" for q in ("Teff", "logg") for j in range(self.N)]
        return per + ["age", "feh", "distance", "AV"]

    @property
    def observed_quantities(self):
        """reference starmodel.py:1796-1803"""
        cols = [f"{b}_mag" for b in self.bands]
        if self.N == 1:
            return cols + self.props
        return cols + [p if p in self.derived_samples.columns else f"{p}_0" for p in self.props]

    @property
    def posterior_predictive(self):
        """Mean chi^2 / N over observed quantities (reference starmodel.py:1827-1836)."""
        chisq = 0
        for b in self.bands:
            val, unc = self.kwargs[b]
            chisq += (val - self.derived_samples[f"{b}_mag"]) ** 2 / unc ** 2
        for p in self.props:
            val, unc = self.kwargs[p]
            col = p if p in self.derived_samples.columns else f"{p}_0"
            chisq += (val - self.derived_samples[col]) ** 2 / unc ** 2
        return chisq.mean() / (len(self.bands) + len(self.props))

    # --------------------------------------------------- reference-compat API
    def prior_transform(self, cube):
        """Single-point unit-cube transform (reference starmodel.py:615-628;
        the batched variant is :meth:`prior_transform_batch`)."""
        out = self.prior_transform_batch(jnp.asarray(np.atleast_1d(np.asarray(cube, dtype=float))))
        return np.asarray(out)

    def prior(self, prop, val, **kwargs):
        """Evaluate the prior pdf for ``prop`` (reference starmodel.py:634)."""
        return self._priors[prop](val, **kwargs)

    def lnpost_polychord(self, theta):
        """PolyChord-convention likelihood: ``(lnpost, phi)`` (reference
        starmodel.py:703-706; derived parameters unused)."""
        return float(self.lnpost(theta)), []

    @property
    def mnest_analyzer(self):
        """The nested-sampling result (the reference returns a
        ``pymultinest.Analyzer`` here, starmodel.py:805-811; the on-device
        sampler's :class:`~isochrones_tpu.samplers.nested.NestedResult`
        carries the same evidence/posterior content)."""
        if getattr(self, "_nested_result", None) is None:
            raise ValueError("Must run fit_multinest first.")
        return self._nested_result

    @property
    def sampler(self):
        """Last ensemble-MCMC sampler state (reference starmodel.py:974-981)."""
        if getattr(self, "_sampler_state", None) is not None:
            return self._sampler_state
        raise AttributeError("MCMC must be run to access sampler")

    def fit_mcmc_old(self, **kwargs):
        """Deprecated alias for :meth:`fit_mcmc` (reference
        starmodel.py:889-973)."""
        getLogger().warning("fit_mcmc_old is deprecated; use fit_mcmc.")
        return self.fit_mcmc(**kwargs)

    # ------------------------------------------------------------------- plots
    def corner(self, params, query=None, **kwargs):
        """Corner plot over arbitrary posterior/derived columns (reference
        starmodel.py:1075-1101)."""
        from .plotting import corner as _corner

        df = self.derived_samples if all(
            p in self.derived_samples.columns for p in params
        ) else self.samples
        if query is not None:
            df = df.query(query)
        fig = _corner(df[list(params)], labels=list(params), **kwargs)
        fig.suptitle(self.name, fontsize=22)
        return fig

    def triangle(self, *args, **kwargs):
        """reference starmodel.py:1072"""
        return self.corner(*args, **kwargs)

    def triangle_physical(self, *args, **kwargs):
        """reference starmodel.py:1103"""
        return self.corner_physical(*args, **kwargs)

    def triangle_plots(self, *args, **kwargs):
        """reference starmodel.py:1112"""
        return self.corner_plots(*args, **kwargs)

    def mag_plot(self, *args, **kwargs):
        """reference starmodel.py:1128-1129 (a stub there too)."""
        pass

    def corner_params(self, **kwargs):
        from .plotting import corner as _corner

        fig = _corner(self.samples, labels=list(self.samples.columns), **kwargs)
        fig.suptitle(self.name, fontsize=22)
        return fig

    def corner_derived(self, cols, **kwargs):
        from .plotting import corner as _corner

        fig = _corner(self.derived_samples[cols], labels=cols, **kwargs)
        fig.suptitle(self.name, fontsize=22)
        return fig

    def corner_physical(self, **kwargs):
        return self.corner_derived(self.physical_quantities, **kwargs)

    def corner_plots(self, basename, **kwargs):
        """Save physical+observed corner PNGs (reference starfit.py:128 usage).
        Returns the two figures."""
        import matplotlib.pyplot as plt

        fig1 = self.corner_physical(**kwargs)
        fig1.savefig(f"{basename}_physical.png")
        fig2 = self.corner_observed(**kwargs)
        fig2.savefig(f"{basename}_observed.png")
        plt.close(fig1)
        plt.close(fig2)
        return fig1, fig2

    def random_samples(self, n, rng=None):
        """Random subsample of the posterior (reference starmodel.py:1050-1065)."""
        rng = np.random.default_rng(rng)
        inds = rng.integers(len(self.samples), size=int(n))
        return self.samples.iloc[inds].reset_index(drop=True)

    def corner_observed(self, **kwargs):
        cols = self.observed_quantities
        truths = [self.kwargs[b][0] for b in self.bands] + [self.kwargs[p][0] for p in self.props]
        ranges = [
            (min(t - 0.01, self.derived_samples[c].min()), max(t + 0.01, self.derived_samples[c].max()))
            for t, c in zip(truths, cols)
        ]
        return self.corner_derived(cols, truths=truths, ranges=ranges, **kwargs)

    # ------------------------------------------------------------- persistence
    def write_ini(self, root="."):
        """reference starmodel.py:1486-1499"""
        path = os.path.join(root, self.name)
        os.makedirs(path, exist_ok=True)
        lines = []
        if self.ra is not None and self.dec is not None:
            lines.append(f"ra = {self.ra}")
            lines.append(f"dec = {self.dec}")
        for k, (v, u) in self.kwargs.items():
            lines.append(f"{k} = {v}, {u}")
        with open(os.path.join(path, "star.ini"), "w") as f:
            f.write("\n".join(lines) + "\n")

    def save_hdf(self, filename, path="", overwrite=False, append=False):
        """HDF5 persistence via h5py (reference uses pytables,
        starmodel.py:1843-1901)."""
        import h5py

        mode = "a"
        if os.path.exists(filename):
            with h5py.File(filename, "r") as f:
                key = (path + "/samples").lstrip("/") or "samples"
                exists = key in f
            if exists:
                if overwrite:
                    os.remove(filename)
                elif not append:
                    raise IOError(f"{path} in {filename} exists. Set overwrite or append.")

        samples = self._samples
        derived = self.derived_samples if self._samples is not None else None
        with h5py.File(filename, mode) as f:
            grp = f.require_group(path or "/")
            for key in ("samples", "derived_samples"):
                if key in grp:
                    del grp[key]
            if samples is not None:
                g = grp.create_group("samples")
                g.create_dataset("values", data=samples.values)
                g.attrs["columns"] = json.dumps(list(samples.columns))
                gd = grp.create_group("derived_samples")
                gd.create_dataset("values", data=derived.values.astype(float))
                gd.attrs["columns"] = json.dumps(list(derived.columns))
            grp.attrs["ic_type"] = type(self.ic).__name__
            grp.attrs["ic_bands"] = json.dumps(list(self.ic.bands))
            grp.attrs["use_emcee"] = self.use_emcee
            grp.attrs["kwargs"] = json.dumps({k: [float(v), float(u)] for k, (v, u) in self.kwargs.items()})
            grp.attrs["bounds"] = json.dumps({k: list(v) if v is not None else None for k, v in self._bounds.items()})
            grp.attrs["eep_bounds"] = json.dumps(list(self.eep_bounds))
            grp.attrs["name"] = self.name
            grp.attrs["N"] = self.N
            grp.attrs["directory"] = self.directory
            if self._evidence is not None:
                grp.attrs["evidence"] = json.dumps(list(self._evidence))

    @classmethod
    def load_hdf(cls, filename, path="", name=None, ic=None):
        """Restore a saved model (reference starmodel.py:1903-1959).

        ``ic`` may be passed explicitly; otherwise it is rebuilt via
        ``get_ichrone`` from the stored type name.
        """
        import h5py
        import pandas as pd

        if not os.path.exists(filename):
            raise IOError(f"{filename} does not exist.")
        with h5py.File(filename, "r") as f:
            grp = f[path or "/"]
            kwargs = {k: tuple(v) for k, v in json.loads(grp.attrs["kwargs"]).items()}
            bounds = json.loads(grp.attrs["bounds"])
            eep_bounds = tuple(json.loads(grp.attrs["eep_bounds"]))
            N = int(grp.attrs["N"])
            use_emcee = bool(grp.attrs["use_emcee"])
            stored_name = str(grp.attrs["name"])
            directory = str(grp.attrs["directory"])
            bands = json.loads(grp.attrs["ic_bands"])
            ic_type = str(grp.attrs["ic_type"])
            samples = derived = None
            if "samples" in grp:
                g = grp["samples"]
                samples = pd.DataFrame(np.asarray(g["values"]), columns=json.loads(g.attrs["columns"]))
                gd = grp["derived_samples"]
                derived = pd.DataFrame(np.asarray(gd["values"]), columns=json.loads(gd.attrs["columns"]))
            evidence = json.loads(grp.attrs["evidence"]) if "evidence" in grp.attrs else None

        if ic is None:
            from .isochrone import get_ichrone

            tracks = ic_type == "EvolutionTrackInterpolator"
            try:
                ic = get_ichrone("mist", bands=bands, tracks=tracks)
            except Exception:
                ic = get_ichrone("synthetic", bands=bands, tracks=tracks)

        mod = cls(ic, name=name if name is not None else stored_name, directory=directory,
                  eep_bounds=eep_bounds, N=N, use_emcee=use_emcee, **kwargs)
        mod._samples = samples
        mod._derived_samples = derived
        # restore through set_bounds so prior objects' .bounds stay in sync
        # with the prior-transform box (a plain _bounds.update leaves e.g. a
        # non-default maxAV rejected by lnprior after reload)
        mod.set_bounds(**{k: tuple(v) for k, v in bounds.items() if v is not None})
        for k, v in bounds.items():
            if v is None:
                mod._bounds[k] = None
        if evidence is not None:
            mod._evidence = tuple(evidence)
        return mod

    def write_results(self, corner_kwargs=None, directory=None):
        """HDF + three corner PNGs (reference starmodel.py:1961-1989)."""
        if self._samples is None:
            raise RuntimeError("Run .fit() before .write_results()!")
        directory = directory or self.directory
        corner_kwargs = corner_kwargs or {}
        base = f"{self.name + '-' if self.name else ''}{self.ic.name}-{self.labelstring}-"
        self.save_hdf(os.path.join(directory, base + "starmodel.h5"), overwrite=True)
        for tag, fn in (
            ("params", self.corner_params),
            ("observed", self.corner_observed),
            ("physical", self.corner_physical),
        ):
            fig = fn(**corner_kwargs)
            fig.savefig(os.path.join(directory, f"{base}{tag}.png"))
            import matplotlib.pyplot as plt

            plt.close(fig)

    @property
    def mnest_basename(self):
        s = f"{self.ic.name}-{self.labelstring}"
        if self.name:
            s = f"{self.name}-{s}"
        return os.path.join(self.directory, "chains", s + "-")


class SingleStarModel(BasicStarModel):
    def __init__(self, *args, **kwargs):
        kwargs["N"] = 1
        super().__init__(*args, **kwargs)


class BinaryStarModel(BasicStarModel):
    def __init__(self, *args, **kwargs):
        kwargs["N"] = 2
        super().__init__(*args, **kwargs)


class TripleStarModel(BasicStarModel):
    def __init__(self, *args, **kwargs):
        kwargs["N"] = 3
        super().__init__(*args, **kwargs)


class IsoTrackModel(BasicStarModel):
    """Joint isochrone+track model over (eep, mass, age, feh, distance, AV)
    (reference starmodel.py:2010-2104): sums the fused star lnlike evaluated
    on BOTH grids, with the EEP prior taken w.r.t. the track grid."""

    _iso_track_param_names = ("eep", "mass", "age", "feh", "distance", "AV")

    def __init__(self, iso, track, **kwargs):
        self._iso_ic = iso
        self._track_ic = track
        super().__init__(iso, **kwargs)
        self.set_prior(eep=EEP_prior(self.track, self._priors["age"], bounds=self.eep_bounds))

    @property
    def ic(self):
        return self._track_ic

    @property
    def iso(self):
        return self._iso_ic

    @property
    def track(self):
        return self._track_ic

    @property
    def param_names(self):
        return self._iso_track_param_names

    def _build_lnlike_batch(self):
        iso, track = self.iso, self.track
        spec_vals, spec_uncs, mag_vals, mag_uncs, _ = self._static_obs()
        spec_vals = jnp.asarray(spec_vals)
        spec_uncs = jnp.asarray(spec_uncs)
        mag_vals = jnp.asarray(mag_vals)
        mag_uncs = jnp.asarray(mag_uncs)
        iso_band_icols = tuple(iso.bc.column_index[b] for b in self.bands)
        track_band_icols = tuple(track.bc.column_index[b] for b in self.bands)
        kw = self.kwargs
        has_parallax = "parallax" in kw

        def lnlike_batch(pars):
            # pars: (eep, mass, age, feh, distance, AV)
            iso_pars = jnp.stack(
                [pars[..., 0], pars[..., 2], pars[..., 3], pars[..., 4], pars[..., 5]], axis=-1
            )
            track_pars = jnp.stack(
                [pars[..., 1], pars[..., 0], pars[..., 3], pars[..., 4], pars[..., 5]], axis=-1
            )
            ll = star_lnlike(
                iso_pars, tuple(iso._param_index_order), spec_vals, spec_uncs, mag_vals,
                mag_uncs, iso.model_packed, iso._packed_icols, iso.bc, iso_band_icols, n_stars=1,
            )
            ll = ll + star_lnlike(
                track_pars, tuple(track._param_index_order), spec_vals, spec_uncs, mag_vals,
                mag_uncs, track.model_packed, track._packed_icols, track.bc, track_band_icols, n_stars=1,
            )
            if has_parallax:
                plax, plax_unc = kw["parallax"]
                ll = ll + gauss_lnprob(plax, plax_unc, 1000.0 / pars[..., 4])
            return ll

        return lnlike_batch

    def _build_lnprior_batch(self):
        priors = self._priors
        param_names = self.param_names

        def lnprior_batch(pars):
            lnp = jnp.zeros(pars.shape[:-1], dtype=pars.dtype)
            mass_val = pars[..., 1]
            feh_val = pars[..., 3]
            for i, par in enumerate(param_names):
                val = pars[..., i]
                if par == "eep":
                    lnp = lnp + priors["eep"].lnpdf_jax(val, mass=mass_val, feh=feh_val)
                else:
                    lnp = lnp + priors[par].lnpdf_jax(val)
            return lnp

        return lnprior_batch

    def bounds(self, prop):
        if prop == "eep":
            return self._bounds["eep"]
        if self._bounds[prop] is not None:
            return self._bounds[prop]
        if prop in ("mass", "feh", "age"):
            # mass is a track-grid axis; age/feh ranges must come from the
            # ISO grid (on the track grid "age" is a data column, and its
            # nanmin/nanmax is not the sampling box)
            src = self.track if prop == "mass" else self.iso
            lo, hi = src.get_limits(prop)
            self._bounds[prop] = (lo, hi)
            self._priors[prop].bounds = (lo, hi)
            return self._bounds[prop]
        raise ValueError(f"Unknown property {prop}")


def N_options(N_stars, max_multiples=1, max_stars=2):
    """Enumerate multiplicity configurations (reference starmodel.py:2110-2116)."""
    return [
        N
        for N in itertools.product(np.arange(max_stars) + 1, repeat=N_stars)
        if (np.array(N) > 1).sum() <= max_multiples
    ]


def index_options(N_stars):
    """Enumerate system-index configurations (reference starmodel.py:2119-2127)."""
    if N_stars == 1:
        return [0]
    options = []
    for ind in itertools.product(range(N_stars), repeat=N_stars):
        diffs = np.array(ind[1:]) - np.array(ind[:-1])
        if ind[0] == 0 and diffs.max() <= 1:
            options.append(ind)
    return options
