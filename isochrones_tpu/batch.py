"""Batched many-star fitting — whole catalogs in one XLA program.

The reference scales fleets of independent single-star fits with SLURM job
arrays (``scripts/batch_starfit``) because each MultiNest fit is a serial
process. On an accelerator the natural axis of scale is the batch: this module stacks a
catalog's observations along a star axis and runs ONE jitted ensemble-MCMC
program over ``(n_stars, n_walkers)`` walkers — every star's posterior
advances in lockstep, the fused lnpost evaluates ``n_stars x n_walkers``
points per step, and the device stays saturated. One compile serves the whole
catalog (per-star ``BasicStarModel`` closures would recompile per star).

Per-star observation values (and the parallax-derived distance bound,
reference starmodel.py:1465-1477) are data with a leading star axis; the
model structure (bands, prior families, parameterization) is shared.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from .catalog import StarCatalog
from .logger import getLogger
from .ops.interp import interp_nd
from .ops.likelihood import LOG_ONE_OVER_ROOT_2PI
from .priors import AgePrior, AVPrior, EEP_prior, FehPrior

__all__ = ["BatchStarFitter", "fit_catalog"]

SPEC_PROPS = ("Teff", "logg", "feh")


class BatchStarFitter:
    """Fit every star of a catalog simultaneously (single-star models,
    isochrone parameterization: (eep, age, feh, distance, AV))."""

    param_names = ("eep", "age", "feh", "distance", "AV")

    def __init__(
        self,
        ic,
        catalog,
        bands: Optional[Sequence[str]] = None,
        halo_fraction: float = None,
        maxAV: float = 1.0,
        max_distance: float = 10000.0,
        eep_bounds=None,
    ):
        if ic.eep_replaces != "mass":
            raise ValueError("BatchStarFitter requires an isochrone-parameterized interpolator")
        if not isinstance(catalog, StarCatalog):
            catalog = StarCatalog(catalog)
        self.ic = ic
        self.catalog = catalog
        self.bands = list(bands) if bands is not None else list(catalog.bands)
        S = len(catalog)
        self.n_stars = S

        df = catalog.df
        self.mag_vals = np.stack([df[f"{b}_mag"].values for b in self.bands], axis=-1)
        self.mag_uncs = np.stack([df[f"{b}_mag_unc"].values for b in self.bands], axis=-1)
        self.spec_vals = np.full((S, 3), np.nan)
        self.spec_uncs = np.full((S, 3), np.nan)
        for j, p in enumerate(SPEC_PROPS):
            if p in catalog.props:
                self.spec_vals[:, j], self.spec_uncs[:, j] = catalog.get_measurement(p)
        if "parallax" in catalog.props:
            self.plax_vals, self.plax_uncs = (
                np.asarray(x, dtype=float) for x in catalog.get_measurement("parallax")
            )
        else:
            self.plax_vals = None
            self.plax_uncs = None

        # per-star distance upper bound (reference starmodel.py:1465-1477)
        if self.plax_vals is not None:
            self.max_distance = np.where(
                self.plax_vals > 0, 2000.0 / np.maximum(self.plax_vals, 1e-3), max_distance
            )
        else:
            self.max_distance = np.full(S, float(max_distance))

        # shared priors (the defaults of BasicStarModel, starmodel.py:1437-1445);
        # for isochrone grids the EEP prior converts from the MASS prior
        from .priors import ChabrierPrior

        self.priors = {
            "mass": ChabrierPrior(),
            "age": AgePrior(),
            "feh": FehPrior(**({"halo_fraction": halo_fraction} if halo_fraction is not None else {})),
            "AV": AVPrior(bounds=(0, maxAV)),
        }
        self.priors["mass"].bounds = ic.get_limits("mass")
        self.priors["age"].bounds = ic.get_limits("age")
        self.priors["feh"].bounds = ic.get_limits("feh")
        self.eep_bounds = tuple(eep_bounds) if eep_bounds is not None else tuple(ic.eep_bounds)
        self.priors["eep"] = EEP_prior(ic, self.priors["mass"], bounds=self.eep_bounds)

        self._samples = None
        self._lnpost = None

    # ------------------------------------------------------------- posterior
    @property
    def star_data(self):
        """Per-star observation pytree with a leading star axis — the data
        argument of :meth:`lnpost_data` (vmap over axis 0 for per-star use)."""
        has_plax = self.plax_vals is not None
        return dict(
            spec_vals=jnp.asarray(self.spec_vals)[:, None, :],  # (S, 1, 3)
            spec_uncs=jnp.asarray(self.spec_uncs)[:, None, :],
            mag_vals=jnp.asarray(self.mag_vals)[:, None, :],  # (S, 1, nb)
            mag_uncs=jnp.asarray(self.mag_uncs)[:, None, :],
            plax=(jnp.asarray(self.plax_vals)[:, None] if has_plax else None),
            plax_unc=(jnp.asarray(self.plax_uncs)[:, None] if has_plax else None),
            d_hi=jnp.asarray(self.max_distance)[:, None],  # (S, 1)
        )

    def _build_lnpost(self):
        lnpost_data = self._build_lnpost_data()
        data = self.star_data

        def lnpost(pars):
            return lnpost_data(data, pars)

        return lnpost

    def _build_lnpost_data(self):
        """Fused posterior as ``lnpost(data, pars)`` with the per-star
        observations passed as DATA (leading star axis) — the same kernel
        serves the lockstep-MCMC path (full (S, B, 5) batches) and the
        vmapped per-star nested-sampling path."""
        ic = self.ic
        io = tuple(ic._param_index_order)
        pack6 = ic.model_packed6
        bc = getattr(ic, "bc_paired", None) or ic.bc
        band_icols = tuple(bc.column_index[b] for b in self.bands)
        priors = self.priors
        eep_lo, eep_hi = self.eep_bounds
        age_prior = priors["age"]
        mass_prior = priors["mass"]

        def lnpost(data, pars):
            # pars: (S, B, 5) = (eep, age, feh, distance, AV)
            spec_vals = data["spec_vals"]
            spec_uncs = data["spec_uncs"]
            mag_vals = data["mag_vals"]
            mag_uncs = data["mag_uncs"]
            has_plax = data["plax"] is not None
            if has_plax:
                plax = data["plax"]
                plax_unc = data["plax_unc"]
            d_hi = data["d_hi"]
            user = [pars[..., i] for i in range(5)]
            grid_pts = jnp.stack([user[io[0]], user[io[1]], user[io[2]]], axis=-1)
            vals6 = interp_nd(
                pack6.values, pack6.knots, grid_pts, icols=(0, 1, 2, 3, 4, 5),
                axis_maps=pack6.axis_maps, paired=pack6.paired,
            )  # (S, B, 6)
            Teff, logg, feh_m, mbol, orig_val, deriv = (vals6[..., i] for i in range(6))

            bc_pts = jnp.stack([Teff, logg, feh_m, pars[..., 4]], axis=-1)
            bc_vals = interp_nd(bc.values, bc.knots, bc_pts, icols=band_icols,
                                axis_maps=bc.axis_maps, paired=bc.paired)
            dist_mod = 5.0 * jnp.log10(pars[..., 3] / 10.0)
            mags = mbol[..., None] + dist_mod[..., None] - bc_vals  # (S, B, nb)

            ll = jnp.zeros(pars.shape[:-1], dtype=pars.dtype)
            for k, model_val in enumerate((Teff, logg, feh_m)):
                resid = spec_vals[..., k] - model_val
                term = (
                    LOG_ONE_OVER_ROOT_2PI + jnp.log(spec_uncs[..., k])
                    - 0.5 * resid ** 2 / spec_uncs[..., k] ** 2
                )
                ll = ll + jnp.where(jnp.isnan(spec_vals[..., k]), 0.0, term)
            # NaN measurements contribute nothing (same contract as the spec
            # terms above) — otherwise one NaN band/parallax row poisons that
            # star's lnpost to -inf for EVERY parameter value
            resid = mag_vals - mags
            mag_terms = (
                LOG_ONE_OVER_ROOT_2PI + jnp.log(mag_uncs) - 0.5 * resid ** 2 / mag_uncs ** 2
            )
            ll = ll + jnp.sum(jnp.where(jnp.isnan(mag_vals), 0.0, mag_terms), axis=-1)
            if has_plax:
                r = plax - 1000.0 / pars[..., 3]
                plax_term = (
                    LOG_ONE_OVER_ROOT_2PI + jnp.log(plax_unc) - 0.5 * r ** 2 / plax_unc ** 2
                )
                ll = ll + jnp.where(jnp.isnan(plax), 0.0, plax_term)

            # priors: shared families; per-star distance bound (alpha=2
            # power law from 0: ln p = ln 3 - 3 ln hi + 2 ln d)
            lnp = age_prior.lnpdf_jax(pars[..., 1])
            lnp = lnp + priors["feh"].lnpdf_jax(pars[..., 2])
            lnp = lnp + priors["AV"].lnpdf_jax(pars[..., 4])
            d = pars[..., 3]
            lnp_d = jnp.log(3.0) - 3.0 * jnp.log(d_hi) + 2.0 * jnp.log(jnp.maximum(d, 1e-300))
            lnp = lnp + jnp.where((d > 0) & (d < d_hi), lnp_d, -jnp.inf)
            # change of variables: p(eep) = p_mass(m(eep)) |dm/dEEP|
            eep_term = mass_prior.lnpdf_jax(orig_val) + jnp.log(jnp.maximum(deriv, 1e-300))
            eep_term = jnp.where(jnp.isfinite(orig_val) & (deriv > 0), eep_term, -jnp.inf)
            eep_term = jnp.where((pars[..., 0] < eep_lo) | (pars[..., 0] > eep_hi), -jnp.inf, eep_term)
            lnp = lnp + eep_term

            ll = jnp.where(jnp.isnan(ll), -jnp.inf, ll)
            return jnp.where(jnp.isfinite(lnp), lnp + ll, -jnp.inf)

        return lnpost

    # ------------------------------------------------------- nested sampling
    def _bounds_arrays(self):
        """Per-star parameter boxes: (los (5,), his (S, 5))."""
        los = np.array([
            self.eep_bounds[0],
            self.priors["age"].bounds[0],
            self.priors["feh"].bounds[0],
            0.0,
            self.priors["AV"].bounds[0],
        ])
        his_shared = np.array([
            self.eep_bounds[1],
            self.priors["age"].bounds[1],
            self.priors["feh"].bounds[1],
            0.0,  # per-star below
            self.priors["AV"].bounds[1],
        ])
        his = np.broadcast_to(his_shared, (self.n_stars, 5)).copy()
        his[:, 3] = self.max_distance
        return los, his

    def fit_multinest(
        self,
        n_live_points=500,
        max_iter=None,
        n_batch=8,
        n_chains=8,
        n_repeat=24,
        n_equal=2000,
        dlogz=0.01,
        min_ess=100.0,
        seed=None,
        mesh=None,
        dynamic=False,
        posterior_frac=0.025,
        max_dynamic_rounds=8,
        checkpoint=None,
        resume=False,
    ):
        """Per-star nested sampling for the WHOLE catalog, vmapped across the
        star axis — every chunk of shrinkage iterations is one XLA program
        advancing all S stars' live sets in lockstep (the reference's
        SLURM-array-of-MultiNest-runs collapsed onto one chip). Returns a
        dict with per-star ``logz``/``logzerr``/``ess`` arrays and sets
        ``self.samples`` to (S, n_equal, 5) equal-weight posterior draws.

        mesh : optional ``jax.sharding.Mesh`` — shards the star axis over the
        mesh's first axis (the reference's SLURM-array role over chips,
        scripts/batch_starfit): each device advances its block of stars'
        live sets with zero communication, so sharded == unsharded exactly.

        checkpoint/resume : persist the whole-catalog sampler state to
        ``checkpoint`` (a path) after every compiled chunk; ``resume=True``
        restores from it and the completed fit is bitwise-identical to an
        uninterrupted one (the per-star live-point init is recomputed, then
        discarded in favor of the restored state).
        """
        from .samplers.nested import run_nested_vmapped

        S, n_live = self.n_stars, int(n_live_points)
        rng = np.random.default_rng(seed)
        lnpost_data = self._build_lnpost_data()
        data = self.star_data
        los, his = self._bounds_arrays()
        los_j = jnp.asarray(los)

        def star_lnlike(data_s, hi, u):
            # u: (B, 5) unit cube for ONE star -> lnpost at box params
            pars = los_j[None, :] + (hi[None, :] - los_j[None, :]) * u
            # lnpost_data expects a leading star axis; add a singleton
            data_1 = jax.tree_util.tree_map(
                lambda x: x[None] if x is not None else None, data_s,
                is_leaf=lambda x: x is None,
            )
            return lnpost_data(data_1, pars[None])[0]

        def make_lnlike_u(data_m):
            data_s, hi = data_m
            return lambda u: star_lnlike(data_s, hi, u)

        # ---- initialize live points (full-batch resample of -inf starts)
        u0 = rng.random((S, n_live, 5))
        lnl = np.asarray(
            self.lnpost_batch(jnp.asarray(los[None, None] + (his[:, None] - los[None, None]) * u0))
        )
        lnl = np.where(np.isnan(lnl), -np.inf, lnl)
        for _ in range(200):
            bad = ~np.isfinite(lnl)
            if not bad.any():
                break
            u_new = rng.random((S, n_live, 5))
            l_new = np.asarray(
                self.lnpost_batch(jnp.asarray(los[None, None] + (his[:, None] - los[None, None]) * u_new))
            )
            l_new = np.where(np.isnan(l_new), -np.inf, l_new)
            take = bad & np.isfinite(l_new)
            u0 = np.where(take[..., None], u_new, u0)
            lnl = np.where(take, l_new, lnl)
        if not np.isfinite(lnl).all():
            getLogger().warning(
                "fit_multinest: %d live points still invalid after init resampling",
                int((~np.isfinite(lnl)).sum()),
            )

        out = run_nested_vmapped(
            make_lnlike_u, (data, jnp.asarray(his)), u0, lnl,
            n_live=n_live, n_batch=n_batch, n_chains=n_chains,
            n_repeat=n_repeat, n_equal=n_equal, dlogz=dlogz, min_ess=min_ess,
            max_iter=max_iter, seed=seed, rng=rng, mesh=mesh, label="star",
            dynamic=dynamic, posterior_frac=posterior_frac,
            max_dynamic_rounds=max_dynamic_rounds,
            checkpoint=checkpoint, resume=resume,
        )

        # unit cube -> per-star parameter boxes (NaN no-support rows propagate)
        self._samples = los[None, None] + (his[:, None] - los[None, None]) * out["samples_u"]
        self._lnprob = out["lnl"]
        self._evidence = (out["logz"], out["logzerr"])
        return dict(
            logz=out["logz"], logzerr=out["logzerr"], ess=out["ess"],
            n_dead=out["n_dead"], converged=out["converged"],
            dynamic_rounds=out["dynamic_rounds"],
        )

    @property
    def evidence(self):
        """(logz, logzerr) per-star arrays from fit_multinest."""
        if getattr(self, "_evidence", None) is None:
            raise AttributeError("No evidence yet; run .fit_multinest()")
        return self._evidence

    @property
    def lnpost_batch(self):
        """Jitted (S, B, 5) -> (S, B) fused posterior over all stars."""
        if self._lnpost is None:
            self._lnpost = jax.jit(self._build_lnpost())
        return self._lnpost

    # --------------------------------------------------------------- sampling
    def sample_p0(self, n_walkers, rng=None, max_rounds=50):
        """(S, W, 5) prior draws, rejection-refined to finite lnpost."""
        rng = np.random.default_rng(rng)
        S, W = self.n_stars, n_walkers

        def draw():
            age = self.priors["age"].sample(S * W, rng=rng)
            feh = self.priors["feh"].sample(S * W, rng=rng)
            AV = self.priors["AV"].sample(S * W, rng=rng)
            u = rng.random(S * W)
            d = (u ** (1.0 / 3.0)) * np.repeat(self.max_distance, W)  # CDF^-1 of d^2
            eep = self.priors["eep"].sample(S * W, rng=rng, age=age, feh=feh)  # iso: conditioned on (age, feh)
            return np.stack([eep, age, feh, d, AV], axis=-1).reshape(S, W, 5)

        p0 = draw()
        lnp = np.asarray(self.lnpost_batch(jnp.asarray(p0)))
        bad = ~np.isfinite(lnp)
        rounds = 0
        while bad.any() and rounds < max_rounds:
            fresh = draw()
            p0 = np.where(bad[..., None], fresh, p0)
            lnp = np.asarray(self.lnpost_batch(jnp.asarray(p0)))
            bad = ~np.isfinite(lnp)
            rounds += 1
        if bad.any():
            getLogger().warning("%d walkers still invalid after %d rounds", bad.sum(), rounds)
        return p0

    def fit_mcmc(self, nwalkers=128, nburn=500, niter=100, thin=1, seed=None, mesh=None):
        """One jitted program advancing every star's ensemble in lockstep.

        Returns samples of shape (n_stars, kept_steps * n_walkers, 5).
        mesh : optional ``jax.sharding.Mesh`` — shards the STAR axis (each
        device advances its block of stars' independent ensembles; zero
        communication, like :meth:`fit_multinest`'s star sharding)."""
        from .samplers.ensemble import run_ensemble_batch

        lnpost = self.lnpost_batch
        if mesh is not None:  # shard the (S, W, 5) star axis
            from .parallel import mesh_wrap_fn

            lnpost = mesh_wrap_fn(lnpost, mesh)

        p0 = jnp.asarray(self.sample_p0(nwalkers, rng=seed))
        key = jax.random.PRNGKey(seed if seed is not None else 0)
        key, k_burn = jax.random.split(key)
        _, _, state = run_ensemble_batch(lnpost, p0, k_burn, n_steps=nburn)
        chain, ln_chain, state = run_ensemble_batch(
            lnpost, state[1], state[0], n_steps=niter, thin=thin
        )
        # (T, S, W, P) -> (S, T*W, P)
        chain = np.asarray(chain)
        ln_chain = np.asarray(ln_chain)
        T = chain.shape[0]
        samples = np.moveaxis(chain, 0, 1).reshape(self.n_stars, T * chain.shape[2], 5)
        lnp = np.moveaxis(ln_chain, 0, 1).reshape(self.n_stars, -1)
        self._samples = samples
        self._lnprob = lnp
        return samples

    @property
    def samples(self):
        if self._samples is None:
            raise AttributeError("No samples yet; run .fit_mcmc() or .fit_multinest()")
        return self._samples

    def summary(self, qs=(0.16, 0.5, 0.84)):
        """Per-star quantile table (the starfit-summarize product)."""
        import pandas as pd

        rows = {}
        for i, p in enumerate(self.param_names):
            quants = np.quantile(self.samples[:, :, i], qs, axis=1)
            for q, arr in zip(qs, quants):
                rows[f"{p}_{q * 100:02.0f}"] = arr
        df = pd.DataFrame(rows)
        df.index = self.catalog.df.index
        return df


def fit_catalog(
    ic, catalog, method="mcmc", nwalkers=128, nburn=500, niter=100,
    n_live_points=500, seed=None, **kwargs,
):
    """Convenience: fit every star of ``catalog`` at once; returns
    (BatchStarFitter, per-star quantile summary).

    method : "mcmc" (lockstep ensembles) or "nested" (per-star vmapped
        nested sampling — also yields per-star evidences in
        ``fitter.evidence`` for catalog-scale model comparison).
    derived : include derived physical quantiles (mass, radius, Teff, ...)
        via one batched interpolator dispatch (summary.summarize_batch).
    dynamic : (nested only) family-wide dynamic NS — posterior threads lift
        every star's posterior ESS to target (run_nested_vmapped docs)."""
    derived = kwargs.pop("derived", True)
    mesh = kwargs.pop("mesh", None)
    dynamic = kwargs.pop("dynamic", False)
    fitter = BatchStarFitter(ic, catalog, **kwargs)
    if method == "nested":
        fitter.fit_multinest(
            n_live_points=n_live_points, seed=seed, mesh=mesh, dynamic=dynamic
        )
    else:
        fitter.fit_mcmc(nwalkers=nwalkers, nburn=nburn, niter=niter, seed=seed, mesh=mesh)
    from .summary import summarize_batch

    summary = summarize_batch(fitter, qs=(0.16, 0.5, 0.84), derived=derived)
    return fitter, summary
