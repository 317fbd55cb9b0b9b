"""Star-cluster hierarchical models.

Rebuild of ``isochrones/cluster.py`` (``StarClusterModel`` cluster.py:182-411,
``SimulatedCluster`` cluster.py:71-179, ``simulate_cluster`` cluster.py:414-477,
``clusterfit`` driver cluster.py:20-68).

Design: the 7-parameter cluster likelihood — per-star properties,
the (Nstars, Neep, Neep) binary-mixture photometric grid, and the double
trapezoid marginalization — is ONE jitted XLA program over a static EEP
ladder (:mod:`isochrones_tpu.ops.cluster`). Invalid ladder entries (NaN grid
holes) are masked instead of dynamically sliced, so shapes stay static under
``jit``. Batched posterior evaluation maps over walkers with ``lax.map`` to
bound the (B, Nstars, Neep^2) memory footprint. The reference's MPI broadcast
fan-out (cluster.py:65-67) is unnecessary: the sampler and likelihood run on
one device, and multi-device scaling shards the star axis (see
``isochrones_tpu.parallel``).
"""

from __future__ import annotations

from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .catalog import StarCatalog
from .logger import getLogger
from .ops.cluster import cluster_lnlike, kernel_path
from .ops.interp import interp_nd
from .ops.mags import interp_mag as _interp_mag_kernel
from .priors import (
    FehPrior,
    FlatLogPrior,
    FlatPrior,
    GaussianPrior,
    PowerLawPrior,
)
from .starmodel import BasicStarModel
from .utils import addmags

__all__ = ["StarClusterModel", "SimulatedCluster", "simulate_cluster", "clusterfit"]


class StarClusterModel(BasicStarModel):
    """Hierarchical 7-parameter cluster model
    (age, feh, distance, AV, alpha, gamma, fB) — reference cluster.py:182-411.

    Each member star is marginalized over its (primary EEP, secondary EEP)
    plane with a binary-fraction photometric mixture, a power-law(alpha)
    primary-mass prior (with the |dm/dEEP| Jacobian), and a power-law(gamma)
    mass-ratio prior.
    """

    _cluster_param_names = ("age", "feh", "distance", "AV", "alpha", "gamma", "fB")
    #: per-call cluster marginals are expensive -> dynamic NS by default
    #: (override with fit(dynamic=False))
    _default_dynamic = True

    def _config_data_repr(self):
        """Cluster data lives in the StarCatalog, not ``self.kwargs`` —
        hash the catalog table plus the marginalization geometry so a
        --resume against changed member data/ladder refuses instead of
        replaying the stale checkpoint (self-review r5)."""
        return "|".join([
            self.stars.df.to_csv(index=True),
            repr((self._eep_bounds, self._mass_bounds, self.minq,
                  self.eep_step, self.q_jacobian)),
        ])

    def __init__(
        self,
        ic,
        stars,
        name="",
        halo_fraction=0.5,
        max_AV=1.0,
        max_distance=50000,
        use_emcee=False,
        eep_bounds=None,
        mass_bounds=None,
        minq=0.1,
        directory=".",
        mesh=None,
        q_jacobian=False,
        eep_step=1.0,
        use_pallas=None,
        **kwargs,
    ):
        self._jit_cache: Dict[str, object] = {}
        #: cluster-marginal path (ops/cluster.py::kernel_path): None picks
        #: the compiled Pallas kernel on a GPU in float32 and the XLA grid
        #: path elsewhere; False forces the XLA grid path
        self.use_pallas = use_pallas
        self._ic = ic
        #: optional jax.sharding.Mesh — shards the STAR axis across devices
        #: (each device owns a block of stars' (Neep, Neep) grids; the total
        #: lnlike is a psum of scalars). SURVEY §2.8/§5 sharding axis.
        self.mesh = mesh
        #: False = exact reference-parity marginalization (the reference
        #: omits the |dq/deep2| change-of-variables factor on the mass-ratio
        #: prior, cluster_utils.py:101 — measured to bias fitted fB ~0.3 ->
        #: ~0.5 against q-space simulations). True = corrected generative
        #: density (see ops/cluster.py calc_lnlike_grid; cluster mini-SBC
        #: validates this mode).
        self.q_jacobian = bool(q_jacobian)
        #: EEP-ladder spacing for the (eep1, eep2) marginalization. The
        #: reference hard-codes integer EEPs; at few-mmag photometric
        #: precision a star's likelihood peak along the ladder (width
        #: ~ unc / |dmag/dEEP|) is NARROWER than 1 EEP for evolved stars,
        #: the trapezoid misses the single-star peak, and the 2-d binary
        #: component absorbs it (fB biased high — docs/cluster.md). Set
        #: e.g. 0.25 to resolve; cost grows as 1/step^2 (the GPU kernel
        #: streams the plane without materializing it).
        self.eep_step = float(eep_step)
        if not isinstance(stars, StarCatalog):
            stars = StarCatalog(stars, **kwargs)
        self.stars = stars

        # priors (reference cluster.py:207-215)
        self._priors = {
            "age": FlatLogPrior(bounds=(6, 10.15)),
            "feh": FehPrior(halo_fraction=halo_fraction),
            "AV": FlatPrior(bounds=(0, max_AV)),
            "distance": PowerLawPrior(alpha=2.0, bounds=(0, max_distance)),
            "alpha": FlatPrior(bounds=(-4, -1)),
            "gamma": GaussianPrior(0.3, 0.1),
            "fB": FlatPrior(bounds=(0.0, 0.6)),
        }
        self._bounds = {}
        self.use_emcee = use_emcee
        self._eep_bounds = eep_bounds
        self._mass_bounds = mass_bounds
        self.minq = minq
        self.name = str(name)
        self.N = None
        self.kwargs = {}
        self._samples = None
        self._derived_samples = None
        self._evidence = None
        self._directory = str(directory)

    @property
    def param_names(self):
        return self._cluster_param_names

    @property
    def n_params(self):
        return len(self.param_names)

    @property
    def bands(self):
        return self.stars.bands

    @property
    def props(self):
        return self.stars.props

    @property
    def labelstring(self):
        return "cluster" + (f"_{self.name}" if self.name else "")

    def bounds(self, prop):
        """reference cluster.py:241-259; the inherited ``set_bounds``
        writes ``self._bounds``, which takes precedence (it also clears the
        jit cache, so the marginalization ladder rebuilds)."""
        override = getattr(self, "_bounds", {}).get(prop)
        if override is not None:
            return override
        if prop == "eep":
            return self._eep_bounds if self._eep_bounds is not None else (self.ic.mineep, self.ic.maxeep)
        if prop == "mass":
            return self._mass_bounds if self._mass_bounds is not None else (self.ic.minmass, self.ic.maxmass)
        prior = self._priors[prop]
        b = getattr(prior, "bounds", None)
        if b is not None and np.isfinite(b).all():
            return b
        if prop == "age":
            return (self.ic.minage, self.ic.maxage)
        if prop == "feh":
            return (self.ic.minfeh, self.ic.maxfeh)
        if prop == "gamma":
            return (0, 1)
        if prop == "fB":
            return (0, 1)
        return b

    # ----------------------------------------------------------- batched fns
    def _build_lnprior_batch(self):
        priors = self._priors
        names = self.param_names

        def lnprior_batch(p):
            lnp = jnp.zeros(p.shape[:-1], dtype=p.dtype)
            for i, par in enumerate(names):
                lnp = lnp + priors[par].lnpdf_jax(p[..., i])
            return lnp

        return lnprior_batch

    def _build_block_lnmarg(self):
        """Dataset-parametric core: the per-star marginal ln-likelihoods as a
        pure function of the photometry/property stacks. Everything closed
        over is model structure (grid, EEP ladder, prop layout, bounds) — NOT
        catalog data — so the returned function can be vmapped over many
        datasets sharing one program (cluster SBC, batched refits)."""
        ic = self.ic
        mineep, maxeep = self.bounds("eep")
        eeps = float(mineep) + self.eep_step * jnp.arange(self._n_ladder)
        io = tuple(ic._param_index_order)
        model = ic.model
        bc = ic.bc
        ci = model.column_index
        i_mass = ci["initial_mass"]
        i_dm = ci["dm_deep"]
        band_icols = tuple(bc.column_index[b] for b in self.bands)
        mass_lo, mass_hi = self.bounds("mass")
        minq = self.minq
        prop_names = [p for p, _ in self.stars.iter_props()]
        prop_meta = [(p == "parallax", None if p == "parallax" else ci[p]) for p in prop_names]

        from .ops.cluster import cluster_lnmarginal

        def block_lnmarg(p, mv, mu, pv, pu):
            """Per-star marginal ln-likelihoods for one block of stars. The
            EEP-ladder model evaluations are star-independent (duplicated per
            shard; cheap)."""
            age, feh, distance, AV, alpha, gamma, fB = (p[i] for i in range(7))
            n_eep = eeps.shape[0]
            user = [eeps, jnp.broadcast_to(age, (n_eep,)), jnp.broadcast_to(feh, (n_eep,))]
            grid_pts = jnp.stack([user[io[0]], user[io[1]], user[io[2]]], axis=-1)
            mvals = interp_nd(model.values, model.knots, grid_pts, icols=(i_mass, i_dm), axis_maps=model.axis_maps)
            masses = mvals[..., 0]
            ln_dm = jnp.log(jnp.abs(mvals[..., 1]))

            pts5 = jnp.stack(
                [
                    eeps,
                    jnp.broadcast_to(age, (n_eep,)),
                    jnp.broadcast_to(feh, (n_eep,)),
                    jnp.broadcast_to(distance, (n_eep,)),
                    jnp.broadcast_to(AV, (n_eep,)),
                ],
                axis=-1,
            )
            _, _, _, model_mags = _interp_mag_kernel(
                pts5, io, ic.model_packed, ic._packed_icols, bc, band_icols
            )  # (Neep, Nbands)

            # per-star property lnlike matrix (S_block, Neep)
            # (reference cluster.py:316-325; constant-free Gaussians)
            n_blk = mv.shape[0]
            lnlike_prop = jnp.zeros((n_blk, n_eep), dtype=p.dtype)
            for j, (is_plax, icol) in enumerate(prop_meta):
                if is_plax:
                    model_v = jnp.broadcast_to(1000.0 / distance, (n_eep,))
                else:
                    model_v = interp_nd(model.values, model.knots, grid_pts, icols=(icol,), axis_maps=model.axis_maps)[..., 0]
                z = (pv[:, j : j + 1] - model_v[None, :]) / pu[:, j : j + 1]
                lnlike_prop = lnlike_prop - 0.5 * z * z

            finite = (
                jnp.isfinite(masses)
                & jnp.isfinite(ln_dm)
                & jnp.all(jnp.isfinite(model_mags), axis=-1)
            )
            # primary rows live inside the mass-prior box; SECONDARY rows
            # are constrained only through q >= minq (the reference's
            # semantics, cluster_utils.py:69-70) — restricting the k axis
            # to the primary box silently reclassified binaries with
            # secondaries below mass_lo as singles
            valid = finite & (masses >= mass_lo) & (masses <= mass_hi)
            lnlike_prop = jnp.nan_to_num(lnlike_prop, nan=-jnp.inf)
            ln_dm_safe = jnp.where(finite, ln_dm, 0.0)
            masses_safe = jnp.where(finite, masses, 1.0)

            return cluster_lnmarginal(
                lnlike_prop, jnp.where(finite[:, None], model_mags, 0.0), masses_safe,
                ln_dm_safe, eeps, mv, mu, alpha, gamma, fB, mass_lo, mass_hi, minq,
                valid=valid, q_jacobian=self.q_jacobian, valid_k=finite,
                use_pallas=self.use_pallas,
            )  # (S_block,) — Pallas kernel on a GPU, XLA grid path elsewhere

        return block_lnmarg

    @property
    def _n_ladder(self):
        """Marginalization-ladder length. Count-based: arange(min, max +
        step, step) would overshoot maxeep for non-divisor steps (or via
        float rounding), integrating likelihood mass outside the declared
        eep bounds box."""
        mineep, maxeep = self.bounds("eep")
        return int(np.floor((float(maxeep) - float(mineep)) / self.eep_step + 1e-9)) + 1

    def _build_lnlike_dataset(self):
        """Cluster ln-likelihood as a pure function of the observations:
        ``lnlike(p (7,), mag_vals (S, B), mag_uncs (S, B), prop_vals (S, P),
        prop_uncs (S, P)) -> scalar``. vmap it over a leading dataset axis to
        fit M simulated replicas of this model in ONE program (cluster SBC
        via :func:`~isochrones_tpu.samplers.nested.run_nested_vmapped`)."""
        block_lnmarg = self._build_block_lnmarg()

        def lnlike_dataset(p, mv, mu, pv, pu):
            lnmarg = block_lnmarg(p, mv, mu, pv, pu)
            good = jnp.isfinite(lnmarg)
            total = jnp.sum(jnp.where(good, lnmarg, 0.0))
            return jnp.where(good.all(), total, -jnp.inf)

        return lnlike_dataset

    def _build_lnlike_batch(self):
        block_lnmarg = self._build_block_lnmarg()
        n_ladder = self._n_ladder

        def block_lnlike(p, mv, mu, pv, pu, w):
            lnmarg = block_lnmarg(p, mv, mu, pv, pu)
            ok = w > 0
            good = jnp.isfinite(lnmarg)
            partial = jnp.sum(jnp.where(ok & good, lnmarg, 0.0))
            n_bad = jnp.sum(ok & ~good)
            return partial, n_bad

        # ---- stack per-star observation arrays (star axis leading for sharding)
        mag_vals_np, mag_uncs_np, prop_vals_np, prop_uncs_np = self.stars.observation_stacks()
        if np.isnan(mag_vals_np).any():
            getLogger().warning(
                "StarClusterModel: %d stars have NaN photometry; the cluster "
                "likelihood will be -inf everywhere. Drop those rows.",
                int(np.isnan(mag_vals_np).any(axis=1).sum()),
            )
        n_stars = mag_vals_np.shape[0]
        star_w_np = np.ones(n_stars)

        mesh = self.mesh
        if mesh is not None:
            axis = mesh.axis_names[0]
            n_dev = mesh.shape[axis]
            pad = (-n_stars) % n_dev
            if pad:  # ghost stars with zero weight
                mag_vals_np = np.concatenate([mag_vals_np, np.zeros((pad, mag_vals_np.shape[1]))])
                mag_uncs_np = np.concatenate([mag_uncs_np, np.ones((pad, mag_uncs_np.shape[1]))])
                prop_vals_np = np.concatenate([prop_vals_np, np.zeros((pad, prop_vals_np.shape[1]))])
                prop_uncs_np = np.concatenate([prop_uncs_np, np.ones((pad, prop_uncs_np.shape[1]))])
                star_w_np = np.concatenate([star_w_np, np.zeros(pad)])

        mag_vals = jnp.asarray(mag_vals_np)
        mag_uncs = jnp.asarray(mag_uncs_np)
        prop_vals = jnp.asarray(prop_vals_np)
        prop_uncs = jnp.asarray(prop_uncs_np)
        star_w = jnp.asarray(star_w_np)

        # per-star support diagnostic (host path; see star_lnmarginals)
        self._star_lnmarg_fn = jax.jit(
            lambda p: (block_lnmarg(p, mag_vals, mag_uncs, prop_vals, prop_uncs), star_w > 0)
        )

        if mesh is None:
            def lnlike_one(p):
                partial, n_bad = block_lnlike(p, mag_vals, mag_uncs, prop_vals, prop_uncs, star_w)
                return jnp.where(n_bad > 0, -jnp.inf, partial)
        else:
            from jax import shard_map
            from jax.sharding import PartitionSpec as P

            axis = mesh.axis_names[0]

            def shard_fn(p, mv, mu, pv, pu, w):
                partial, n_bad = block_lnlike(p, mv, mu, pv, pu, w)
                partial = jax.lax.psum(partial, axis)
                n_bad = jax.lax.psum(n_bad, axis)
                return jnp.where(n_bad > 0, -jnp.inf, partial)

            # check_vma=False: the Pallas kernel's outputs (and its
            # interpreter's slices) carry no varying-axis annotation; the
            # psums above make the result replicated either way
            sharded = shard_map(
                shard_fn,
                mesh=mesh,
                in_specs=(P(), P(axis, None), P(axis, None), P(axis, None), P(axis, None), P(axis)),
                out_specs=P(),
                check_vma=False,
            )

            def lnlike_one(p):
                return sharded(p, mag_vals, mag_uncs, prop_vals, prop_uncs, star_w)

        # memory-bounded chunked vmap, keyed on the path the marginal takes
        # (ops/cluster.py::kernel_path). XLA grid path: each walker
        # materializes a (Nstars, Neep^2) plane. Pallas kernel: only the
        # (Neep^2) q-prior/weight planes per walker — the star plane never
        # leaves the kernel — so far larger chunks fit.
        if kernel_path(mag_vals.dtype, self.use_pallas):
            per_walker = max(3 * n_ladder * n_ladder + n_stars * n_ladder, 1)
        else:
            per_walker = max(n_stars * n_ladder * n_ladder, 1)
        max_parallel = max(1, (1 << 27) // per_walker)

        def lnlike_batch(p):
            if p.ndim == 1:
                return lnlike_one(p)
            flat = p.reshape(-1, p.shape[-1])
            B = flat.shape[0]
            if B <= max_parallel:
                out = jax.vmap(lnlike_one)(flat)
            else:
                # balanced chunks: the fewest chunks that fit, padded by at
                # most n_chunks - 1 walkers
                n_chunks = -(-B // max_parallel)
                chunk = -(-B // n_chunks)
                pad = n_chunks * chunk - B
                padded = jnp.concatenate([flat, jnp.broadcast_to(flat[:1], (pad, flat.shape[-1]))])
                out = jax.lax.map(
                    jax.vmap(lnlike_one), padded.reshape(n_chunks, chunk, -1)
                ).reshape(-1)[:B]
            return out.reshape(p.shape[:-1])

        return lnlike_batch

    def star_lnmarginals(self, p):
        """Per-star marginal ln-likelihoods at ``p`` — the support diagnostic.

        The cluster lnlike is a SUM over members, so a single poisoned star
        drives the whole fit while every other star looks fine. The
        reference fails the same way with no diagnostic (cluster.py:316-341).
        Returns a pandas Series aligned with the member catalog:

        * non-finite rows (NaN photometry -> NaN; no ladder cell inside the
          mass box -> -inf) have genuinely empty (eep1, eep2) support — drop
          the row or fix the bounds; one such row makes the whole lnlike
          -inf.
        * extremely negative rows (≲ -10³) are members the ladder can't
          match — e.g. true EEP above ``eep_bounds`` (widen the bounds).
          These stay finite (underflow-safe integration) but drag the fit.
        """
        import pandas as pd

        self._get_jit("lnlike")  # ensure the builder ran (sets _star_lnmarg_fn)
        lnm, ok = self._star_lnmarg_fn(jnp.asarray(np.asarray(p, dtype=float)))
        lnm = np.asarray(lnm)[np.asarray(ok)]  # drop mesh ghost-star padding
        return pd.Series(lnm, index=self.stars.df.index[: len(lnm)], name="ln_marginal")

    def emcee_p0(self, n_walkers, rng=None):
        """Uniform draws inside the prior box (the reference raises here,
        cluster.py:380-381; we support it since the priors are proper)."""
        rng = np.random.default_rng(rng)
        los, his = self._bounds_arrays()
        p0 = los + (his - los) * rng.random((n_walkers, len(los)))
        lnp = np.asarray(self.lnpost_batch(jnp.asarray(p0)))
        bad = ~np.isfinite(lnp)
        tries = 0
        while bad.any() and tries < 100:
            p_new = los + (his - los) * rng.random((int(bad.sum()), len(los)))
            p0[bad] = p_new
            lnp = np.asarray(self.lnpost_batch(jnp.asarray(p0)))
            bad = ~np.isfinite(lnp)
            tries += 1
        return p0

    def sample_from_prior(self, n, values=False, require_valid=True, rng=None):
        import pandas as pd

        df = pd.DataFrame(self.emcee_p0(n, rng=rng), columns=list(self.param_names))
        return df.values if values else df

    def _make_samples(self):
        """Cluster samples are the raw chain (reference cluster.py:389-411)."""
        self._derived_samples = self.samples.copy()


class SimulatedCluster(StarCatalog):
    """Synthetic cluster photometry catalog (reference cluster.py:71-179).

    Star generation is fully batched (one vectorized get_eep +
    interp_mag per band) instead of per-star Python loops."""

    def __init__(
        self,
        N,
        age,
        feh,
        distance,
        AV,
        alpha,
        gamma,
        fB,
        bands="JHK",
        mass_range=(0.3, 2.5),
        distance_scatter=5,
        models="synthetic",
        phot_unc=0.01,
        ic=None,
        rng=None,
        **ic_kwargs,
    ):
        self.N = N
        self.age = age
        self.feh = feh
        self.distance = distance
        self.AV = AV
        self.alpha = alpha
        self.gamma = gamma
        self.fB = fB
        self.pars = [age, feh, distance, AV, alpha, gamma, fB]
        self.bands = tuple(bands)
        self.mass_range = mass_range
        self.distance_scatter = distance_scatter
        self.phot_unc = phot_unc
        self._rng = np.random.default_rng(rng)

        if ic is None:
            from .isochrone import get_ichrone

            ic = get_ichrone(models, **ic_kwargs)
        self.ic = ic

        df = self._generate()
        super().__init__(df, bands=bands, props=["parallax"])

    def evolve(self, age):
        """Same stars at a different age (reference cluster.py:112-119)."""
        df = self._simulate_stars(
            age, self.df.is_binary.values, self.df.mass_pri.values,
            self.df.mass_sec.values, self.df.distance.values,
        )
        return StarCatalog(df, bands=self.bands, props=["parallax"])

    def _generate(self):
        N = self.N
        age, feh, distance, AV, alpha, gamma, fB = self.pars
        r = self._rng
        is_binary = r.random(N) < fB
        pri = PowerLawPrior(alpha, self.mass_range).sample(N, rng=r)
        qs = PowerLawPrior(gamma, (0.2, 1)).sample(N, rng=r)
        sec = pri * qs * is_binary
        sec[(sec < 0.1) & (sec > 0)] = 0.1
        distances = distance + r.standard_normal(N) * self.distance_scatter
        stars = self._simulate_stars(age, is_binary, pri, sec, distances)

        # redraw dead stars (mass evolved past its track end at this age ->
        # NaN photometry; one NaN row poisons the whole cluster likelihood)
        band_cols = [f"{b}_mag" for b in self.bands]
        for _ in range(100):
            bad = stars[band_cols].isna().any(axis=1).values
            if not bad.any():
                break
            nb = int(bad.sum())
            is_binary[bad] = r.random(nb) < fB
            pri[bad] = PowerLawPrior(alpha, self.mass_range).sample(nb, rng=r)
            q_new = PowerLawPrior(gamma, (0.2, 1)).sample(nb, rng=r)
            sec[bad] = pri[bad] * q_new * is_binary[bad]
            sec[(sec < 0.1) & (sec > 0)] = 0.1
            distances[bad] = distance + r.standard_normal(nb) * self.distance_scatter
            stars = self._simulate_stars(age, is_binary, pri, sec, distances)
        else:
            getLogger().warning("SimulatedCluster: NaN photometry rows remain after redraws")
        return stars

    def _simulate_stars(self, age, is_binary, pri_masses, sec_masses, distances):
        import pandas as pd

        N = len(pri_masses)
        _, feh, distance, AV, alpha, gamma, fB = self.pars
        r = self._rng
        track = self.ic.track if self.ic.eep_replaces == "mass" else self.ic

        pri_eeps = track.get_eep(pri_masses, age, feh)
        sec_eeps = np.where(
            sec_masses > 0, track.get_eep(np.maximum(sec_masses, 1e-3), age, feh), np.nan
        )

        iso = self.ic if self.ic.eep_replaces == "mass" else self.ic.iso
        bands = list(self.bands)
        _, _, _, pri_mags = iso.interp_mag(
            [pri_eeps, np.full(N, age), np.full(N, feh), distances, np.full(N, AV)], bands
        )
        sec_safe = np.where(np.isfinite(sec_eeps), sec_eeps, pri_eeps)
        _, _, _, sec_mags = iso.interp_mag(
            [sec_safe, np.full(N, age), np.full(N, feh), distances, np.full(N, AV)], bands
        )
        sec_mags = np.where(np.isfinite(sec_eeps)[:, None], sec_mags, np.inf)

        mags = {}
        for i, b in enumerate(bands):
            mags[f"{b}_mag"] = addmags(pri_mags[:, i], sec_mags[:, i])

        stars = pd.DataFrame(mags)
        stars["is_binary"] = is_binary
        stars["distance"] = distances
        stars["mass_pri"] = pri_masses
        stars["mass_sec"] = sec_masses
        stars["eep_pri"] = pri_eeps
        stars["eep_sec"] = sec_eeps
        unc = self.phot_unc
        for b in bands:
            stars[f"{b}_mag"] += r.standard_normal(N) * unc
            stars[f"{b}_mag_unc"] = unc
        stars["parallax"] = 1000.0 / distances
        stars["parallax_unc"] = 0.2
        return stars


def simulate_cluster(
    N, age, feh, distance, AV, alpha, gamma, fB,
    bands="JHK", mass_range=(0.8, 2.5), distance_scatter=5, iso=None, rng=None, **ic_kwargs,
):
    """Functional synthetic-cluster generator (reference cluster.py:414-477)."""
    sim = SimulatedCluster(
        N, age, feh, distance, AV, alpha, gamma, fB, bands=bands,
        mass_range=mass_range, distance_scatter=distance_scatter,
        ic=iso, rng=rng, **ic_kwargs,
    )
    df = sim.df.copy()
    df["age"] = age
    df["feh"] = feh
    df["AV"] = AV
    return StarCatalog(df, bands=tuple(bands), props=["parallax"])


def clusterfit(
    starfile,
    bands=None,
    props=None,
    models="mist",
    max_distance=10000,
    mineep=200,
    maxeep=800,
    maxAV=0.1,
    minq=0.2,
    overwrite=False,
    nlive=1000,
    name="",
    halo_fraction=0.5,
    comm=None,
    rank=0,
    max_iter=None,
    eep_step=1.0,
    q_jacobian=False,
    dynamic=None,
    min_ess=None,
):
    """Cluster-fit driver (reference cluster.py:20-68). The reference
    broadcasts the model over MPI for MultiNest's rank-parallel likelihoods;
    here the sampler is on-device, so ``comm``/``rank`` are accepted for API
    compatibility and ignored."""
    import pandas as pd

    if comm is not None:
        getLogger().info("MPI comm ignored: sampler fan-out runs on-device.")

    stars = pd.read_hdf(starfile) if str(starfile).endswith((".h5", ".hdf", ".hdf5")) else pd.read_csv(starfile)
    cat = StarCatalog(stars, bands=bands, props=props)
    getLogger().info("bands = %s", cat.bands)

    from .isochrone import get_ichrone

    ic = get_ichrone(models, bands=cat.bands)
    model = StarClusterModel(
        ic, cat, eep_bounds=(mineep, maxeep), max_distance=max_distance,
        minq=minq, halo_fraction=halo_fraction, max_AV=maxAV, name=name,
        eep_step=eep_step, q_jacobian=q_jacobian,
    )
    # loud support check: one unsupported star makes EVERY walker -inf and
    # the sampler silently returns prior draws
    los, his = model._bounds_arrays()
    probe = los + (his - los) * np.random.default_rng(0).random((8, len(los)))
    if not np.isfinite(np.asarray(model.lnpost_batch(jnp.asarray(probe)))).any():
        marg = model.star_lnmarginals(probe[0])
        bad = marg.index[~np.isfinite(marg.values)].tolist()
        getLogger().warning(
            "cluster lnlike is -inf at all probe points; stars with no "
            "(eep, q) support (NaN photometry, or no ladder cell inside "
            "the mass box): %s — drop those rows or fix the bounds.", bad,
        )
    fit_kw = dict(overwrite=overwrite, n_live_points=nlive, max_iter=max_iter)
    if dynamic is not None:
        # None defers to the model's default (dynamic NS: cluster marginals
        # are expensive per call, the regime where dynamic's call saving is
        # real wall-clock); --static forces it off
        fit_kw["dynamic"] = dynamic
    if min_ess is not None:
        fit_kw["min_ess"] = min_ess
    model.fit(**fit_kw)
    return model
