"""Tree-based ``StarModel`` for resolved/blended multi-star systems.

Rebuild of ``isochrones/starmodel.py:63-1317`` (the general model over an
ObservationTree) + ``StarModelGroup`` (starmodel.py:1320-1358). Inherits the
on-device inference plumbing (fit / fit_mcmc / fit_multinest / samples) from
:class:`~isochrones_tpu.starmodel.BasicStarModel`; the tree likelihood is the
compiled-plan kernel from :mod:`isochrones_tpu.observation` — batched fused
interp over all model stars, flux sums as masked einsum.
"""

from __future__ import annotations

import itertools
import os
import re
from copy import deepcopy
from typing import Dict, Optional

import jax.numpy as jnp
import numpy as np

from .logger import getLogger
from .observation import ObservationTree, Observation, Source, make_tree_lnlike
from .priors import (
    AgePrior,
    AVPrior,
    ChabrierPrior,
    DistancePrior,
    EEP_prior,
    FehPrior,
    QPrior,
)
from .starmodel import BasicStarModel, N_options, index_options
from .utils import addmags

__all__ = ["StarModel", "StarModelGroup", "ini_photometry_rows"]


def ini_photometry_rows(c, scalars_out=None):
    """Parsed star.ini mapping -> photometry rows for
    :meth:`ObservationTree.from_df` (the section conventions of reference
    starmodel.py:248-436: one section per instrument; ``resolution`` implies
    companions with relative photometry unless ``relative`` is explicit;
    companion tags ``K_1``/``separation_1``/...). Non-section scalars are
    copied into ``scalars_out`` when given."""
    from .iniparse import IniSection, parse_value

    rows = []
    for k, v in c.items():
        if not isinstance(v, IniSection):
            if scalars_out is not None:
                scalars_out[k] = parse_value(v)
            continue
        instrument = k
        sec = v
        if "resolution" in sec:
            resolution = float(parse_value(sec["resolution"]))
            relative = True
        else:
            resolution = 4.0
            relative = False
        if "relative" in sec:
            relative = str(sec["relative"]) == "True"

        tags = []
        sec_bands = []
        for label in sec:
            m = re.search(r"separation(_\w+)?", label)
            if m:
                if m.group(1) is not None and m.group(1) not in tags:
                    tags.append(m.group(1))
            elif re.search(r"PA", label) or re.search(r"id", label) or label in ("resolution", "relative"):
                continue
            else:
                m = re.search(r"([a-zA-Z0-9]+)(_\w+)?", label)
                if m and m.group(1) not in sec_bands:
                    sec_bands.append(m.group(1))
        if sec_bands and (not tags or sec_bands[0] in sec):
            tags.append("")

        for b in sec_bands:
            for tag in tags:
                key = f"{b}{tag}"
                if key not in sec:
                    continue
                mag, e_mag = parse_value(sec[key])
                if np.isnan(mag) or np.isnan(e_mag):
                    continue
                sep_key = f"separation{tag}"
                rows.append(
                    dict(
                        name=instrument, band=b, resolution=resolution, relative=relative,
                        separation=float(parse_value(sec[sep_key])) if sep_key in sec else 0.0,
                        pa=float(parse_value(sec[f"PA{tag}"])) if f"PA{tag}" in sec else 0.0,
                        mag=float(mag), e_mag=float(e_mag),
                    )
                )
            if relative:
                rows.append(
                    dict(name=instrument, band=b, resolution=resolution, relative=relative,
                         separation=0.0, pa=0.0, mag=0.0, e_mag=0.01)
                )
    return rows


class StarModel(BasicStarModel):
    """General (tree-based) star model (reference starmodel.py:63-1317).

    Use for resolved systems / blended photometry; for flat single/binary/
    triple fits prefer :class:`BasicStarModel`.
    """

    #: tree likelihoods are several-fold costlier per call than the fused
    #: flat model -> dynamic NS by default (override with
    #: fit(dynamic=False))
    _default_dynamic = True

    def _config_data_repr(self):
        """Tree models keep their data in the observation tree, not
        ``self.kwargs`` — hash the photometry table plus the spectroscopy/
        parallax/limit attachments so a --resume against an edited star.ini
        refuses instead of replaying the stale checkpoint (self-review r5:
        the base-class hash covered none of it)."""
        parts = [self.obs.to_df().to_csv(index=False)]
        for attr in ("spectroscopy", "parallax", "limits"):
            parts.append(repr(sorted(getattr(self.obs, attr, {}).items())))
        return "|".join(parts)

    def __init__(
        self,
        ic,
        obs=None,
        N=1,
        index=0,
        name="",
        use_emcee=False,
        RA=None,
        dec=None,
        coords=None,
        eep_bounds=None,
        directory=".",
        **kwargs,
    ):
        self._jit_cache: Dict[str, object] = {}
        self.name = str(name) if name else (obs.name if obs is not None and getattr(obs, "name", None) else "")
        self.coords = coords
        self.ra = RA
        self.dec = dec
        self._ic = ic
        self.use_emcee = use_emcee
        self.eep_bounds = tuple(eep_bounds) if eep_bounds is not None else tuple(ic.eep_bounds)
        self.N = None  # tree determines multiplicity

        if obs is None:
            self._build_obs(**kwargs)
            self.obs.define_models(ic, N=N, index=index)
            self._add_properties(**kwargs)
        elif isinstance(obs, str):
            import pandas as pd

            df = pd.read_csv(obs)
            self.obs = ObservationTree.from_df(df)
            self.obs.define_models(ic, N=N, index=index)
            self._add_properties(**kwargs)
        else:
            self.obs = obs
            if len(self.obs.get_model_nodes()) == 0:
                self.obs.define_models(ic, N=N, index=index)
                self._add_properties(**kwargs)

        # prior stack (reference starmodel.py:166-178)
        self._priors = {
            "mass": ChabrierPrior(),
            "feh": FehPrior(),
            "q": QPrior(),
            "age": AgePrior(),
            "distance": DistancePrior(),
            "AV": AVPrior(),
        }
        self._priors["eep"] = EEP_prior(self.ic, self._priors[self.ic.eep_replaces], bounds=eep_bounds)
        self._bounds = {
            k: p.bounds if k not in ["mass", "feh", "age"] else None for k, p in self._priors.items()
        }
        if "maxAV" in kwargs:
            self.set_bounds(AV=(0, kwargs["maxAV"]))
        if "max_distance" in kwargs:
            self.set_bounds(distance=(0, kwargs["max_distance"]))

        self._bands = None
        self._props = None
        self._directory = str(directory)
        self._samples = None
        self._derived_samples = None
        self._evidence = None
        self.kwargs = {}

    # ------------------------------------------------------------- properties
    @property
    def bands(self):
        if self._bands is None:
            try:
                self._bands = list({n.band for n in self.obs.get_obs_nodes() if n.band is not None})
            except AttributeError:
                self._bands = []
        return self._bands

    @property
    def props(self):
        if self._props is None:
            props = {k for v in self.obs.spectroscopy.values() for k in v}
            self._props = list(props - {"Teff", "logg", "feh"})
        return self._props

    @property
    def param_names(self):
        return tuple(self.obs.param_description)

    @property
    def param_description(self):
        return self.obs.param_description

    @property
    def n_params(self):
        return sum(4 + n for n in self.obs.Nstars.values())

    @property
    def labelstring(self):
        s = "--".join(
            ["-".join([n.label for n in l.children]) for l in self.obs.get_obs_leaves()]
        )
        if s == "0_0":
            return "single"
        if s == "0_0-0_1":
            return "binary"
        if s == "0_0-0_1-0_2":
            return "triple"
        return s

    @property
    def mags(self):
        return {n.band: n.value[0] for n in self.obs.get_obs_nodes() if not n.relative}

    # ----------------------------------------------------------------- builders
    @classmethod
    def _parse_band(cls, kw):
        """Photometric band from an ini keyword (reference starmodel.py:219-227)."""
        m = re.search(r"([a-zA-Z0-9]+)(_\w+)?", kw)
        if m:
            if m.group(1) in cls._not_a_band:
                return None
            return m.group(1)

    @classmethod
    def get_bands(cls, inifile):
        """All bands named in an ini file (reference starmodel.py:229-245)."""
        from .iniparse import IniSection, parse_ini

        bands = []
        c = parse_ini(inifile)
        for kw, v in c.items():
            if isinstance(v, IniSection):
                for kw2 in v:
                    b = cls._parse_band(kw2)
                    if b is not None:
                        bands.append(b)
            else:
                b = cls._parse_band(kw)
                if b is not None:
                    bands.append(b)
        return list(set(bands))

    @classmethod
    def from_ini(cls, ic, folder=".", ini_file="star.ini", **kwargs):
        """Build a model from a ``star.ini`` spec (reference
        starmodel.py:248-436; same section conventions: a section per
        instrument; ``resolution`` implies companions w/ relative photometry
        unless ``relative`` explicitly set; companion tags ``K_1``,
        ``separation_1``, ...)."""
        import pandas as pd

        from .iniparse import IniSection, parse_ini, parse_value

        if not os.path.isabs(ini_file):
            ini_file = os.path.join(folder, ini_file)
        bands = cls.get_bands(ini_file)

        from .models import ModelGridInterpolator

        if not isinstance(ic, ModelGridInterpolator):
            from .isochrone import get_ichrone

            ic = get_ichrone(ic, bands)

        c = parse_ini(ini_file)
        obs = None
        rows = ini_photometry_rows(c, scalars_out=kwargs)
        if rows:
            obs = ObservationTree.from_df(pd.DataFrame(rows))
        if "obsfile" in c:
            obs = c["obsfile"]

        name = kwargs.pop("name", os.path.basename(os.path.abspath(folder)))
        new = cls(ic, obs=obs, **kwargs, name=name)
        new._directory = os.path.abspath(folder)
        return new

    def _build_obs(self, **kwargs):
        """kwargs photometry -> single-source ObservationTree
        (reference starmodel.py:481-504)."""
        tree = ObservationTree()
        for k, v in kwargs.items():
            if k in self.ic.bc.column_index:
                if np.size(v) != 2:
                    getLogger().warning("%s=%s ignored (no uncertainty).", k, v)
                    v = [v, np.nan]
                o = Observation("", k, 99)
                o.add_source(Source(v[0], v[1]))
                o._set_reference()
                tree.add_observation(o)
        self.obs = tree

    def _add_properties(self, **kwargs):
        """Attach non-photometric observations (reference starmodel.py:506-524)."""
        for k, v in kwargs.items():
            if k in self.ic.bc.column_index:
                continue
            elif k == "parallax":
                self.obs.add_parallax(v)
            elif k == "AV":
                self.obs.add_AV(v)
            elif k in ("Teff", "logg", "feh", "density"):
                self.obs.add_spectroscopy(**{k: v})
            elif re.search(r"_", k):
                m = re.search(r"^(\w+)_(\w+)$", k)
                prop, tag = m.group(1), m.group(2)
                if prop in ("Teff", "logg", "feh", "density"):
                    self.obs.add_spectroscopy(label=f"0_{tag}", **{prop: v})

    def print_ascii(self):
        return self.obs.print_ascii()

    def convert_pars_to_eep(self, pars):
        """Mass-based parameter vectors -> EEP (reference starmodel.py:443-453)."""
        pardict = self.obs.p2pardict(pars)
        new = dict(pardict)
        for s, p in pardict.items():
            new[s] = list(p)
            new[s][0] = self.ic.get_eep(*p[0:3], accurate=True)
        return self.obs.pardict2p(new)

    # ---------------------------------------------------------------- bounds
    def bounds(self, prop):
        if prop in ("eep_0", "eep_1", "eep_2") or prop.startswith("eep"):
            prop = "eep"
        if prop.startswith(("age_", "feh_", "distance_", "AV_")):
            prop = prop.split("_")[0]
        if self._bounds.get(prop) is not None:
            return self._bounds[prop]
        if prop in ("mass", "feh", "age"):
            lo, hi = self.ic.get_limits(prop)
            self._bounds[prop] = (lo, hi)
            self._priors[prop].bounds = (lo, hi)
            return self._bounds[prop]
        raise ValueError(f"Unknown property {prop}")

    # ---------------------------------------------------------- batched fns
    def _build_lnlike_batch(self):
        return make_tree_lnlike(self.obs.plan(self.ic))

    def _build_lnprior_batch(self):
        """Per-system priors + descending-EEP constraint
        (reference starmodel.py:557-613)."""
        if self.ic.eep_replaces != "mass":
            raise NotImplementedError("Prior not implemented for evolution track grids")
        priors = self._priors
        Nstars = dict(self.obs.Nstars)
        systems = list(self.obs.systems)
        shared_bounds = {p: self.bounds(p) for p in ("age", "feh", "distance", "AV")}

        def lnprior_batch(p):
            lnp = jnp.zeros(p.shape[:-1], dtype=p.dtype)
            i = 0
            for s in systems:
                n = Nstars[s]
                shared = {
                    "age": p[..., i + n],
                    "feh": p[..., i + n + 1],
                    "distance": p[..., i + n + 2],
                    "AV": p[..., i + n + 3],
                }
                for prop, val in shared.items():
                    lo, hi = shared_bounds[prop]
                    lnp = jnp.where((val < lo) | (val > hi), -jnp.inf, lnp)
                    lnp = lnp + priors[prop].lnpdf_jax(val)
                eeps = p[..., i : i + n]
                if n > 1:
                    descending = jnp.all(eeps[..., 1:] <= eeps[..., :-1], axis=-1)
                    lnp = jnp.where(descending, lnp, -jnp.inf)
                for j in range(n):
                    lnp = lnp + priors["eep"].lnpdf_jax(
                        eeps[..., j], age=shared["age"], feh=shared["feh"]
                    )
                i += n + 4
            return lnp

        return lnprior_batch

    def prior_transform_batch(self, u):
        """Unit cube -> params, per-system blocks with EEPs sorted descending
        (reference mnest_prior, starmodel.py:677-693). The box transform is
        the inherited one; only the EEP ordering is layered on top."""
        out = super().prior_transform_batch(u)
        i = 0
        for s in self.obs.systems:
            n = self.obs.Nstars[s]
            if n > 1:
                eeps = out[..., i : i + n]
                eeps = -jnp.sort(-eeps, axis=-1)
                out = jnp.concatenate([out[..., :i], eeps, out[..., i + n :]], axis=-1)
            i += n + 4
        return out

    # -------------------------------------------------------------- sampling
    def sample_from_prior(self, n, values=False, require_valid=True, rng=None):
        """Per-system prior draws (reference emcee_p0, starmodel.py:838-884)."""
        import pandas as pd

        rng = np.random.default_rng(rng) if not isinstance(rng, np.random.Generator) else rng
        cols = {}
        for s in self.obs.systems:
            nstars = self.obs.Nstars[s]
            age = self._priors["age"].sample(n, rng=rng)
            feh = self._priors["feh"].sample(n, rng=rng)
            d = self._priors["distance"].sample(n, rng=rng)
            AV = self._priors["AV"].sample(n, rng=rng)
            eeps = np.stack(
                [self._priors["eep"].sample(n, rng=rng, age=age, feh=feh) for _ in range(nstars)],
                axis=-1,
            )
            eeps = -np.sort(-eeps, axis=-1)
            for j in range(nstars):
                cols[f"eep_{s}_{j}"] = eeps[:, j]
            cols[f"age_{s}"] = age
            cols[f"feh_{s}"] = feh
            cols[f"distance_{s}"] = d
            cols[f"AV_{s}"] = AV
        df = pd.DataFrame(cols)[list(self.param_names)]

        if require_valid:
            lnprob = np.asarray(self.lnpost_batch(jnp.asarray(df.values)))
            bad = ~np.isfinite(lnprob)
            if bad.any():
                new = self.sample_from_prior(int(bad.sum()), require_valid=True, rng=rng)
                df.iloc[np.where(bad)[0], :] = new.values
        return df.values if values else df

    # -------------------------------------------------------- derived samples
    def _make_samples(self):
        """Per-system derived posterior quantities (reference
        starmodel.py:984-1032)."""
        import pandas as pd

        chain = self.samples[list(self.param_names)].values
        lnprob = self.samples["lnprob"].values
        df = pd.DataFrame()
        i = 0
        for s in self.obs.systems:
            n = self.obs.Nstars[s]
            age = chain[:, i + n]
            feh = chain[:, i + n + 1]
            dist = chain[:, i + n + 2]
            AV = chain[:, i + n + 3]
            for j in range(n):
                eep = chain[:, i + j]
                d = self.ic(eep, age, feh, distance=dist, AV=AV)
                for c in d.columns:
                    df[f"{c}_{s}_{j}"] = d[c].values
            df[f"age_{s}"] = age
            df[f"feh_{s}"] = feh
            df[f"distance_{s}"] = dist
            df[f"AV_{s}"] = AV
            i += 4 + n

        for b in self.ic.bands:
            tot = np.inf
            for s in self.obs.systems:
                for j in range(self.obs.Nstars[s]):
                    tot = addmags(tot, df[f"{b}_mag_{s}_{j}"].values)
            df[f"{b}_mag"] = tot

        df["lnprob"] = lnprob
        self._derived_samples = df.copy()

    def random_samples(self, n, rng=None):
        """reference starmodel.py:1050-1065"""
        rng = np.random.default_rng(rng)
        inds = rng.integers(len(self.samples), size=int(n))
        return self.samples.iloc[inds].reset_index(drop=True)

    # ------------------------------------------------------------- persistence
    def save_hdf(self, filename, path="", overwrite=False, append=False):
        """Model + tree persistence (reference starmodel.py:1205-1262)."""
        import json

        import h5py

        if os.path.exists(filename) and overwrite:
            os.remove(filename)
        self.obs.save_hdf(filename, path, append=True)
        with h5py.File(filename, "a") as f:
            grp = f.require_group(path or "/")
            for key in ("samples", "derived_samples"):
                if key in grp:
                    del grp[key]
            if self._samples is not None:
                g = grp.create_group("samples")
                g.create_dataset("values", data=self._samples.values)
                g.attrs["columns"] = json.dumps(list(self._samples.columns))
                gd = grp.create_group("derived_samples")
                gd.create_dataset("values", data=self.derived_samples.values.astype(float))
                gd.attrs["columns"] = json.dumps(list(self.derived_samples.columns))
            grp.attrs["ic_type"] = type(self.ic).__name__
            grp.attrs["ic_bands"] = json.dumps(list(self.ic.bands))
            grp.attrs["use_emcee"] = self.use_emcee
            grp.attrs["name"] = self.name
            grp.attrs["directory"] = self._directory or "."

    @classmethod
    def load_hdf(cls, filename, path="", name=None, ic=None):
        """reference starmodel.py:1264-1317"""
        import json

        import h5py
        import pandas as pd

        with h5py.File(filename, "r") as f:
            grp = f[path or "/"]
            bands = json.loads(grp.attrs["ic_bands"])
            ic_type = str(grp.attrs["ic_type"])
            use_emcee = bool(grp.attrs["use_emcee"])
            stored_name = str(grp.attrs["name"])
            directory = str(grp.attrs["directory"])
            samples = derived = None
            if "samples" in grp:
                g = grp["samples"]
                samples = pd.DataFrame(np.asarray(g["values"]), columns=json.loads(g.attrs["columns"]))
                gd = grp["derived_samples"]
                derived = pd.DataFrame(np.asarray(gd["values"]), columns=json.loads(gd.attrs["columns"]))

        if ic is None:
            from .isochrone import get_ichrone

            tracks = ic_type == "EvolutionTrackInterpolator"
            try:
                ic = get_ichrone("mist", bands=bands, tracks=tracks)
            except Exception:
                ic = get_ichrone("synthetic", bands=bands, tracks=tracks)

        obs = ObservationTree.load_hdf(filename, path, ic=ic)
        mod = cls(ic, obs=obs, use_emcee=use_emcee,
                  name=name if name is not None else stored_name, directory=directory)
        mod._samples = samples
        mod._derived_samples = derived
        return mod


class StarModelGroup:
    """Model-selection helper: variants of a base StarModel over multiplicity
    and association configurations (reference starmodel.py:1320-1358)."""

    def __init__(self, base_model, max_multiples=1, max_stars=2):
        self.base_model = deepcopy(base_model)
        self.base_model.obs.clear_models()
        self.max_multiples = max_multiples
        self.max_stars = max_stars
        self.models = []
        for N, index in self.model_options:
            mod = deepcopy(self.base_model)
            mod.obs.define_models(self.ic, N=N, index=index)
            self.models.append(mod)

    @property
    def ic(self):
        return self.base_model.ic

    @property
    def N_stars(self):
        return len(self.base_model.obs.leaves)

    @property
    def N_options(self):
        return N_options(self.N_stars, max_multiples=self.max_multiples, max_stars=self.max_stars)

    @property
    def index_options(self):
        return index_options(self.N_stars)

    @property
    def model_options(self):
        return [(N, index) for N in self.N_options for index in self.index_options]
