"""Prior distributions.

Rebuild of ``isochrones/priors.py`` with a dual interface:

* host API matching the reference's ``Prior`` contract (``pdf``, ``lnpdf``,
  ``sample``, ``bounds`` with quad renormalization, ``test_integral``,
  ``test_sampling`` — priors.py:31-104);
* a pure-jnp ``lnpdf_jax(x, **cond)`` on every prior, so the combined model
  log-prior composes into a single jitted/vmapped function — the reference
  evaluates Python prior objects per sample inside the MultiNest callback
  (starmodel.py:1616-1635); here the whole prior stack stays on device.
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np
from scipy.integrate import quad

from .logger import getLogger

def _norm_bounds(bounds):
    """Normalize a (lo, hi) pair: None endpoints become +-inf so every
    downstream comparison / quad sees floats (None otherwise survives into
    ``pdf``/``test_integral`` and crashes on first evaluation)."""
    if bounds is None:
        return None
    lo, hi = bounds
    return (
        -np.inf if lo is None else float(lo),
        np.inf if hi is None else float(hi),
    )


ONE_OVER_ROOT_2PI = 1.0 / math.sqrt(2 * math.pi)
LOG_ONE_OVER_ROOT_2PI = math.log(ONE_OVER_ROOT_2PI)

__all__ = [
    "Prior",
    "BoundedPrior",
    "BrokenPrior",
    "GaussianPrior",
    "LogNormalPrior",
    "FlatPrior",
    "FlatLogPrior",
    "PowerLawPrior",
    "FehPrior",
    "EEP_prior",
    "AgePrior",
    "DistancePrior",
    "AVPrior",
    "QPrior",
    "SalpeterPrior",
    "ChabrierPrior",
    "powerlaw_pdf",
    "powerlaw_lnpdf",
]


def powerlaw_pdf(x, alpha, lo, hi):
    """jnp power-law pdf (reference priors.py:469-473)."""
    a1 = alpha + 1.0
    C = a1 / (hi ** a1 - lo ** a1)
    return C * x ** alpha


def powerlaw_lnpdf(x, alpha, lo, hi):
    """jnp power-law log-pdf (reference priors.py:476-480)."""
    a1 = alpha + 1.0
    C = a1 / (hi ** a1 - lo ** a1)
    return jnp.log(C) + alpha * jnp.log(x)


class Prior:
    """Base prior (reference priors.py:31-104)."""

    def __init__(self, *args, **kwargs):
        self._norm = 1.0

    def __call__(self, x, **kwargs):
        return self.pdf(x, **kwargs)

    @property
    def bounds(self):
        return (-np.inf, np.inf) if getattr(self, "_bounds", None) is None else self._bounds

    @bounds.setter
    def bounds(self, new):
        new = _norm_bounds(new)
        self._norm = quad(self._pdf, *new)[0]
        self._bounds = new
        try:
            self.test_integral()
        except AssertionError:
            raise ValueError(f"Problem setting bounds to {new}; integral test failed.")

    def _pdf(self, x, **kwargs):
        raise NotImplementedError

    def pdf(self, x, **kwargs):
        lo, hi = self.bounds
        if np.ndim(x) == 0:
            if x < lo or x > hi:
                return 0.0
            return self._pdf(x, **kwargs) / self._norm
        x = np.asarray(x)
        out = np.where((x < lo) | (x > hi), 0.0, self._pdf(x, **kwargs) / self._norm)
        return out

    def lnpdf(self, x, **kwargs):
        if hasattr(self, "_lnpdf"):
            return self._lnpdf(x, **kwargs)
        pdf = self(x, **kwargs)
        if np.ndim(pdf) == 0:
            return np.log(pdf) if pdf else -np.inf
        with np.errstate(divide="ignore"):
            return np.where(pdf > 0, np.log(np.maximum(pdf, 1e-300)), -np.inf)

    def lnpdf_jax(self, x, **kwargs):
        """Pure-jnp log-pdf incl. bounds mask and normalization."""
        lo, hi = self.bounds
        ln = self._lnpdf_jax(x, **kwargs) - jnp.log(self._norm)
        inb = jnp.ones_like(jnp.asarray(x, dtype=jnp.result_type(x, jnp.float32)), dtype=bool)
        if np.isfinite(lo):
            inb = inb & (x >= lo)
        if np.isfinite(hi):
            inb = inb & (x <= hi)
        return jnp.where(inb, ln, -jnp.inf)

    def _lnpdf_jax(self, x, **kwargs):
        raise NotImplementedError

    def sample(self, n, rng=None):
        raise NotImplementedError

    def test_integral(self):
        lo, hi = self.bounds
        assert np.isclose(1, quad(self.pdf, lo, hi)[0])

    def test_sampling(self, n=100000, plot=False, rng=None):
        """Histogram-vs-pdf chi test (reference priors.py:77-104)."""
        x = self.sample(n, rng=rng)
        rng_ = None if not np.isfinite(self.bounds).all() else self.bounds
        hn, _ = np.histogram(x, range=rng_)
        h, b = np.histogram(x, density=True, range=rng_)
        pdf = np.array([quad(self.pdf, lo, hi)[0] / (hi - lo) for lo, hi in zip(b[:-1], b[1:])])
        # only populated bins enter the chi test — mask BEFORE dividing so
        # empty bins don't emit divide-by-zero warnings
        mask = hn > 50
        sigma = np.full(hn.shape, np.inf)
        sigma[mask] = 1.0 / np.sqrt(hn[mask])
        resid = np.absolute(pdf - h) / pdf
        assert max((resid / sigma)[mask]) < 6


class BoundedPrior(Prior):
    """Prior whose _pdf is already normalized over its bounds (priors.py:107-140)."""

    def __init__(self, bounds=None):
        self._bounds = _norm_bounds(bounds)
        super().__init__()

    @property
    def bounds(self):
        return self._bounds

    @bounds.setter
    def bounds(self, new):
        self._bounds = _norm_bounds(new)
        self._on_bounds_change()
        try:
            self.test_integral()
        except AssertionError:
            raise ValueError(f"Problem setting bounds to {new}; integral test failed.")

    def _on_bounds_change(self):
        """Hook for subclasses whose normalization depends on the bounds
        (e.g. :class:`GaussianPrior` re-truncates). Default: nothing."""

    def pdf(self, x, **kwargs):
        if self.bounds is not None:
            lo, hi = self.bounds
            if np.ndim(x) == 0:
                if x < lo or x > hi:
                    return 0.0
            else:
                return np.where((np.asarray(x) < lo) | (np.asarray(x) > hi), 0.0, self._pdf(x, **kwargs))
        return self._pdf(x, **kwargs)

    def lnpdf(self, x, **kwargs):
        if self.bounds is not None and np.ndim(x) == 0:
            lo, hi = self.bounds
            if x < lo or x > hi:
                return -np.inf
        if hasattr(self, "_lnpdf"):
            ln = self._lnpdf(x, **kwargs)
        else:
            pdf = self.pdf(x, **kwargs)
            if np.ndim(pdf) == 0:
                return np.log(pdf) if pdf else -np.inf
            with np.errstate(divide="ignore"):
                ln = np.where(pdf > 0, np.log(np.maximum(pdf, 1e-300)), -np.inf)
        if self.bounds is not None and np.ndim(x) > 0:
            lo, hi = self.bounds
            x = np.asarray(x)
            ln = np.where((x < lo) | (x > hi), -np.inf, ln)
        return ln

    def lnpdf_jax(self, x, **kwargs):
        ln = self._lnpdf_jax(x, **kwargs)
        if self.bounds is not None:
            lo, hi = self.bounds
            ln = jnp.where((x < lo) | (x > hi), -jnp.inf, ln)
        return ln


def _rng(rng):
    if rng is None:
        return np.random.default_rng()
    if isinstance(rng, (int, np.integer)):
        return np.random.default_rng(rng)
    return rng


class GaussianPrior(BoundedPrior):
    """(Truncated) Gaussian (reference priors.py:235-257)."""

    def __init__(self, mean, sigma, bounds=None):
        self.mean = mean
        self.sigma = sigma
        self._bounds = _norm_bounds(bounds)
        self._norm = 1.0
        self._on_bounds_change()

    def _on_bounds_change(self):
        """(Re)build the truncation — assigning ``.bounds`` after
        construction must re-truncate, not keep the old normalization."""
        bounds = self._bounds
        lo, hi = (-np.inf, np.inf) if bounds is None else bounds
        if np.isfinite(lo) or np.isfinite(hi):
            # truncate whenever ANY bound is finite: scipy truncnorm handles
            # one-sided (+-inf) endpoints, and skipping truncation for e.g.
            # (0, inf) silently under-normalizes the pdf (ADVICE r2)
            from scipy.stats import norm as _norm, truncnorm

            a, b = (lo - self.mean) / self.sigma, (hi - self.mean) / self.sigma
            self.distribution = truncnorm(a, b, loc=self.mean, scale=self.sigma)
            self.norm = _norm.cdf(b) - _norm.cdf(a)
            self.lognorm = math.log(self.norm)
        else:
            from scipy.stats import norm as _norm

            self.distribution = _norm(self.mean, self.sigma)
            self.norm = 1.0
            self.lognorm = 0.0

    def _pdf(self, x):
        z = (np.asarray(x) - self.mean) / self.sigma
        return np.exp(-(z ** 2) / 2) * ONE_OVER_ROOT_2PI / self.sigma / self.norm

    def _lnpdf(self, x):
        z = (np.asarray(x) - self.mean) / self.sigma
        return -(z ** 2) / 2 + LOG_ONE_OVER_ROOT_2PI - np.log(self.sigma) - self.lognorm

    def _lnpdf_jax(self, x):
        z = (x - self.mean) / self.sigma
        return -(z ** 2) / 2 + LOG_ONE_OVER_ROOT_2PI - math.log(self.sigma) - self.lognorm

    def sample(self, n, rng=None):
        return self.distribution.rvs(n, random_state=_rng(rng))


class LogNormalPrior(Prior):
    """reference priors.py:260-280"""

    def __init__(self, mu, sigma, bounds=None):
        self.mu = mu
        self.sigma = sigma
        self.scale = math.exp(mu)
        self.log_s = math.log(sigma)
        from scipy.stats import lognorm

        self.distribution = lognorm(sigma, scale=self.scale)
        self._bounds = (0, np.inf)
        super().__init__()

    def _pdf(self, x):
        s = self.sigma
        y = np.asarray(x) / self.scale
        return ONE_OVER_ROOT_2PI / (s * y) * np.exp(-0.5 * (np.log(y) / s) ** 2) / self.scale

    def _lnpdf(self, x):
        s = self.sigma
        y = np.asarray(x) / self.scale
        return LOG_ONE_OVER_ROOT_2PI - (self.log_s + np.log(y)) - 0.5 * (np.log(y) / s) ** 2 - self.mu

    def _lnpdf_jax(self, x):
        s = self.sigma
        y = x / self.scale
        safe = jnp.maximum(y, 1e-300)
        ln = LOG_ONE_OVER_ROOT_2PI - (self.log_s + jnp.log(safe)) - 0.5 * (jnp.log(safe) / s) ** 2 - self.mu
        return jnp.where(y > 0, ln, -jnp.inf)

    def sample(self, n, rng=None):
        return self.distribution.rvs(n, random_state=_rng(rng))


class FlatPrior(BoundedPrior):
    """reference priors.py:283-293"""

    def __init__(self, bounds):
        super().__init__(bounds=bounds)

    def _pdf(self, x):
        lo, hi = self.bounds
        return np.ones_like(np.asarray(x, dtype=float)) / (hi - lo) if np.ndim(x) else 1.0 / (hi - lo)

    def _lnpdf_jax(self, x):
        lo, hi = self.bounds
        return jnp.full_like(jnp.asarray(x, dtype=jnp.result_type(x, jnp.float32)), -math.log(hi - lo))

    def sample(self, n, rng=None):
        lo, hi = self.bounds
        return _rng(rng).random(n) * (hi - lo) + lo


class FlatLogPrior(BoundedPrior):
    """Flat in 10**x (reference priors.py:296-306)."""

    def __init__(self, bounds):
        super().__init__(bounds=bounds)

    def _pdf(self, x):
        lo, hi = self.bounds
        return np.log(10) * 10 ** np.asarray(x) / (10 ** hi - 10 ** lo)

    def _lnpdf_jax(self, x):
        lo, hi = self.bounds
        return math.log(math.log(10)) + x * math.log(10) - math.log(10 ** hi - 10 ** lo)

    def sample(self, n, rng=None):
        lo, hi = self.bounds
        return np.log10(_rng(rng).random(n) * (10 ** hi - 10 ** lo) + 10 ** lo)


class PowerLawPrior(BoundedPrior):
    """x**alpha on [lo, hi] with inverse-CDF sampling (reference priors.py:309-342)."""

    def __init__(self, alpha, bounds=None):
        self.alpha = alpha
        super().__init__(bounds=bounds)

    def _C(self):
        lo, hi = self.bounds
        return (1 + self.alpha) / (hi ** (1 + self.alpha) - lo ** (1 + self.alpha))

    def _pdf(self, x):
        return self._C() * np.asarray(x) ** self.alpha

    def _lnpdf(self, x):
        return np.log(self._C()) + self.alpha * np.log(np.asarray(x))

    def _lnpdf_jax(self, x):
        return math.log(self._C()) + self.alpha * jnp.log(jnp.maximum(x, 1e-300))

    def sample(self, n, rng=None):
        lo, hi = self.bounds
        C = self._C()
        u = _rng(rng).random(n)
        a = self.alpha
        return ((a + 1) * (u / C + (lo ** (a + 1) / (a + 1)))) ** (1 / (a + 1))

    def sample_jax(self, key, shape):
        import jax

        lo, hi = self.bounds
        C = self._C()
        a = self.alpha
        u = jax.random.uniform(key, shape)
        return ((a + 1) * (u / C + (lo ** (a + 1) / (a + 1)))) ** (1 / (a + 1))


class BrokenPrior(Prior):
    """Stitched multi-component prior with continuity norms (priors.py:143-232)."""

    def __init__(self, components, breakpoints, bounds=None):
        self.components = components
        self.n_components = len(components)
        self.breakpoints = list(breakpoints)
        nb = _norm_bounds(bounds)
        self._bounds = nb if nb is not None else (-np.inf, np.inf)
        self._norm = 1.0
        self.quad_args = dict(limit=200)
        self._initialize()

    @property
    def bounds(self):
        return self._bounds

    @bounds.setter
    def bounds(self, new):
        self._bounds = _norm_bounds(new)
        self._initialize()

    def _initialize(self):
        lo, hi = self.bounds
        full_domain = [lo] + list(self.breakpoints) + [hi]
        self.domains = list(zip(full_domain[:-1], full_domain[1:]))

        # continuity at each breakpoint: comp[i](x)/norms[i] ==
        # comp[i-1](x)/norms[i-1], so the ratio must CHAIN through norms[i-1]
        # (without it any 3+-component prior is discontinuous)
        norms = np.ones(self.n_components)
        for i in range(1, self.n_components):
            x = self.breakpoints[i - 1]
            norms[i] = norms[i - 1] * self.components[i](x) / self.components[i - 1](x)

        tot = 0.0
        for comp, (a, b), norm in zip(self.components, self.domains, norms):
            tot += quad(lambda x: comp(x) / norm, a, b, **self.quad_args)[0]

        self.norms = norms * tot
        self.lognorms = np.log(self.norms)

        cumnorm = np.zeros(self.n_components)
        for i, (comp, (a, b), norm) in enumerate(zip(self.components, self.domains, self.norms)):
            cumnorm[i] = quad(lambda x: comp(x) / norm, a, b, **self.quad_args)[0]
        self.cumnorm = cumnorm

    def _pdf(self, x):
        i = np.digitize(x, self.breakpoints)
        if np.ndim(x) == 0:
            return self.components[int(i)](x) / self.norms[int(i)]
        out = np.empty_like(np.asarray(x, dtype=float))
        for k in range(self.n_components):
            m = i == k
            out[m] = self.components[k](np.asarray(x)[m]) / self.norms[k]
        return out

    def _lnpdf(self, x):
        i = int(np.digitize(x, self.breakpoints))
        return self.components[i].lnpdf(x) - self.lognorms[i]

    def _lnpdf_jax(self, x):
        # evaluate every component and select (few components; cheap)
        idx = jnp.digitize(jnp.asarray(x), jnp.asarray(self.breakpoints))
        lns = jnp.stack(
            [c.lnpdf_jax(x) - self.lognorms[k] for k, c in enumerate(self.components)], axis=0
        )
        return jnp.take_along_axis(lns, idx[None].astype(int), axis=0)[0]

    def lnpdf_jax(self, x):
        lo, hi = self.bounds
        ln = self._lnpdf_jax(x)
        if np.isfinite(lo):
            ln = jnp.where(x < lo, -jnp.inf, ln)
        if np.isfinite(hi):
            ln = jnp.where(x > hi, -jnp.inf, ln)
        return ln

    def sample(self, n, rng=None):
        r = _rng(rng)
        u = r.random(n)
        x = np.zeros(n)
        filled = np.zeros(n, dtype=bool)
        u_cumthresh = 0.0
        for comp, u_thresh, (a, b) in zip(self.components, self.cumnorm, self.domains):
            u_cumthresh += u_thresh
            mask = (u < u_cumthresh) & ~filled
            n_comp = int(mask.sum())
            if n_comp == 0:
                continue
            samples = comp.sample(n_comp, rng=r)
            oob = (samples < a) | (samples > b)
            while oob.sum():
                samples[oob] = comp.sample(int(oob.sum()), rng=r)
                oob = (samples < a) | (samples > b)
            x[mask] = samples
            filled |= mask
        return x


class FehPrior(Prior):
    """Local SDSS disk 2-Gaussian mixture + halo Gaussian (priors.py:345-406)."""

    def __init__(self, halo_fraction=0.001, local=True, **kwargs):
        self.halo_fraction = halo_fraction
        self.local = local
        super().__init__(**kwargs)

    def _disk(self, feh, use_jnp=False):
        xp = jnp if use_jnp else np
        if self.local:
            disk_norm = 2.5066282746310007  # integral of the unnormalized form
            return (
                1.0
                / disk_norm
                * (
                    0.8 / 0.15 * xp.exp(-0.5 * (feh - 0.016) ** 2 / 0.15 ** 2)
                    + 0.2 / 0.22 * xp.exp(-0.5 * (feh + 0.15) ** 2 / 0.22 ** 2)
                )
            )
        mu, sig = -0.3, 0.3
        return ONE_OVER_ROOT_2PI / sig * xp.exp(-0.5 * (feh - mu) ** 2 / sig ** 2)

    def _halo(self, feh, use_jnp=False):
        xp = jnp if use_jnp else np
        mu, sig = -1.5, 0.4
        return ONE_OVER_ROOT_2PI / sig * xp.exp(-0.5 * (feh - mu) ** 2 / sig ** 2)

    def _pdf(self, x):
        return self.halo_fraction * self._halo(x) + (1 - self.halo_fraction) * self._disk(x)

    def _lnpdf_jax(self, x):
        pdf = self.halo_fraction * self._halo(x, True) + (1 - self.halo_fraction) * self._disk(x, True)
        return jnp.log(jnp.maximum(pdf, 1e-300)) - math.log(self._norm)

    def lnpdf_jax(self, x):
        lo, hi = self.bounds
        ln = self._lnpdf_jax(x)
        if np.isfinite(lo):
            ln = jnp.where(x < lo, -jnp.inf, ln)
        if np.isfinite(hi):
            ln = jnp.where(x > hi, -jnp.inf, ln)
        return ln

    def sample(self, n, rng=None):
        r = _rng(rng)
        if self.local:
            w2, mu1, sig1, mu2, sig2 = 0.2, 0.016, 0.15, -0.15, 0.22
        else:
            w2, mu1, sig1, mu2, sig2 = 0.0, -0.3, 0.3, 0.0, 1.0
        x = r.standard_normal(n) * sig1 + mu1
        x2 = r.standard_normal(n) * sig2 + mu2
        m1 = r.random(n) < w2
        x[m1] = x2[m1]
        xhalo = r.standard_normal(n) * 0.4 - 1.5
        m2 = r.random(n) < self.halo_fraction
        x[m2] = xhalo[m2]
        if getattr(self, "_bounds", None) is not None and np.isfinite(self.bounds).all():
            lo, hi = self.bounds
            oob = (x < lo) | (x > hi)
            while oob.any():
                x[oob] = self.sample(int(oob.sum()), rng=r)
                oob = (x < lo) | (x > hi)
        return x


class EEP_prior(BoundedPrior):
    """Change-of-variables prior on EEP: p(eep) = p_orig(orig(eep)) |d orig/d eep|
    using the grid's dt_deep/dm_deep derivative columns (priors.py:409-465)."""

    def __init__(self, ic, orig_prior, bounds=None):
        self.ic = ic
        self.orig_prior = orig_prior
        self._bounds = bounds if bounds is not None else ic.eep_bounds
        self._norm = 1.0
        self.orig_par = ic.eep_replaces
        if self.orig_par == "age":
            self.deriv_prop = "dt_deep"
        elif self.orig_par == "mass":
            self.deriv_prop = "dm_deep"
        else:
            raise ValueError(f"eep_replaces must be 'age' or 'mass', got {self.orig_par}")
        self._icol_orig = self.ic.model.column_index[self.orig_par if self.orig_par != "mass" else "initial_mass"]
        self._icol_deriv = self.ic.model.column_index[self.deriv_prop]

    def _pars(self, eep, **kwargs):
        if self.orig_par == "age":
            return [kwargs["mass"], eep, kwargs["feh"]]
        return [eep, kwargs["age"], kwargs["feh"]]

    def _pdf(self, eep, **kwargs):
        vals = self.ic.interp_value(self._pars(eep, **kwargs), [self.orig_par if self.orig_par != "mass" else "initial_mass", self.deriv_prop])
        orig_val, dx_deep = np.asarray(vals).squeeze()
        return self.orig_prior(orig_val) * dx_deep

    def lnpdf_jax(self, eep, **kwargs):
        """Pure-jnp version: used inside jitted lnprior."""
        if self.orig_par == "age":
            pts = jnp.stack([kwargs["mass"], eep, kwargs["feh"]], axis=-1)
        else:
            pts = jnp.stack([eep, kwargs["age"], kwargs["feh"]], axis=-1)
        io = self.ic._param_index_order
        grid_pts = jnp.stack([pts[..., io[0]], pts[..., io[1]], pts[..., io[2]]], axis=-1)
        from .ops.interp import interp_nd

        vals = interp_nd(
            self.ic.model.values, self.ic.model.knots, grid_pts,
            icols=(self._icol_orig, self._icol_deriv), axis_maps=self.ic.model.axis_maps,
        )
        orig_val = vals[..., 0]
        deriv = vals[..., 1]
        ln = self.orig_prior.lnpdf_jax(orig_val) + jnp.log(jnp.maximum(deriv, 1e-300))
        ln = jnp.where(jnp.isfinite(orig_val) & (deriv > 0), ln, -jnp.inf)
        lo, hi = self.bounds
        return jnp.where((eep < lo) | (eep > hi), -jnp.inf, ln)

    def lnpdf(self, eep, **kwargs):
        lo, hi = self.bounds
        if np.ndim(eep) == 0 and (eep < lo or eep > hi):
            return -np.inf
        pdf = self._pdf(eep, **kwargs)
        return np.log(pdf) if pdf > 0 else -np.inf

    def _ladder_weights(self, eeps, c0, c1):
        """Unnormalized p(eep | conditioning) on ladder proposals: the
        change-of-variables weight orig_prior(orig(eep)) * |d orig/d eep|."""
        if self.orig_par == "age":
            vals = np.asarray(self.ic.interp_value([c0, eeps, c1], ["dt_deep", "age"]))
        else:
            vals = np.asarray(self.ic.interp_value([eeps, c0, c1], ["dm_deep", "initial_mass"]))
        deriv_val, orig_val = vals[..., 0], vals[..., 1]
        finite = np.isfinite(orig_val)
        safe = np.where(finite, orig_val, 1.0)  # placeholder; masked below
        orig_pr = np.nan_to_num(np.asarray(self.orig_prior.pdf(safe)), nan=0.0)
        return np.where(
            finite & np.isfinite(deriv_val) & (deriv_val > 0),
            orig_pr * deriv_val, 0.0,
        )

    def sample(self, n, rng=None, max_tries=100, **kwargs):
        """Weighted resampling over the integer EEP ladder (priors.py:431-462).

        With VECTOR conditioning (per-row age/feh or mass/feh), each row's
        EEP is drawn from its OWN conditional via per-row importance
        resampling of ``_n_prop`` uniform ladder proposals — a single global
        categorical would detach EEPs from their rows' conditioning (e.g. an
        age-10 row receiving an EEP weighted for age-6)."""
        r = _rng(rng)
        lo, hi = self.bounds
        names = ("mass", "feh") if self.orig_par == "age" else ("age", "feh")
        cond = [np.asarray(kwargs[k], dtype=float) for k in names]
        vector = any(np.ndim(c) > 0 and np.unique(c).size > 1 for c in cond)

        if not vector:
            # one shared condition: n proposals, resample ∝ weight
            c0 = np.broadcast_to(cond[0], (n,))
            c1 = np.broadcast_to(cond[1], (n,))
            for _ in range(max_tries):
                eeps = r.integers(int(lo), int(hi) + 1, n).astype(float)
                weights = self._ladder_weights(eeps, c0, c1)
                tot = weights.sum()
                if tot > 0:
                    idx = r.choice(n, size=n, replace=True, p=weights / tot)
                    return eeps[idx]
            raise ValueError(
                f"EEP_prior.sample: no ladder point in {self.bounds} has "
                f"support for conditioning {dict(zip(names, cond))}"
            )

        M = 32  # proposals per row
        c0 = np.broadcast_to(cond[0], (n,)).astype(float)
        c1 = np.broadcast_to(cond[1], (n,)).astype(float)
        out = np.full(n, np.nan)
        need = np.ones(n, dtype=bool)
        for _ in range(max_tries):
            m = int(need.sum())
            if m == 0:
                break
            props = r.integers(int(lo), int(hi) + 1, (m, M)).astype(float)
            w = self._ladder_weights(
                props.ravel(), np.repeat(c0[need], M), np.repeat(c1[need], M)
            ).reshape(m, M)
            tot = w.sum(axis=1)
            ok = tot > 0
            if ok.any():
                cdf = np.cumsum(w[ok], axis=1) / tot[ok, None]
                pick = (cdf < r.random(int(ok.sum()))[:, None]).sum(axis=1)
                rows = np.where(need)[0][ok]
                out[rows] = props[ok, pick]
                need[rows] = False
        if need.any():
            # rows whose (age, feh)/(mass, feh) has no supported ladder point
            # (e.g. an age beyond every track at that feh): return a uniform
            # ladder draw — such rows have zero posterior support anyway, and
            # callers' require_valid rejection loops redraw the WHOLE row
            # (conditioning included), which a raise here would prevent
            out[need] = r.integers(int(lo), int(hi) + 1, int(need.sum())).astype(float)
        return out

    def test_integral(self):
        pass


class AgePrior(FlatLogPrior):
    """Flat-log age prior over (5, 10.15) (priors.py:483-488)."""

    def __init__(self, **kwargs):
        super().__init__(bounds=(5, 10.15), **kwargs)


class DistancePrior(PowerLawPrior):
    """p(d) ~ d^2 out to max_distance (priors.py:491-493)."""

    def __init__(self, max_distance=10000, **kwargs):
        super().__init__(alpha=2.0, bounds=(0, max_distance), **kwargs)


class AVPrior(FlatPrior):
    """priors.py:496-499"""

    def __init__(self, **kwargs):
        bounds = kwargs.pop("bounds", (0, 1.0))
        super().__init__(bounds=bounds)


class QPrior(PowerLawPrior):
    """priors.py:502-505"""

    def __init__(self, **kwargs):
        bounds = kwargs.pop("bounds", (0.1, 1))
        super().__init__(alpha=0.3, bounds=bounds, **kwargs)


class SalpeterPrior(PowerLawPrior):
    """priors.py:508-511"""

    def __init__(self, **kwargs):
        bounds = kwargs.pop("bounds", (0.1, 10))
        super().__init__(alpha=-2.35, bounds=bounds, **kwargs)


class ChabrierPrior(BrokenPrior):
    """Chabrier (2003) eq 17 IMF: lognormal below 1 Msun + Salpeter above
    (priors.py:514-519)."""

    def __init__(self, **kwargs):
        bounds = kwargs.pop("bounds", (0.1, 100.0))
        super().__init__(
            [LogNormalPrior(math.log(0.079), 0.69 * math.log(10)), PowerLawPrior(-2.35, (1.0, 100.0))],
            [1.0],
            bounds=bounds,
            **kwargs,
        )
