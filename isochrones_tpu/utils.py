"""Math / small utilities.

JAX rewrite of ``isochrones/utils.py`` (reference file:lines cited per
function). All jnp functions here are pure, dtype-polymorphic, and safe under
``jit``/``vmap``.
"""

from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np

from .logger import getLogger

# Physical constants in cgs (values of astropy.constants at reference epoch;
# the reference imports astropy at isochrones/models.py:19-21).
G_CGS = 6.6743e-08
MSUN_CGS = 1.98840987069805e33
RSUN_CGS = 6.957e10


def band_pairs(bands):
    """reference: isochrones/utils.py:13-14"""
    return [(bands[i], bands[-1]) for i in range(len(bands) - 1)]


def addmags_jnp(mags, axis=0):
    """Flux-space magnitude addition (reference: ``fast_addmags`` isochrones/utils.py:67-75).

    Vectorized: sums fluxes along ``axis``. NaN components propagate as NaN,
    +inf components contribute zero flux (used for "no secondary" sentinels).
    """
    flux = 10.0 ** (-0.4 * jnp.asarray(mags))
    return -2.5 * jnp.log10(jnp.sum(flux, axis=axis))


def addmags(*mags):
    """NumPy/host version with optional (mag, unc) pairs.

    reference: isochrones/utils.py:43-64
    """
    tot = 0
    uncs = []
    for mag in mags:
        if np.isscalar(mag) or isinstance(mag, (np.ndarray, jnp.ndarray)) or not hasattr(mag, "__len__"):
            tot = tot + 10 ** (-0.4 * np.asarray(mag))
        else:
            try:
                m, dm = mag
            except (TypeError, ValueError):
                tot = tot + 10 ** (-0.4 * np.asarray(mag))
                continue
            f = 10 ** (-0.4 * np.asarray(m))
            tot = tot + f
            uncs.append(f * (1 - 10 ** (-0.4 * np.asarray(dm))))

    totmag = -2.5 * np.log10(tot)
    if uncs:
        f_unc = np.sqrt(np.sum([u ** 2 for u in uncs], axis=0))
        return totmag, -2.5 * np.log10(1 - f_unc / tot)
    return totmag


def fast_addmags(mags):
    """reference: isochrones/utils.py:67-75"""
    return float(-2.5 * np.log10(np.sum(10 ** (-0.4 * np.asarray(mags, dtype=float))))) if np.ndim(mags) else float(mags)


def distance(pos0, pos1):
    """Distance between two (separation, PA) positions (reference: isochrones/utils.py:78-93)."""
    r0, pa0 = pos0
    ra0 = r0 * np.sin(pa0 * np.pi / 180)
    dec0 = r0 * np.cos(pa0 * np.pi / 180)
    r1, pa1 = pos1
    ra1 = r1 * np.sin(pa1 * np.pi / 180)
    dec1 = r1 * np.cos(pa1 * np.pi / 180)
    return np.sqrt((ra1 - ra0) ** 2 + (dec1 - dec0) ** 2)


def trapz(y, x):
    """Trapezoid rule (reference: isochrones/utils.py:96-105). jnp, reduces last axis."""
    y = jnp.asarray(y)
    x = jnp.asarray(x)
    dx = x[..., 1:] - x[..., :-1]
    return jnp.sum(0.5 * (y[..., 1:] + y[..., :-1]) * dx, axis=-1)


def polyval(p, x):
    """Horner polynomial evaluation, highest degree first (reference: isochrones/utils.py:108-114)."""
    p = jnp.asarray(p)
    x = jnp.asarray(x)
    result = jnp.zeros_like(x * p[0])
    for coeff in p:
        result = result * x + coeff
    return result


def download_file(url, path=None, clobber=False):
    """Streamed HTTP download with exists-check (reference: isochrones/utils.py:17-40)."""
    from .config import OFFLINE

    if path is None:
        raise ValueError("path is required")
    if os.path.exists(path) and not clobber:
        getLogger().info("%s exists; not downloading.", path)
        return path
    if OFFLINE:
        raise RuntimeError(f"Offline mode: cannot download {url}")

    import requests

    r = requests.get(url, stream=True)
    r.raise_for_status()
    with open(path, "wb") as f:
        for chunk in r.iter_content(chunk_size=1 << 20):
            if chunk:
                f.write(chunk)
    return path
