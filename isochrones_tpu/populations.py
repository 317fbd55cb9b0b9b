"""Synthetic stellar population synthesis.

Rebuild of ``isochrones/populations.py`` (``StarFormationHistory``,
``StarFormationHistoryGrid``, ``BinaryDistribution``, ``StarPopulation``,
``deredden``). The forward model runs through the batched
``generate_binary`` pipeline (one vectorized EEP inversion + fused
interp/mag evaluation per draw round on device); the reference's
``exact_N`` rejection loop (populations.py:125-161) is kept host-side but
each round is a single batched call rather than per-star work.
"""

from __future__ import annotations

import re

import numpy as np

from .priors import ChabrierPrior, DistancePrior, FehPrior, PowerLawPrior

__all__ = [
    "StarFormationHistory",
    "StarFormationHistoryGrid",
    "BinaryDistribution",
    "StarPopulation",
    "deredden",
]


class StarFormationHistory:
    """SFH as a probability distribution over age in Gyr
    (reference populations.py:11-26)."""

    def __init__(self, dist=None):
        if dist is None:
            from scipy.stats import uniform

            dist = uniform(0, 10)
        self.dist = dist

    def sample_ages(self, N, rng=None):
        rvs = self.dist.rvs(int(N), random_state=np.random.default_rng(rng))
        return np.log10(1e9 * rvs)


class StarFormationHistoryGrid(StarFormationHistory):
    """SFH defined on arbitrary time bins (reference populations.py:29-41)."""

    def __init__(self, t_grid, sfh_grid):
        self.t_grid = np.asarray(t_grid)
        self.sfh_grid = np.asarray(sfh_grid)

    def sample_ages(self, N, rng=None):
        cdf = self.sfh_grid.cumsum() / self.sfh_grid.sum()
        u = np.random.default_rng(rng).random(int(N))
        i_bin = np.digitize(u, cdf)
        return np.log10(1e9 * self.t_grid[i_bin])


class BinaryDistribution:
    """IMF + binary fraction + mass-ratio distribution
    (reference populations.py:44-59)."""

    def __init__(self, imf, fB=0.4, gamma=0.3, mass_ratio_distribution=None):
        self.imf = imf
        self.fB = fB
        self.gamma = gamma
        if mass_ratio_distribution is None:
            mass_ratio_distribution = PowerLawPrior(self.gamma, bounds=(0.2, 1))
        self.mass_ratio_distribution = mass_ratio_distribution

    def sample(self, N, rng=None):
        rng = np.random.default_rng(rng) if not isinstance(rng, np.random.Generator) else rng
        primary_mass = self.imf.sample(int(N), rng=rng)
        is_binary = rng.random(int(N)) < self.fB
        q = self.mass_ratio_distribution.sample(int(N), rng=rng)
        secondary_mass = q * primary_mass * is_binary
        return primary_mass, secondary_mass


class StarPopulation:
    """Population generator (reference populations.py:62-166)."""

    def __init__(
        self,
        ic,
        imf=None,
        fB=0.4,
        gamma=0.3,
        sfh=None,
        feh=None,
        mass_ratio_distribution=None,
        distance=10.0,
        AV=0.0,
    ):
        self._ic = ic
        self.sfh = sfh if sfh is not None else StarFormationHistory()
        self.imf = imf if imf is not None else ChabrierPrior()
        self.fB = fB
        self.gamma = gamma
        self.binary_distribution = BinaryDistribution(
            self.imf, fB=fB, gamma=gamma, mass_ratio_distribution=mass_ratio_distribution
        )
        self.feh = feh if feh is not None else FehPrior()
        self.distance = distance
        self.AV = AV

    @property
    def ic(self):
        return self._ic

    def _draw(self, N, rng, accurate, **kwargs):
        masses, secondary = self.binary_distribution.sample(N, rng=rng)
        ages = self.sfh.sample_ages(N, rng=rng)
        fehs = self.feh.sample(N, rng=rng)
        distances = self.distance.sample(N, rng=rng) if hasattr(self.distance, "sample") else self.distance
        AVs = self.AV.sample(N, rng=rng) if hasattr(self.AV, "sample") else self.AV
        pop = self.ic.generate_binary(
            masses, secondary, ages, fehs, distance=distances, AV=AVs,
            all_As=True, accurate=accurate, **kwargs,
        )
        return pop

    def generate(self, N, accurate=False, exact_N=True, rng=None, max_rounds=100, **kwargs):
        """Generate N stars; with ``exact_N`` re-draw invalid (off-grid) rows
        until exactly N valid stars (reference populations.py:97-166)."""
        import pandas as pd

        N = int(N)
        rng = np.random.default_rng(rng) if not isinstance(rng, np.random.Generator) else rng

        if not exact_N:
            return self._draw(N, rng, accurate, **kwargs).dropna(subset=["mass_0"])

        # One fixed-size OVERDRAW covers the typical off-grid fraction in a
        # single device dispatch (measured ~10% invalid rows; a redraw round
        # costs a full extra dispatch + host readback + a pandas row-fill
        # that together double wall-clock). Rows are iid, so keeping the
        # first N valid rows of a larger draw is the same rejection sampling
        # as the reference's per-row redraw loop (populations.py:125-161).
        # M is a deterministic function of N -> one cached compile.
        M = int(np.ceil(N * 1.25)) + 16
        population = self._draw(M, rng, accurate, **kwargs).dropna(subset=["mass_0"])
        rounds = 0
        while len(population) < N and rounds < max_rounds:
            new_pop = self._draw(M, rng, accurate, **kwargs).dropna(subset=["mass_0"])
            population = pd.concat([population, new_pop], ignore_index=True)
            rounds += 1
        if len(population) < N:
            from .logger import getLogger

            getLogger().warning(
                "StarPopulation.generate(exact_N=True): only %d/%d valid "
                "rows after %d redraw rounds — the sampled parameter ranges "
                "barely intersect the grid; returned frame is padded with "
                "NaN rows.", len(population), N, max_rounds,
            )
            pad = pd.DataFrame(np.nan, index=range(N - len(population)), columns=population.columns)
            population = pd.concat([population, pad], ignore_index=True)
        return population.iloc[:N].reset_index(drop=True)


def deredden(pop, accurate=False, **kwargs):
    """AV=0 version of a generated population using its stored per-band
    extinctions (reference populations.py:169-199)."""
    new_pop = pop.copy()
    bands = [m.group(1) for c in pop.columns if (m := re.search(r"^(\w+)_mag$", c))]

    new_pop["AV_0"] = 0.0
    new_pop["AV_1"] = 0.0
    for b in bands:
        new_pop[f"{b}_mag"] -= new_pop[f"A_{b}"]
        new_pop[f"{b}_mag_0"] -= new_pop[f"A_{b}_0"]
        new_pop[f"{b}_mag_1"] -= new_pop[f"A_{b}_1"]
        new_pop[f"A_{b}"] = 0.0
        new_pop[f"A_{b}_0"] = 0.0
        new_pop[f"A_{b}_1"] = 0.0
    return new_pop
