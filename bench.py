"""Benchmark suite: one accelerator counterpart for every BASELINE.md row.

Reference baselines are the `%timeit` outputs embedded in the reference's docs
notebooks (single CPU core, numba warm — see BASELINE.md). Each benchmark here
times the equivalent computation batched on one device and reports throughput
plus `vs_baseline` (ours / reference).

Prints ONE JSON line. Top-level fields are the headline metric (batched fused
binary-star lnpost evals/s/chip vs the reference's 719 us/eval,
docs/multiple.ipynb cell 9); the full per-row suite is under "suite".
"""

import json
import time
import traceback

import numpy as np

# ---------------------------------------------------------------- baselines
# BASELINE.md rows, converted to throughput (per-second) figures.
BASE_BINARY_LNPOST = 1.0 / 719e-6      # binary lnpost evals/s       (multiple.ipynb c9)
BASE_INTERP_3D = 1.0 / 12.5e-6         # 3-d interp pts/s, 1 col     (modelgrids.ipynb c13)
BASE_INTERP_2D_BATCH = 1e4 / 15.1e-3   # batched 2-d interp pts/s    (interpolate.ipynb c9)
BASE_TREE_LNPOST = 1.0 / 1.23e-3       # tree resolved-binary lnpost (multiple.ipynb c23)
BASE_GET_EEP_FAST = 1.0 / 4.26e-6      # fast EEP inversions/s       (grid_interpolator.ipynb c24)
BASE_GET_EEP_ACC = 1.0 / 4.56e-3       # accurate EEP inversions/s   (grid_interpolator.ipynb c24)
BASE_GENERATE = 1e4 / 112e-3           # generate stars/s            (grid_interpolator.ipynb c20)
BASE_POPULATION = 1e3 / 1.24           # StarPopulation stars/s      (populations.ipynb c6)
BASE_FIT_SECONDS = 14 * 60.0           # binary nested fit seconds   (multiple.ipynb c11)


def _time_loop(fn, n_rep):
    """Median-free simple timing: warmup (compile) + n_rep timed calls."""
    out = fn()
    _block(out)
    t0 = time.perf_counter()
    for _ in range(n_rep):
        out = fn()
    _block(out)
    return (time.perf_counter() - t0) / n_rep


def _block(out):
    import jax

    for leaf in jax.tree_util.tree_leaves(out):
        if hasattr(leaf, "block_until_ready"):
            leaf.block_until_ready()


def _true_star(iso, pars, bands):
    Teff, logg, _, mags = iso.interp_mag(list(pars), list(bands))
    return Teff, logg, np.asarray(mags)


class Bench:
    def __init__(self, t_start=None, budget_s=None):
        import os

        import jax

        from isochrones_tpu.device import on_accelerator

        self.platform = jax.default_backend()
        self.on_accel = on_accelerator()
        # f32 grids on the accelerator (its f64 rate is a fraction of f32's,
        # and the compiled cluster kernel is f32 only); f64 elsewhere.
        self.dtype = np.float32 if self.on_accel else np.float64

        from isochrones_tpu import get_ichrone

        # MIST-scale grids (SURVEY §6: 15 feh x ~196 mass x 1710 eep)
        self.iso = get_ichrone(
            "synthetic", n_feh=15, n_mass=196, n_eep=1710, n_age=107, dtype=self.dtype
        )
        self.track = self.iso.track
        self.rng = np.random.default_rng(0)
        self.results = []
        # internal wall-clock budget: rows that won't fit are skipped with a
        # marker instead of being truncated mid-row, so the stdout contract
        # below always completes. Override with ISOTPU_BENCH_BUDGET_S.
        self.t_start = t_start if t_start is not None else time.perf_counter()
        self.budget_s = budget_s if budget_s is not None else float(
            os.environ.get("ISOTPU_BENCH_BUDGET_S", "1400")
        )

    def elapsed(self):
        return time.perf_counter() - self.t_start

    def remaining(self):
        return self.budget_s - self.elapsed()

    def run(self, name, fn, est_s=60.0):
        """Run one row unless the remaining budget can't fit ``est_s``
        (a conservative per-row estimate)."""
        import sys

        t0 = time.perf_counter()
        if self.on_accel and est_s > self.remaining():
            self.results.append({
                "metric": name,
                "skipped": "over-budget",
                "est_seconds": est_s,
                "remaining_seconds": round(self.remaining(), 1),
            })
            print(f"[bench {len(self.results)}] {name}: SKIPPED (over-budget: "
                  f"est {est_s:.0f}s > {self.remaining():.0f}s left)",
                  file=sys.stderr, flush=True)
            self._emit_progress()
            return
        try:
            self.results.append(fn())
        except Exception:
            tb = traceback.format_exc()
            self.results.append({"metric": name, "error": tb.splitlines()[-1],
                                 "seconds": round(time.perf_counter() - t0, 1)})
            # full traceback to stderr: the record keeps only the last line
            print(f"[bench {len(self.results)}] {name}: TRACEBACK\n{tb}",
                  file=sys.stderr, flush=True)
        # stderr progress marker (stdout carries only the JSON contract):
        # lets the driver's log show where a long suite is, and which row
        # a timeout killed
        row = self.results[-1]
        status = "ERROR" if "error" in row else f"{row.get('value')} {row.get('unit', '')}"
        print(
            f"[bench {len(self.results)}] {name}: {status} "
            f"({time.perf_counter() - t0:.0f}s)",
            file=sys.stderr, flush=True,
        )
        self._emit_progress()

    def headline(self):
        """Compact driver-parseable headline from the rows so far."""
        first = self.results[0] if self.results else {}
        if self.results and "error" not in first and "skipped" not in first:
            out = {k: v for k, v in first.items() if k != "suite"}
        else:
            out = {
                "metric": "binary-star fused lnpost throughput",
                "value": 0.0,
                "unit": "evals/s/chip",
                "vs_baseline": 0.0,
            }
            if self.results and "error" in first:
                out["error"] = first["error"]
        out["metric"] = f"{out['metric']} ({self.platform}, MIST-scale grids)"
        out["suite_rows"] = len(self.results)
        return out

    def _emit_progress(self):
        """After EVERY row: newest stdout line = one complete compact
        headline (so a timeout at any point still leaves a parseable tail),
        and BENCH_LOCAL.json holds every completed row."""
        print(json.dumps(self.headline()), flush=True)
        self.write_local()

    def write_local(self, final=False):
        import os

        if not self.on_accel:
            # only accelerator runs write the local record
            return
        full = dict(self.headline())
        full.pop("suite_rows", None)
        full["suite"] = self.results
        if not final:
            full["in_progress"] = True
        local = os.path.join(os.path.dirname(os.path.abspath(__file__)), "BENCH_LOCAL.json")
        tmp = local + ".tmp"
        with open(tmp, "w") as f:
            f.write(json.dumps(full) + "\n")
        os.replace(tmp, local)

    # ------------------------------------------------- 1. headline: binary lnpost
    def bench_binary_lnpost(self):
        import jax.numpy as jnp

        from isochrones_tpu.starmodel import BinaryStarModel

        iso = self.iso
        pars = [350.0, 9.0, 0.0, 200.0, 0.1]
        bands = ["J", "H", "K", "G"]
        Teff, logg, mags = _true_star(iso, pars, bands)
        model = BinaryStarModel(
            iso,
            Teff=(Teff, 100.0),
            logg=(logg, 0.1),
            J=(float(mags[0]), 0.02),
            H=(float(mags[1]), 0.02),
            K=(float(mags[2]), 0.02),
            G=(float(mags[3]), 0.01),
            parallax=(5.0, 0.05),
        )
        batch = 1 << 17 if self.on_accel else 1 << 14
        p = np.stack(
            [
                self.rng.uniform(200, 450, batch),
                self.rng.uniform(200, 450, batch),
                self.rng.uniform(8.5, 9.5, batch),
                self.rng.uniform(-0.5, 0.3, batch),
                self.rng.uniform(100, 300, batch),
                self.rng.uniform(0.0, 0.5, batch),
            ],
            axis=-1,
        ).astype(self.dtype)
        p = jnp.asarray(p)
        fn = model.lnpost_batch
        dt = _time_loop(lambda: fn(p), 20 if self.on_accel else 3)
        rate = batch / dt
        return {
            "metric": "binary-star fused lnpost throughput",
            "value": round(rate, 1),
            "unit": "evals/s/chip",
            "baseline": round(BASE_BINARY_LNPOST, 1),
            "vs_baseline": round(rate / BASE_BINARY_LNPOST, 1),
        }

    # ------------------------------------------- 2. raw 3-d interp (track grid)
    def bench_interp_3d(self):
        import jax
        import jax.numpy as jnp

        from isochrones_tpu.ops.interp import interp_nd

        g = self.track.model  # (feh, mass, eep) MIST-scale track grid
        icol = (g.column_index["logg"],)
        batch = 1 << 20 if self.on_accel else 1 << 16
        knots = [np.asarray(k) for k in g.knots]
        pts = np.stack(
            [self.rng.uniform(k[0], k[-1], batch) for k in knots], axis=-1
        ).astype(self.dtype)
        pts = jnp.asarray(pts)

        fn = jax.jit(
            lambda grid, p: interp_nd(grid.values, grid.knots, p, icols=icol, axis_maps=grid.axis_maps)
        )
        dt = _time_loop(lambda: fn(g, pts), 20 if self.on_accel else 5)
        rate = batch / dt
        return {
            "metric": "3-d grid interpolation (1 column, MIST-scale track grid)",
            "value": round(rate, 1),
            "unit": "pts/s/chip",
            "baseline": round(BASE_INTERP_3D, 1),
            "vs_baseline": round(rate / BASE_INTERP_3D, 1),
        }

    # ---------------------------------------------------- 3. batched 2-d interp
    def bench_interp_2d(self):
        import jax
        import jax.numpy as jnp

        from isochrones_tpu.ops.interp import GridData, compute_axis_maps, interp_nd

        n0, n1 = 100, 150
        k0 = np.linspace(0.0, 1.0, n0)
        k1 = np.linspace(-1.0, 1.0, n1)
        vals = np.random.default_rng(1).normal(size=(n0, n1, 1))
        g = GridData(
            values=jnp.asarray(vals.astype(self.dtype)),
            knots=(jnp.asarray(k0.astype(self.dtype)), jnp.asarray(k1.astype(self.dtype))),
            columns=("v",),
            axis_maps=compute_axis_maps([k0, k1]),
        )
        batch = 1 << 20 if self.on_accel else 1 << 16
        pts = np.stack(
            [self.rng.uniform(0, 1, batch), self.rng.uniform(-1, 1, batch)], axis=-1
        ).astype(self.dtype)
        pts = jnp.asarray(pts)
        fn = jax.jit(
            lambda grid, p: interp_nd(grid.values, grid.knots, p, icols=(0,), axis_maps=grid.axis_maps)
        )
        dt = _time_loop(lambda: fn(g, pts), 20 if self.on_accel else 5)
        rate = batch / dt
        return {
            "metric": "batched 2-d grid interpolation",
            "value": round(rate, 1),
            "unit": "pts/s/chip",
            "baseline": round(BASE_INTERP_2D_BATCH, 1),
            "vs_baseline": round(rate / BASE_INTERP_2D_BATCH, 1),
        }

    # ------------------------------------------- 4. tree resolved-binary lnpost
    def bench_tree_lnpost(self):
        import jax.numpy as jnp

        from isochrones_tpu.observation import Observation, ObservationTree, Source
        from isochrones_tpu.treemodel import StarModel
        from isochrones_tpu.utils import addmags

        iso = self.iso
        parsA = [350.0, 9.0, 0.0, 200.0, 0.1]
        parsB = [300.0, 9.0, 0.0, 200.0, 0.1]
        TeffA, _, magsA = _true_star(iso, parsA, ["J", "H", "K"])
        _, _, magsB = _true_star(iso, parsB, ["J", "H", "K"])

        # blended wide-field photometry + resolved AO observation
        # (the docs/multiple.ipynb resolved-binary configuration)
        t = ObservationTree(name="bench-resolved")
        for i, band in enumerate(["J", "H"]):
            o = Observation("2MASS", band, 4.0)
            o.add_source(Source(addmags(magsA[i], magsB[i]), 0.02))
            t.add_observation(o)
        o = Observation("NIRC2", "K", 0.1)
        o.add_source(Source(float(magsA[2]), 0.02, separation=0.0, pa=0.0))
        o.add_source(Source(float(magsB[2]), 0.02, separation=0.5, pa=100.0))
        t.add_observation(o)
        model = StarModel(iso, obs=t, N=1, index=[0, 0], parallax=(5.0, 0.05))

        n_par = len(model.param_names)
        base = np.asarray([350.0, 300.0, 9.0, 0.0, 200.0, 0.1])[:n_par]
        batch = 1 << 15 if self.on_accel else 1 << 12
        p = base[None, :] + self.rng.normal(
            0, [5.0, 5.0, 0.02, 0.02, 2.0, 0.01][:n_par], size=(batch, n_par)
        )
        p = jnp.asarray(p.astype(self.dtype))
        fn = model.lnpost_batch
        dt = _time_loop(lambda: fn(p), 10 if self.on_accel else 3)
        rate = batch / dt
        return {
            "metric": "tree StarModel resolved-binary lnpost throughput",
            "value": round(rate, 1),
            "unit": "evals/s/chip",
            "baseline": round(BASE_TREE_LNPOST, 1),
            "vs_baseline": round(rate / BASE_TREE_LNPOST, 1),
        }

    # --------------------------------------------------------- 5. EEP inversion
    def bench_get_eep(self, accurate):
        import jax.numpy as jnp

        track = self.track
        batch = (1 << 18 if self.on_accel else 1 << 14) if not accurate else (
            1 << 14 if self.on_accel else 1 << 10
        )
        mass = jnp.asarray(self.rng.uniform(0.5, 2.0, batch).astype(self.dtype))
        age = jnp.asarray(self.rng.uniform(8.5, 9.8, batch).astype(self.dtype))
        feh = jnp.asarray(self.rng.uniform(-0.4, 0.3, batch).astype(self.dtype))
        # NOTE: no outer jit here — get_eep_batch dispatches to pre-jitted
        # kernels that take the grids as ARGUMENTS; an outer jit would embed
        # the full grid as a compile-time constant.
        fn = lambda m, a, f: track.get_eep_batch(m, a, f, accurate=accurate)
        dt = _time_loop(lambda: fn(mass, age, feh), 10 if self.on_accel else 3)
        rate = batch / dt
        base = BASE_GET_EEP_ACC if accurate else BASE_GET_EEP_FAST
        label = "accurate (Newton)" if accurate else "fast (grid)"
        return {
            "metric": f"get_eep {label} inversion throughput",
            "value": round(rate, 1),
            "unit": "evals/s/chip",
            "baseline": round(base, 1),
            "vs_baseline": round(rate / base, 1),
        }

    # -------------------------------------------------------- 6. generate 10^4
    def bench_generate(self):
        track = self.track
        N = 10_000
        mass = self.rng.uniform(0.5, 2.0, N)
        age = self.rng.uniform(8.5, 9.8, N)
        feh = self.rng.uniform(-0.4, 0.3, N)
        track.generate(mass, age, feh)  # warmup (compile)
        n_rep = 5
        t0 = time.perf_counter()
        for _ in range(n_rep):
            df = track.generate(mass, age, feh)
        dt = (time.perf_counter() - t0) / n_rep
        assert len(df) == N
        rate = N / dt
        return {
            "metric": "generate 10^4 stars (props + mags, host round-trip)",
            "value": round(rate, 1),
            "unit": "stars/s",
            "baseline": round(BASE_GENERATE, 1),
            "vs_baseline": round(rate / BASE_GENERATE, 1),
        }

    # --------------------------------------- 6b. device-resident generate
    def bench_generate_device(self):
        """Same fused kernel as bench_generate but WITHOUT host readback
        (the readback would dominate the host row and hide device-side
        regressions). This is the rate device-resident consumers
        (populations, samplers) actually see."""
        import jax.numpy as jnp

        track = self.track
        N = 1 << 16 if self.on_accel else 10_000
        mass = self.rng.uniform(0.5, 2.0, N)
        age = self.rng.uniform(8.5, 9.8, N)
        feh = self.rng.uniform(-0.4, 0.3, N)
        args = (jnp.asarray(mass.astype(self.dtype)),
                jnp.asarray(age.astype(self.dtype)),
                jnp.asarray(feh.astype(self.dtype)))
        fn = lambda: track.generate_device(*args)
        dt = _time_loop(fn, 10 if self.on_accel else 3)
        rate = N / dt
        return {
            "metric": "generate (props + mags, device-resident, no readback)",
            "value": round(rate, 1),
            "unit": "stars/s/chip",
            "baseline": round(BASE_GENERATE, 1),
            "vs_baseline": round(rate / BASE_GENERATE, 1),
        }

    # ------------------------------------------- 7. StarPopulation.generate(1000)
    def bench_population(self):
        from isochrones_tpu.populations import StarPopulation
        from isochrones_tpu.priors import (
            AVPrior,
            DistancePrior,
            GaussianPrior,
            SalpeterPrior,
        )

        pop = StarPopulation(
            self.track,
            imf=SalpeterPrior(bounds=(0.4, 2.5)),
            fB=0.4,
            gamma=0.3,
            feh=GaussianPrior(-0.1, 0.15),
            distance=DistancePrior(max_distance=3000),
            AV=AVPrior(bounds=[0, 1]),
        )
        N = 1000
        pop.generate(N, rng=1)  # warmup
        n_rep = 3
        t0 = time.perf_counter()
        for i in range(n_rep):
            df = pop.generate(N, rng=2 + i, exact_N=True)
        dt = (time.perf_counter() - t0) / n_rep
        assert len(df) == N
        rate = N / dt
        return {
            "metric": "StarPopulation.generate(1000) exact_N",
            "value": round(rate, 1),
            "unit": "stars/s",
            "baseline": round(BASE_POPULATION, 1),
            "vs_baseline": round(rate / BASE_POPULATION, 1),
        }

    # --------------------------------------------------------- 8. cluster lnlike
    def bench_cluster(self):
        import jax.numpy as jnp

        from isochrones_tpu.cluster import SimulatedCluster, StarClusterModel

        iso = self.iso
        sim = SimulatedCluster(
            50, age=9.0, feh=0.0, distance=300.0, AV=0.05, alpha=-2.0,
            gamma=0.3, fB=0.3, bands=("J", "H", "K"), mass_range=(0.6, 2.0),
            ic=iso, rng=0, phot_unc=0.02,
        )
        model = StarClusterModel(
            iso, sim, eep_bounds=(1, 800), max_distance=3000, minq=0.2
        )
        batch = 16 if self.on_accel else 2
        base = np.asarray([9.0, 0.0, 300.0, 0.05, -2.0, 0.3, 0.3])
        p = base[None, :] + self.rng.normal(
            0, [0.02, 0.02, 2.0, 0.01, 0.05, 0.02, 0.02], size=(batch, 7)
        )
        p = jnp.asarray(p.astype(self.dtype))
        fn = model.lnpost_batch
        dt = _time_loop(lambda: fn(p), 5 if self.on_accel else 2)
        rate = batch / dt
        return {
            "metric": "hierarchical cluster lnpost (50 stars, 800-EEP grid)",
            "value": round(rate, 2),
            "unit": "evals/s/chip",
            "baseline": None,  # no reference %timeit exists for cluster lnlike
            "vs_baseline": None,
        }

    def bench_cluster_full_eep(self):
        """Dress rehearsal for real MIST: the cluster marginal at the FULL
        1710-EEP ladder — the real grid's worst-case (EEP, EEP') plane is
        1710^2, 3.7x the 800-EEP row's — plus peak device memory."""
        import jax
        import jax.numpy as jnp

        from isochrones_tpu.cluster import SimulatedCluster, StarClusterModel

        iso = self.iso
        max_eep = int(iso.maxeep)
        sim = SimulatedCluster(
            50, age=9.0, feh=0.0, distance=300.0, AV=0.05, alpha=-2.0,
            gamma=0.3, fB=0.3, bands=("J", "H", "K"), mass_range=(0.6, 2.0),
            ic=iso, rng=0, phot_unc=0.02,
        )
        model = StarClusterModel(
            iso, sim, eep_bounds=(1, max_eep), max_distance=3000, minq=0.2
        )
        batch = 16 if self.on_accel else 1
        base = np.asarray([9.0, 0.0, 300.0, 0.05, -2.0, 0.3, 0.3])
        p = base[None, :] + self.rng.normal(
            0, [0.02, 0.02, 2.0, 0.01, 0.05, 0.02, 0.02], size=(batch, 7)
        )
        p = jnp.asarray(p.astype(self.dtype))
        fn = model.lnpost_batch
        dt = _time_loop(lambda: fn(p), 3 if self.on_accel else 1)
        rate = batch / dt
        row = {
            "metric": f"hierarchical cluster lnpost (50 stars, FULL {max_eep}-EEP ladder)",
            "value": round(rate, 2),
            "unit": "evals/s/chip",
            "baseline": None,
            "vs_baseline": None,
        }
        try:
            stats = jax.local_devices()[0].memory_stats()
            row["peak_device_gb"] = round(stats["peak_bytes_in_use"] / 2 ** 30, 2)
        except Exception:
            pass
        return row

    # --------------------------------------- 9. end-to-end binary engine fits
    def _binary_fit_model(self):
        from isochrones_tpu.starmodel import BinaryStarModel

        iso = self.iso
        pars = [350.0, 9.0, 0.0, 200.0, 0.1]
        bands = ["J", "H", "K", "G"]
        Teff, logg, mags1 = _true_star(iso, pars, bands)
        _, _, mags2 = _true_star(iso, [300.0] + pars[1:], bands)
        tot = -2.5 * np.log10(10 ** (-0.4 * mags1) + 10 ** (-0.4 * mags2))
        return BinaryStarModel(
            iso,
            Teff=(Teff, 100.0),
            logg=(logg, 0.1),
            J=(float(tot[0]), 0.02),
            H=(float(tot[1]), 0.02),
            K=(float(tot[2]), 0.02),
            G=(float(tot[3]), 0.01),
            parallax=(5.0, 0.05),
        )

    def bench_nested_fit(self):
        model = self._binary_fit_model()
        # reference convention: n_live=1000 (starmodel.py:719, the 14-min
        # baseline's own setting). Two INDEPENDENT such runs advance in
        # lockstep through one vmapped program (n_runs=2): same per-dispatch
        # fan-out as a single 2000-live run but half the sequential depth,
        # plus an empirical (run-scatter) logzerr. n_batch=64 x n_chains=16
        # keeps the per-walk-step fan-out at 2048 points; the shrinkage
        # schedule uses the exact harmonic batched-K increments
        # (samplers/nested.py::_ln_x_schedule). Best of 2 timed fits.
        n_live, n_runs = (1000, 2) if self.on_accel else (200, 1)
        n_fit = 2 if self.on_accel else 1
        times, logzs, esss = [], [], []
        for i in range(n_fit):
            t0 = time.perf_counter()
            res = model.fit_multinest(
                n_live_points=n_live, n_batch=64, n_chains=16, seed=i, n_runs=n_runs
            )
            times.append(time.perf_counter() - t0)
            assert np.isfinite(res.logz)
            logzs.append(float(res.logz))
            esss.append(float(res.ess))
        dt = float(np.min(times))
        return {
            "metric": f"end-to-end binary-star nested fit (n_live={n_live} x {n_runs} runs, best of {n_fit})",
            "value": round(dt, 2),
            "unit": "seconds (lower is better)",
            "baseline": BASE_FIT_SECONDS,
            "vs_baseline": round(BASE_FIT_SECONDS / dt, 1),  # speedup factor
            "times": [round(t, 1) for t in times],
            "logz": round(float(np.median(logzs)), 2),
            "ess": round(float(np.median(esss)), 1),
        }

    def bench_nested_dynamic_fit(self):
        """e2e DYNAMIC nested fit (Higson-style posterior threads) at matched
        posterior quality: dynamic reaches its ESS target in several times
        fewer likelihood evaluations than the static flagship row, but
        where batched static replacement makes likelihood calls nearly
        free, sequential depth + host-side merges dominate the wall-clock.
        This row keeps that trade-off honest in seconds."""
        model = self._binary_fit_model()
        n_live, min_ess = (250, 2000.0) if self.on_accel else (100, 500.0)
        n_fit = 2 if self.on_accel else 1
        times, logzs, esss, calls = [], [], [], []
        for i in range(n_fit):
            t0 = time.perf_counter()
            res = model.fit_multinest(
                n_live_points=n_live, n_batch=32, n_chains=16, seed=i,
                dynamic=True, min_ess=min_ess,
            )
            times.append(time.perf_counter() - t0)
            assert np.isfinite(res.logz)
            assert res.ess >= min_ess
            logzs.append(float(res.logz))
            esss.append(float(res.ess))
            calls.append(int(res.n_iter))
        dt = float(np.min(times))
        return {
            "metric": f"end-to-end binary-star DYNAMIC nested fit (n_live={n_live}, min_ess={min_ess:.0f}, best of {n_fit})",
            "value": round(dt, 2),
            "unit": "seconds (lower is better)",
            "baseline": BASE_FIT_SECONDS,
            "vs_baseline": round(BASE_FIT_SECONDS / dt, 1),
            "times": [round(t, 1) for t in times],
            "logz": round(float(np.median(logzs)), 2),
            "ess": round(float(np.median(esss)), 1),
            "n_likelihood_calls": int(np.median(calls)),
        }

    def bench_mcmc_fit(self):
        """e2e ensemble-MCMC fit (the reference's emcee path; same posterior
        as the 14-min MultiNest baseline, so vs_baseline is the engine-for-
        engine wall-clock substitution factor)."""
        model = self._binary_fit_model()
        nwalkers, nburn, niter = (256, 1500, 300) if self.on_accel else (64, 300, 100)
        times = []
        for rep in range(2 if self.on_accel else 1):
            t0 = time.perf_counter()
            df = model.fit_mcmc(nwalkers=nwalkers, nburn=nburn, niter=niter,
                                seed=1 + rep, moves="mixed")
            times.append(time.perf_counter() - t0)
        # report the WARM run: the scan program compiles once and is cached
        # persistently after
        dt = times[-1]
        assert np.isfinite(df["lnprob"]).any()
        return {
            "metric": f"end-to-end binary-star ensemble-MCMC fit ({nwalkers}w x {nburn}+{niter}, warm)",
            "value": round(dt, 2),
            "unit": "seconds (lower is better)",
            "baseline": BASE_FIT_SECONDS,
            "vs_baseline": round(BASE_FIT_SECONDS / dt, 1),
            "n_samples": int(len(df)),
            "times": [round(t, 1) for t in times],
        }

    def bench_nuts_fit(self):
        """e2e NUTS fit (autodiff gradients through the fused lnpost; no
        reference counterpart engine — compared against the same 14-min
        posterior baseline)."""
        model = self._binary_fit_model()
        n_chains, n_warmup, n_samples = (16, 800, 1000) if self.on_accel else (8, 300, 300)
        times = []
        for rep in range(2 if self.on_accel else 1):
            t0 = time.perf_counter()
            df = model.fit_nuts(n_chains=n_chains, n_warmup=n_warmup,
                                n_samples=n_samples, seed=2 + rep)
            times.append(time.perf_counter() - t0)
        dt = times[-1]  # warm run (see bench_mcmc_fit)
        assert np.isfinite(df["lnprob"]).any()
        # a frozen sampler (step size at the dtype resolution floor — an
        # f32 failure mode) returns finite lnprob on init-cloud points;
        # assert the chains actually moved
        res = model._nuts_result
        eps_floor = 100.0 * np.finfo(np.float32).eps
        assert np.all(res.step_size > eps_floor), (
            f"NUTS chains frozen: step sizes {res.step_size}"
        )
        for p in model.param_names:
            assert df[p].std() > 0, f"degenerate NUTS posterior in {p}"
        return {
            "metric": f"end-to-end binary-star NUTS fit ({n_chains}c x {n_warmup}+{n_samples}, warm)",
            "value": round(dt, 2),
            "unit": "seconds (lower is better)",
            "baseline": BASE_FIT_SECONDS,
            "vs_baseline": round(BASE_FIT_SECONDS / dt, 1),
            "n_samples": int(len(df)),
            "times": [round(t, 1) for t in times],
        }

    # ---------------------------------------- 10b. catalog-scale batch fit
    def bench_catalog_fit(self):
        """Whole-catalog throughput: 256 stars, every star's 64-walker
        ensemble advanced in ONE jitted program (BatchStarFitter). The
        production-deployment number: the reference fits catalogs one
        MultiNest run per star (~14 min each on the baseline laptop), so the
        per-star rate here is compared against that serial figure (engine
        parity is benchmarked separately by the nested-fit row)."""
        from isochrones_tpu.batch import BatchStarFitter
        from isochrones_tpu.cluster import simulate_cluster

        iso = self.iso
        n_stars = 256 if self.on_accel else 8
        cat = simulate_cluster(
            n_stars, 9.55, 0.0, 400.0, 0.05, -2.2, 0.3, 0.0, iso=iso, rng=7,
            mass_range=(0.75, 1.1), distance_scatter=40.0,
        )
        fitter = BatchStarFitter(iso, cat, max_distance=3000)
        nwalkers, nburn, niter = (64, 300, 50) if self.on_accel else (16, 10, 5)
        times = []
        for rep in range(2 if self.on_accel else 1):
            t0 = time.perf_counter()
            fitter.fit_mcmc(nwalkers=nwalkers, nburn=nburn, niter=niter, thin=2, seed=1 + rep)
            times.append(time.perf_counter() - t0)
        dt = times[-1]  # warm run (see bench_mcmc_fit)
        med = np.nanmedian(fitter.samples[:, :, 3])  # distance draws
        assert 200 < med < 800, med
        rate = n_stars / dt
        return {
            "metric": f"catalog batch fit ({n_stars} stars x {nwalkers}w x {nburn}+{niter}, one program, warm)",
            "value": round(rate, 2),
            "unit": "stars/s (posterior per star)",
            "baseline": round(1.0 / BASE_FIT_SECONDS, 6),
            "vs_baseline": round(rate * BASE_FIT_SECONDS, 1),
            "seconds_total": round(dt, 1),
            "times": [round(t, 1) for t in times],
        }

    def bench_catalog_nested_dynamic(self):
        """Whole-catalog DYNAMIC nested sampling: every star's NS run (and
        its posterior-focused threads) advanced in ONE vmapped program
        (BatchStarFitter.fit_multinest(dynamic=True)). This is the regime
        dynamic NS wins on an accelerator: the per-star sequential depth that
        dominates the single-star wall-clock amortizes across the star
        axis, and the ~6x call savings becomes real device time."""
        from isochrones_tpu.batch import BatchStarFitter
        from isochrones_tpu.cluster import simulate_cluster

        iso = self.iso
        n_stars = 64 if self.on_accel else 4
        cat = simulate_cluster(
            n_stars, 9.55, 0.0, 400.0, 0.05, -2.2, 0.3, 0.0, iso=iso, rng=7,
            mass_range=(0.75, 1.1), distance_scatter=40.0,
        )
        fitter = BatchStarFitter(iso, cat, max_distance=3000)
        n_live, min_ess = (250, 500.0) if self.on_accel else (100, 200.0)
        t0 = time.perf_counter()
        res = fitter.fit_multinest(
            n_live_points=n_live, n_batch=32, seed=5, dynamic=True, min_ess=min_ess
        )
        dt = time.perf_counter() - t0
        assert np.isfinite(res["logz"]).all()
        assert (res["ess"] >= min_ess).all()
        rate = n_stars / dt
        return {
            "metric": f"catalog DYNAMIC nested fit ({n_stars} stars x n_live={n_live}, min_ess={min_ess:.0f}/star, one program)",
            "value": round(rate, 2),
            "unit": "stars/s (posterior + evidence per star)",
            "baseline": round(1.0 / BASE_FIT_SECONDS, 6),
            "vs_baseline": round(rate * BASE_FIT_SECONDS, 1),
            "seconds_total": round(dt, 1),
            "median_ess": round(float(np.median(res["ess"])), 1),
        }

    # ------------------------------------------ 10. end-to-end cluster fit
    def bench_cluster_fit(self):
        """Hierarchical cluster fit wall-clock (50 stars, 800-EEP ladder,
        ensemble MCMC).
        No reference counterpart timing exists (the reference shells out to
        MultiNest over MPI with no published figure)."""
        import jax.numpy as jnp

        from isochrones_tpu.cluster import SimulatedCluster, StarClusterModel

        iso = self.iso
        sim = SimulatedCluster(
            50, age=9.0, feh=0.0, distance=300.0, AV=0.05, alpha=-2.0,
            gamma=0.3, fB=0.3, bands=("J", "H", "K"), mass_range=(0.6, 2.0),
            ic=iso, rng=0, phot_unc=0.02, distance_scatter=0.0,
        )
        # ladder must cover the sim's evolved stars: at age 9.0 even a 1.4
        # Msun star sits at EEP ~857, so an (1, 800) ladder has zero support
        # for the massive tail (the whole cluster lnlike is then -inf).
        # eep_step=2 spans the full range at 700 ladder points.
        model = StarClusterModel(
            iso, sim, eep_bounds=(1, 1400), eep_step=2.0, max_distance=3000,
            minq=0.2, mass_bounds=(0.6, 2.0),
        )
        base = np.asarray([9.0, 0.0, 300.0, 0.05, -2.0, 0.3, 0.3])
        # support check BEFORE timing (a star outside the ladder makes the
        # entire cluster lnlike -inf and the fit silently returns prior draws)
        assert np.isfinite(float(model.lnpost(base))), "truth outside cluster model support"
        nwalkers, nburn, niter = (16, 300, 150) if self.on_accel else (16, 10, 5)
        p0 = base[None, :] + self.rng.normal(
            0, [0.02, 0.02, 2.0, 0.01, 0.1, 0.03, 0.03], size=(nwalkers, 7)
        )
        times = []
        for rep in range(2 if self.on_accel else 1):
            t0 = time.perf_counter()
            df = model.fit_mcmc(nwalkers=nwalkers, nburn=nburn, niter=niter,
                                p0=p0, seed=3 + rep, moves="mixed")
            times.append(time.perf_counter() - t0)
        dt = times[-1]  # warm run (see bench_mcmc_fit)
        assert np.isfinite(df["lnprob"]).all(), "non-finite walker lnprob in cluster fit"
        return {
            "metric": f"end-to-end 50-star cluster MCMC fit ({nwalkers}w x {nburn}+{niter}, warm)",
            "value": round(dt, 2),
            "unit": "seconds (lower is better)",
            "baseline": None,
            "vs_baseline": None,
            "times": [round(t, 1) for t in times],
        }


def main():
    import sys

    t_start = time.perf_counter()

    from isochrones_tpu.config import enable_compile_cache

    enable_compile_cache()
    try:
        b = Bench(t_start=t_start)
    except Exception:
        # fatal before any row (no device, grid-build crash): still leave
        # ONE parseable line + the cause on stderr
        tb = traceback.format_exc()
        print(tb, file=sys.stderr, flush=True)
        print(json.dumps({
            "metric": "binary-star fused lnpost throughput (setup failed)",
            "value": 0.0, "unit": "evals/s/chip", "vs_baseline": 0.0,
            "error": tb.splitlines()[-1], "suite_rows": 0,
        }), flush=True)
        raise SystemExit(1)
    # placeholder headline BEFORE the first row: even a timeout inside
    # bench 1 leaves one parseable stdout line (value 0 = nothing measured)
    print(json.dumps(b.headline()), flush=True)

    # est_s values are conservative per-row estimates. Rows are ordered so
    # that when the budget runs short, what gets skipped is the expensive
    # tail (mcmc/NUTS/cluster-fit), never the headline kernel rows.
    b.run("binary-star fused lnpost throughput", b.bench_binary_lnpost, est_s=160)
    b.run("3-d grid interpolation", b.bench_interp_3d, est_s=25)
    b.run("batched 2-d grid interpolation", b.bench_interp_2d, est_s=15)
    b.run("tree StarModel resolved-binary lnpost", b.bench_tree_lnpost, est_s=45)
    b.run("get_eep fast", lambda: b.bench_get_eep(accurate=False), est_s=20)
    b.run("get_eep accurate", lambda: b.bench_get_eep(accurate=True), est_s=20)
    b.run("generate 10^4 stars", b.bench_generate, est_s=20)
    b.run("generate device-resident", b.bench_generate_device, est_s=15)
    b.run("StarPopulation.generate(1000)", b.bench_population, est_s=20)
    b.run("cluster lnpost", b.bench_cluster, est_s=80)
    b.run("cluster lnpost full-EEP", b.bench_cluster_full_eep, est_s=150)
    b.run("end-to-end nested fit", b.bench_nested_fit, est_s=120)
    b.run("catalog dynamic nested fit", b.bench_catalog_nested_dynamic, est_s=160)
    b.run("end-to-end dynamic nested fit", b.bench_nested_dynamic_fit, est_s=120)
    b.run("catalog batch fit throughput", b.bench_catalog_fit, est_s=130)
    b.run("end-to-end cluster fit", b.bench_cluster_fit, est_s=340)
    b.run("end-to-end ensemble-MCMC fit", b.bench_mcmc_fit, est_s=310)
    b.run("end-to-end NUTS fit", b.bench_nuts_fit, est_s=500)

    b.write_local(final=True)
    # suite on its own line, then the compact headline LAST so a bounded
    # stdout tail always ends with one complete parseable JSON line
    full = dict(b.headline())
    full.pop("suite_rows", None)
    full["suite"] = b.results
    print(json.dumps(full))
    print(json.dumps(b.headline()))
    errored = [r["metric"] for r in b.results if "error" in r]
    if errored:
        print(f"bench: {len(errored)} row(s) errored: {errored}", file=sys.stderr)
        raise SystemExit(1)


if __name__ == "__main__":
    main()
