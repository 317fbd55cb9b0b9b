"""Smoke run of the inference path on a GPU, in one process.

    python chip_smoke.py              # one card: every phase below
    python chip_smoke.py --chips 4    # four cards: the sharded checks only

Phases (one card), each at the full width of the MIST-scale synthetic grid
(15 feh x 196 mass x 1710 EEP x 107 age) in float32 on the card:

1. device: a GPU must be JAX's default device; there is no CPU fallback.
2. grid + fused lnpost: ``BinaryStarModel.lnpost_batch`` at batch 2^17,
   and ``interp_mag``, compared with the same model in float64 on the host
   CPU (in this process, ``jax.devices("cpu")``).
3. a binary-star nested fit through ``fit()`` (n_live=1000, two runs, the
   dispatcher's GPU sampler defaults) and a short ``fit_mcmc``.
4. the cluster marginal: ``StarClusterModel.lnpost_batch`` at 50 stars x
   1710 EEPs x 16 walkers through the dispatcher's GPU choice (the Pallas
   kernel), compared per star with the float64 XLA grid path on the host
   CPU and with the float32 XLA grid path on the card; then both paths
   timed at 50 x 800 and 50 x 1710 and compared walker by walker.
5. the ``gpu``-marked tests (tests/test_gpu_device.py,
   tests/test_full_scale.py), run by ``pytest.main`` in this process.

``--chips 4`` runs only: the catalog fitter's star axis sharded over four
cards (256 stars), the cluster likelihood's star-axis psum, and nested
sampling with four runs sharded over the cards, each against its own
one-card run (to 1e-9 relative: see SHARD_RTOL).

A failed check raises, and the script exits non-zero. Timings are printed
as information, beside the card's name and power limit; they are not
claims. The last line of standard output is the JSON result line.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Sizes:
    """Problem sizes of one smoke run. ``FULL`` is what the script runs;
    smaller instances exist only so the phases can be rehearsed on a CPU
    by calling :func:`run_one_card` / :func:`run_four_cards` directly."""

    grid: tuple = (15, 196, 1710, 107)  # n_feh, n_mass, n_eep, n_age
    lnpost_batch: int = 1 << 17
    n_compare: int = 4096
    n_live: int = 1000
    n_runs: int = 2
    mcmc: tuple = (64, 200, 50)  # nwalkers, nburn, niter
    n_stars: int = 50
    ladders: tuple = (800, 1710)  # cluster EEP ladders timed; last is checked
    n_walkers: int = 16
    n_reps: int = 10
    catalog_stars: int = 256
    mesh_live: int = 100


FULL = Sizes()

#: binary-star observation set of the fused-lnpost phase (bench.py's
#: headline row): primary at EEP 350, secondary at EEP 300
TRUTH = {"eep_0": 350.0, "eep_1": 300.0, "age": 9.0, "feh": 0.0,
         "distance": 200.0, "AV": 0.1}
BANDS = ("J", "H", "K", "G")

# ---- tolerances, and why
#: interp_mag, float32 on the card vs float64 on the CPU. Full float32
#: carries ~7 digits (~1e-6 mag at magnitude 10); TF32 in the corner-weight
#: contraction keeps ~3 (~5 mmag). 1 mmag tells the two apart and is a
#: tenth of the best photometric errors the fits use.
MAG_TOL = 1e-3
#: lnpost, same comparison, on points around the truth (where |lnpost| is
#: tens of nats and samplers spend their time) and across the prior box. A
#: chi^2 term amplifies the float32 rounding of the model by ~2 |resid| /
#: sigma^2, so the error grows with |lnpost|: 1e-3 absolute plus 1e-4
#: relative covers that with margin, and is far below the ~1-nat
#: differences a sampler acts on where it matters.
LNPOST_ATOL, LNPOST_RTOL = 1e-3, 1e-4
#: points within float32 rounding of a grid edge may be valid in one
#: precision and not the other; at most this share may differ in finiteness
EDGE_SHARE = 5e-3
#: per-star cluster ln-marginals, float32 vs float64: each is a sum over
#: ~1.5 million (j, k) cells of float32 terms, ~1e-3 nats absolute is the
#: expected order, growing with the magnitude of the marginal
LNMARG_ATOL, LNMARG_RTOL = 2e-3, 2e-5
#: sharded fits vs one-card fits, float64. On the CPU they are bitwise
#: equal. On H100s the NS engine is deterministic at a fixed batch width,
#: and its 4-way sharded run equals a one-card run at the per-device width
#: (64 of 256 problems) bitwise; but the batched live-point Cholesky
#: rounds differently at width 64 than at 256, so the sharded fit and the
#: one-card fit at full width differ by ~2e-13 relative in logz and ~1e-12
#: in samples. 1e-9 relative still fails any real divergence: one flipped
#: sampler decision moves logz by ~logzerr (~0.1) and replaces the samples.
SHARD_RTOL = 1e-9
#: nested-fit posterior medians must lie within this many posterior
#: standard deviations of the truth the observations were made from
FIT_SIGMA = 4.0


def log(msg):
    print(msg, flush=True)


def card_line():
    """``name, power.limit`` of the first card, as nvidia-smi reports it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def timed(fn, n_reps):
    """(median seconds over ``n_reps`` calls after one warm-up, output)."""
    import jax

    out = jax.block_until_ready(fn())
    times = []
    for _ in range(n_reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return float(np.median(times)), out


def f64_cpu():
    """Context for the float64 host reference: x64 on, CPU device."""
    import contextlib

    import jax

    stack = contextlib.ExitStack()
    stack.enter_context(jax.enable_x64(True))
    stack.enter_context(jax.default_device(jax.devices("cpu")[0]))
    return stack


def build_iso(sizes, dtype):
    from isochrones_tpu import get_ichrone

    n_feh, n_mass, n_eep, n_age = sizes.grid
    return get_ichrone("synthetic", n_feh=n_feh, n_mass=n_mass, n_eep=n_eep,
                       n_age=n_age, dtype=dtype)


def binary_model(iso, obs):
    from isochrones_tpu.starmodel import BinaryStarModel

    return BinaryStarModel(iso, **obs)


def binary_observations(iso64):
    """Observed values of the unresolved binary in TRUTH, from the float64
    grid (the same floats feed the float32 and float64 models)."""
    pri = [TRUTH["eep_0"], TRUTH["age"], TRUTH["feh"], TRUTH["distance"], TRUTH["AV"]]
    Teff, logg, _, m1 = iso64.interp_mag(pri, list(BANDS))
    _, _, _, m2 = iso64.interp_mag([TRUTH["eep_1"]] + pri[1:], list(BANDS))
    tot = -2.5 * np.log10(10 ** (-0.4 * np.asarray(m1)) + 10 ** (-0.4 * np.asarray(m2)))
    uncs = (0.02, 0.02, 0.02, 0.01)
    obs = {b: (float(v), u) for b, v, u in zip(BANDS, tot, uncs)}
    obs.update(Teff=(float(Teff), 100.0), logg=(float(logg), 0.1),
               parallax=(1000.0 / TRUTH["distance"], 0.05))
    return obs


def random_binary_points(n, n_near, rng):
    """``n_near`` points scattered around the truth, then uniform draws
    over a box of the prior."""
    truth = np.asarray(list(TRUTH.values()))
    near = truth + rng.normal(0, [5.0, 5.0, 0.02, 0.02, 2.0, 0.01], size=(n_near, 6))
    m = n - n_near
    box = np.stack([
        rng.uniform(200, 450, m), rng.uniform(200, 450, m),
        rng.uniform(8.5, 9.5, m), rng.uniform(-0.5, 0.3, m),
        rng.uniform(100, 300, m), rng.uniform(0.0, 0.5, m),
    ], axis=-1)
    return np.concatenate([near, box])


# ------------------------------------------------------------------ phases
def phase_device(want):
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke: JAX's default device is {devs[0].platform!r}, not a GPU; "
            "this script measures the card and has no CPU fallback"
        )
    if len(devs) < want:
        raise SystemExit(f"chip_smoke: {want} GPUs needed, JAX sees {len(devs)}")
    log(f"[device] {devs[0].device_kind} x{len(devs)}  jax {jax.__version__}  "
        f"card: {card_line()}")
    return devs


def phase_grid_lnpost(sizes, card, rng):
    """Fused lnpost + interp_mag on the card vs float64 on the CPU."""
    import jax
    import jax.numpy as jnp

    import isochrones_tpu.ops.interp as interp_mod

    t0 = time.perf_counter()
    iso = build_iso(sizes, np.float32)
    jax.block_until_ready(iso.model_packed)
    stats = jax.devices()[0].memory_stats() or {}
    log(f"[grid] float32 MIST-scale grid built in {time.perf_counter() - t0:.2f} s; "
        f"device bytes in use {stats.get('bytes_in_use', 'n/a')}  ({card})")
    with f64_cpu():
        iso64 = build_iso(sizes, np.float64)
        obs = binary_observations(iso64)
        model64 = binary_model(iso64, obs)
    model = binary_model(iso, obs)

    n = sizes.n_compare
    p = random_binary_points(sizes.lnpost_batch, n // 2, rng)
    p32 = jnp.asarray(p, dtype=jnp.float32)
    dt, lnp = timed(lambda: model.lnpost_batch(p32), sizes.n_reps)
    lnp = np.asarray(lnp)
    again = np.asarray(model.lnpost_batch(p32))
    assert np.array_equal(lnp, again, equal_nan=True), "fused lnpost not deterministic"
    log(f"[lnpost] batch {sizes.lnpost_batch}: {dt * 1e3:.3f} ms/call, "
        f"{sizes.lnpost_batch / dt:.4g} evals/s  ({card})")

    # the float32 points, widened: both precisions see the same inputs
    with f64_cpu():
        ref = np.asarray(model64.lnpost_batch(jnp.asarray(np.asarray(p32[:n]), dtype=jnp.float64)))
    got = lnp[:n]
    fin = np.isfinite(ref) & np.isfinite(got)
    differ = np.mean(np.isfinite(ref) != np.isfinite(got))
    assert fin.sum() > n // 4, f"only {fin.sum()} finite lnpost points of {n}"
    assert differ <= EDGE_SHARE, f"{differ:.4f} of points differ in finiteness"
    err = np.abs(got[fin] - ref[fin])
    bad = err > LNPOST_ATOL + LNPOST_RTOL * np.abs(ref[fin])
    log(f"[lnpost] vs float64 CPU: {fin.sum()} finite, max |diff| {err.max():.3e}, "
        f"finiteness differs on {differ:.4f}")
    assert not bad.any(), f"lnpost off by up to {err.max():.3e} on {bad.sum()} points"

    # interp_mag over the same (eep, age, feh, distance, AV) box
    q = np.stack([rng.uniform(200, 450, n), rng.uniform(8.5, 9.5, n),
                  rng.uniform(-0.5, 0.3, n), rng.uniform(100, 300, n),
                  rng.uniform(0.0, 0.5, n)], axis=-1)
    q32 = jnp.asarray(q, dtype=jnp.float32)
    with f64_cpu():
        m64 = np.asarray(iso64.interp_mag_batch(jnp.asarray(np.asarray(q32), dtype=jnp.float64), list(BANDS))[3])

    def mag_err():
        m32 = np.asarray(iso.interp_mag_batch(q32, list(BANDS))[3])
        ok = np.isfinite(m32) & np.isfinite(m64)
        assert ok.sum() > n, f"only {ok.sum()} finite magnitudes"
        return float(np.max(np.abs(m32[ok] - m64[ok])))

    pinned = mag_err()
    # the same contraction at the backend's default precision, for the
    # record only (the code pins HIGHEST; this shows what the pin buys)
    interp_mod.LERP_PRECISION = jax.lax.Precision.DEFAULT
    jax.clear_caches()
    try:
        unpinned = mag_err()
    finally:
        interp_mod.LERP_PRECISION = jax.lax.Precision.HIGHEST
        jax.clear_caches()
    log(f"[interp_mag] vs float64 CPU: max |dmag| {pinned:.3e} mag pinned HIGHEST, "
        f"{unpinned:.3e} mag at DEFAULT precision (tolerance {MAG_TOL})")
    assert pinned <= MAG_TOL, f"interp_mag off by {pinned:.3e} mag"
    return iso, iso64, obs


def phase_fit(sizes, iso, obs, card):
    """Binary-star nested fit through fit(), then a short fit_mcmc."""
    model = binary_model(iso, obs)
    t0 = time.perf_counter()
    res = model.fit(n_live_points=sizes.n_live, n_runs=sizes.n_runs, seed=0)
    dt = time.perf_counter() - t0
    min_ess = 100.0  # run_nested's default target
    log(f"[fit] nested n_live={sizes.n_live} x {sizes.n_runs} runs: {dt:.2f} s incl. "
        f"compile, logz {res.logz:.3f} +- {res.logzerr:.3f}, ess {res.ess:.0f}  ({card})")
    assert np.isfinite(res.logz), "nested fit logz is not finite"
    assert res.ess >= min_ess, f"nested fit ess {res.ess:.0f} < {min_ess}"
    df = model.samples
    for name, truth in TRUTH.items():
        med, sd = float(df[name].median()), float(df[name].std())
        off = abs(med - truth) / max(sd, 1e-12)
        log(f"[fit]   {name}: median {med:.4f} sd {sd:.4f} truth {truth} ({off:.2f} sd)")
        assert off <= FIT_SIGMA, f"{name} median {med} is {off:.1f} sd from {truth}"

    nwalkers, nburn, niter = sizes.mcmc
    t0 = time.perf_counter()
    chain = model.fit_mcmc(nwalkers=nwalkers, nburn=nburn, niter=niter, seed=1)
    log(f"[fit] mcmc {nwalkers}w x {nburn}+{niter}: {time.perf_counter() - t0:.2f} s incl. "
        f"compile  ({card})")
    assert np.isfinite(chain["lnprob"]).mean() > 0.9, "mcmc chain mostly non-finite"


def cluster_setup(sizes, iso, rng):
    """bench.py's cluster rows: 50 stars, J/H/K, walkers near the truth."""
    from isochrones_tpu.cluster import SimulatedCluster

    sim = SimulatedCluster(
        sizes.n_stars, age=9.0, feh=0.0, distance=300.0, AV=0.05, alpha=-2.0,
        gamma=0.3, fB=0.3, bands=("J", "H", "K"), mass_range=(0.6, 2.0),
        ic=iso, rng=0, phot_unc=0.02,
    )
    base = np.asarray([9.0, 0.0, 300.0, 0.05, -2.0, 0.3, 0.3])
    p = base[None, :] + rng.normal(0, [0.02, 0.02, 2.0, 0.01, 0.05, 0.02, 0.02],
                                   size=(sizes.n_walkers, 7))
    return sim, p


def cluster_model(iso, sim, max_eep, **kw):
    from isochrones_tpu.cluster import StarClusterModel

    return StarClusterModel(iso, sim, eep_bounds=(1, max_eep), max_distance=3000,
                            minq=0.2, **kw)


def lnmarg_tol(ref):
    """Per-star ln-marginal limit (nats) around the reference ``ref``."""
    return LNMARG_ATOL + LNMARG_RTOL * np.abs(ref)


def assert_lnmarg_close(got, ref, what):
    fin = np.isfinite(ref)
    assert np.array_equal(np.isfinite(got), fin), f"{what}: finiteness differs"
    err = np.abs(got[fin] - ref[fin])
    worst = float(err.max()) if err.size else 0.0
    log(f"[cluster] {what}: max |diff| {worst:.3e} nats over {fin.sum()} stars")
    assert np.all(err <= lnmarg_tol(ref[fin])), (
        f"{what}: per-star ln-marginals off by up to {worst:.3e}")


def assert_lnlike_close(got, want, tol, what):
    """Whole-cluster ln-likelihoods (one per walker) within ``tol`` nats."""
    got, want = np.atleast_1d(got), np.atleast_1d(want)
    err = np.abs(got - want)
    log(f"[cluster] {what}: max |diff| {err.max():.3e} nats "
        f"(limit {np.min(tol):.3e}) over {got.size} walkers")
    assert np.all(err <= tol), f"{what}: off by up to {err.max():.3e} nats"


def phase_cluster(sizes, iso, iso64, card, rng):
    import jax
    import jax.numpy as jnp

    from isochrones_tpu.ops.cluster import kernel_path

    assert kernel_path(jnp.float32), "dispatcher did not pick the GPU kernel"
    sim, p = cluster_setup(sizes, iso, rng)
    p32 = jnp.asarray(p, dtype=jnp.float32)
    full = sizes.ladders[-1]

    model = cluster_model(iso, sim, full)
    lnp = np.asarray(model.lnpost_batch(p32))
    assert np.isfinite(lnp).all(), "non-finite cluster lnpost at the truth cloud"
    compiled = model.lnpost_batch.lower(p32).compile()
    log(f"[cluster] memory_analysis: {compiled.memory_analysis()}")
    stats = jax.devices()[0].memory_stats() or {}
    peak, limit = stats.get("peak_bytes_in_use"), stats.get("bytes_limit")
    log(f"[cluster] peak bytes in use {peak} of limit {limit}")
    if peak is not None and limit:
        assert peak < 0.75 * limit, "peak device memory leaves under 25% headroom"

    xla = cluster_model(iso, sim, full, use_pallas=False)
    with f64_cpu():
        ref_model = cluster_model(iso64, sim, full)
    lnlike = lnp - np.asarray(model.lnprior_batch(p32))
    for w in range(2):
        got = ref_kernel = model.star_lnmarginals(p[w]).values
        with f64_cpu():
            ref = ref_model.star_lnmarginals(p[w]).values
        assert_lnmarg_close(got, ref, f"walker {w} kernel f32 vs XLA f64 CPU")
        assert_lnmarg_close(xla.star_lnmarginals(p[w]).values, ref_kernel,
                            f"walker {w} XLA f32 card vs kernel f32 card")
        # the batched path (16 walkers through the kernel's vmap and lax.map
        # chunks) sums the same per-star marginals
        assert_lnlike_close(lnlike[w], ref.sum(), lnmarg_tol(ref).sum(),
                            f"walker {w} batched lnpost - lnprior vs sum of f64 CPU marginals")

    # end-to-end timing of both paths at both ladders (16 walkers); their
    # outputs are compared walker by walker
    for max_eep in sizes.ladders:
        out = {}
        for use_pallas, name in ((None, "kernel"), (False, "xla")):
            m = cluster_model(iso, sim, max_eep, use_pallas=use_pallas)
            dt, out[name] = timed(lambda: m.lnpost_batch(p32), sizes.n_reps)
            log(f"[cluster] lnpost_batch {sizes.n_stars} stars x {max_eep} EEPs x "
                f"{sizes.n_walkers} walkers, {name}: {dt * 1e3:.3f} ms/call  ({card})")
        got, want = np.asarray(out["kernel"]), np.asarray(out["xla"])
        assert np.isfinite(want).all(), f"{max_eep} EEPs: non-finite XLA cluster lnpost"
        # per walker, the per-star limit summed over the stars
        tol = sizes.n_stars * LNMARG_ATOL + LNMARG_RTOL * np.abs(want)
        assert_lnlike_close(got, want, tol, f"{max_eep} EEPs, {sizes.n_walkers} walkers: "
                            "kernel lnpost_batch vs XLA lnpost_batch on the card")


def phase_gpu_tests(card):
    """The ``gpu``-marked tests, run by pytest in this process: a second
    process could not open the card. They compile the cluster kernel with
    and without the q Jacobian against the XLA path, compare the
    device-resident ``generate_device`` with the host ``generate``, check
    the fused lnpost for determinism, and hold the 50 x 1710 x 16-walker
    cluster under the card's memory limit. Every one must pass; a skip
    fails the phase."""
    import os

    import pytest

    class Tally:
        passed = skipped = 0

        def pytest_runtest_logreport(self, report):
            if report.when == "call" and report.passed:
                self.passed += 1
            elif report.skipped:
                self.skipped += 1

    # the platforms this process runs (tests/conftest.py keeps a set value)
    os.environ["JAX_PLATFORMS"] = "cuda,cpu"
    root = os.path.dirname(os.path.abspath(__file__))
    files = [os.path.join(root, "tests", f) for f in ("test_gpu_device.py", "test_full_scale.py")]
    tally = Tally()
    t0 = time.perf_counter()
    rc = pytest.main(["-q", "-s", "-m", "gpu", "-p", "no:cacheprovider", *files],
                     plugins=[tally])
    log(f"[gpu tests] exit {int(rc)}: {tally.passed} passed, {tally.skipped} skipped "
        f"in {time.perf_counter() - t0:.1f} s  ({card})")
    assert int(rc) == 0 and tally.passed > 0 and tally.skipped == 0, "gpu tests failed"


def run_one_card(sizes=FULL):
    rng = np.random.default_rng(0)
    card = card_line()
    t0 = time.perf_counter()
    iso, iso64, obs = phase_grid_lnpost(sizes, card, rng)
    log(f"[phase] grid+lnpost done at {time.perf_counter() - t0:.1f} s")
    phase_fit(sizes, iso, obs, card)
    log(f"[phase] fit done at {time.perf_counter() - t0:.1f} s")
    phase_cluster(sizes, iso, iso64, card, rng)
    log(f"[phase] cluster done at {time.perf_counter() - t0:.1f} s")


# --------------------------------------------------------------- four cards
def assert_same_fit(got, want, what):
    """Sharded vs one-card sampler output: equal to SHARD_RTOL; how many
    elements are bitwise equal is printed."""
    got, want = np.asarray(got), np.asarray(want)
    same = int(np.sum(got == want))
    rel = float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-300)))
    log(f"[mesh] {what}: {same}/{got.size} bitwise equal, max rel diff {rel:.3e}")
    np.testing.assert_allclose(got, want, rtol=SHARD_RTOL, atol=0)


def run_four_cards(sizes=FULL, n_dev=4):
    """The sharded paths, each against its own one-card run. The sampler
    checks run in float64: in float32 a different fusion at another batch
    width flips near-tie sampler decisions (a chaotic divergence, not a
    sharding fault), which a tight comparison cannot tell from a fault."""
    import jax
    import jax.numpy as jnp

    from isochrones_tpu.batch import BatchStarFitter
    from isochrones_tpu.cluster import simulate_cluster
    from isochrones_tpu.parallel import default_mesh

    rng = np.random.default_rng(0)
    card = card_line()

    # cluster likelihood: star axis sharded, partial sums psum'd (float32,
    # the Pallas kernel inside shard_map)
    iso = build_iso(sizes, np.float32)
    sim, p = cluster_setup(sizes, iso, rng)
    p32 = jnp.asarray(p, dtype=jnp.float32)
    mesh = default_mesh(n_dev, axis_names=("stars",))
    full = sizes.ladders[-1]
    plain = np.asarray(cluster_model(iso, sim, full).lnpost_batch(p32))
    shard = np.asarray(cluster_model(iso, sim, full, mesh=mesh).lnpost_batch(p32))
    err = np.max(np.abs(shard - plain))
    log(f"[mesh] cluster lnpost, {n_dev}-way star psum vs one card: max |diff| {err:.3e}")
    assert np.isfinite(plain).all()
    np.testing.assert_allclose(shard, plain, rtol=1e-5, atol=LNMARG_ATOL)

    with jax.enable_x64(True):
        iso64 = build_iso(sizes, np.float64)
        # catalog fitter: 256 stars, star axis sharded over the cards
        cat = simulate_cluster(
            sizes.catalog_stars, 9.55, 0.0, 400.0, 0.05, -2.2, 0.3, 0.0, iso=iso64,
            rng=7, mass_range=(0.75, 1.1), distance_scatter=40.0,
        )
        kw = dict(n_live_points=sizes.mesh_live, seed=3, min_ess=0, dlogz=1.0)
        t0 = time.perf_counter()
        f_plain = BatchStarFitter(iso64, cat, max_distance=3000)
        out_plain = f_plain.fit_multinest(**kw)
        t1 = time.perf_counter()
        f_shard = BatchStarFitter(iso64, cat, max_distance=3000)
        out_shard = f_shard.fit_multinest(mesh=default_mesh(n_dev, axis_names=("stars",)), **kw)
        t2 = time.perf_counter()
        log(f"[mesh] catalog NS {sizes.catalog_stars} stars: one card {t1 - t0:.2f} s, "
            f"{n_dev} cards {t2 - t1:.2f} s (incl. compile)  ({card})")
        assert np.isfinite(out_plain["logz"]).all()
        assert_same_fit(out_shard["logz"], out_plain["logz"], "catalog NS logz")
        assert_same_fit(f_shard.samples, f_plain.samples, "catalog NS samples")

        # nested sampling, four independent runs sharded over the cards
        obs = binary_observations(iso64)
        model = binary_model(iso64, obs)
        ns_kw = dict(n_live_points=sizes.mesh_live, seed=5, n_runs=n_dev, min_ess=0,
                     dlogz=1.0, n_batch=8, n_chains=8)
        r_plain = model.fit_multinest(**ns_kw)
        r_shard = model.fit_multinest(mesh=default_mesh(n_dev, axis_names=("runs",)), **ns_kw)
        log(f"[mesh] NS {n_dev} runs: logz {r_shard.logz:.4f} sharded, {r_plain.logz:.4f} one card")
        assert_same_fit(r_shard.logz, r_plain.logz, "NS logz")
        assert_same_fit(r_shard.samples, r_plain.samples, "NS samples")
        assert_same_fit(r_shard.logl, r_plain.logl, "NS logl")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1,
                    help="1: every one-card phase (default); 4: only the sharded checks")
    args = ap.parse_args(argv)

    import jax

    if args.chips == 1:
        # one card: JAX never opens the others
        jax.config.update("jax_cuda_visible_devices", "0")
    from isochrones_tpu.config import enable_compile_cache

    enable_compile_cache()
    devs = phase_device(args.chips)
    if args.chips == 1:
        run_one_card()
        phase_gpu_tests(card_line())
    else:
        run_four_cards()
    log(f"[card] {card_line()}")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind, "count": len(devs)}}))


if __name__ == "__main__":
    main()
