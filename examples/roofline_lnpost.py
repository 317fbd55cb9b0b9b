"""Decomposition profile of the fused binary lnpost hot path.

Run on the accelerator:

    python examples/roofline_lnpost.py                         # row-gather (default)
    ISOTPU_INTERP_BLOCK=1 python examples/roofline_lnpost.py   # block-gather probe
    ISOTPU_PAIR_GRIDS=1  python examples/roofline_lnpost.py    # paired-rows probe

Measures, at the bench-1 configuration (MIST-scale grids, batch 2^17,
binary model, 4 bands + Teff/logg spectroscopy + parallax):

1. full lnpost_batch (the bench-1 number)
2. star_lnlike alone (no priors)
3. lnprior_batch alone
4. model-grid 3-d interp alone at the same (B, 2, 3) fan-out, packed 4 cols
5. BC-grid 4-d interp alone at the same (B, 2, 4) fan-out, 4 bands
6. cell location alone (find_cells_1d for all axes; no gathers)

and prints the analytic gather-byte / transcendental counts per eval and
the achieved gather bandwidth. No device peak is assumed here: a roofline
share needs the peak table that comes with the benchmark.
"""

import json
import os
import time

import numpy as np

import jax
import jax.numpy as jnp

from isochrones_tpu import get_ichrone
from isochrones_tpu.config import enable_compile_cache
from isochrones_tpu.device import on_accelerator
from isochrones_tpu.ops.interp import find_cells_1d, interp_nd
from isochrones_tpu.starmodel import BinaryStarModel


def timeit(fn, n_rep=20):
    out = fn()
    jax.tree_util.tree_map(
        lambda x: x.block_until_ready() if hasattr(x, "block_until_ready") else x, out
    )
    t0 = time.perf_counter()
    for _ in range(n_rep):
        out = fn()
    jax.tree_util.tree_map(
        lambda x: x.block_until_ready() if hasattr(x, "block_until_ready") else x, out
    )
    return (time.perf_counter() - t0) / n_rep


def main():
    enable_compile_cache()
    accel = on_accelerator()
    dtype = np.float32 if accel else np.float64
    B = 1 << 17 if accel else 1 << 13
    rows = {"backend": jax.default_backend(),
            "device_kind": jax.devices()[0].device_kind,
            "interp_block": os.environ.get("ISOTPU_INTERP_BLOCK", "(default)"),
            "batch": B}

    iso = get_ichrone("synthetic", n_feh=15, n_mass=196, n_eep=1710, n_age=107, dtype=dtype)
    rng = np.random.default_rng(0)

    pars = [350.0, 9.0, 0.0, 200.0, 0.1]
    bands = ["J", "H", "K", "G"]
    Teff, logg, _, mags = iso.interp_mag(list(pars), list(bands))
    mags = np.asarray(mags)
    model = BinaryStarModel(
        iso, Teff=(float(Teff), 100.0), logg=(float(logg), 0.1),
        J=(float(mags[0]), 0.02), H=(float(mags[1]), 0.02),
        K=(float(mags[2]), 0.02), G=(float(mags[3]), 0.01),
        parallax=(5.0, 0.05),
    )
    p = np.stack([
        rng.uniform(200, 450, B), rng.uniform(200, 450, B),
        rng.uniform(8.5, 9.5, B), rng.uniform(-0.5, 0.3, B),
        rng.uniform(100, 300, B), rng.uniform(0.0, 0.5, B),
    ], axis=-1).astype(dtype)
    p = jnp.asarray(p)

    # 1. full lnpost
    dt = timeit(lambda: model.lnpost_batch(p))
    rows["lnpost_evals_per_s"] = round(B / dt, 1)
    rows["lnpost_us_per_eval"] = round(dt / B * 1e6, 4)

    # 2. lnlike alone / 3. lnprior alone
    dt = timeit(lambda: model.lnlike_batch(p))
    rows["lnlike_evals_per_s"] = round(B / dt, 1)
    dt = timeit(lambda: model.lnprior_batch(p))
    rows["lnprior_evals_per_s"] = round(B / dt, 1)

    # 4. model-grid interp alone at the same fan-out the fused lnlike does
    # (2 component points per eval), packed 4 columns: (B*2, 3) in-range pts
    g = model.ic.model_packed
    kn = [np.asarray(k) for k in g.knots]
    q3 = np.stack([rng.uniform(k[0], k[-1], 2 * B) for k in kn], axis=-1).astype(dtype)
    q3 = jnp.asarray(q3)
    f3 = jax.jit(lambda grid, q: interp_nd(grid.values, grid.knots, q, icols=(0, 1, 2, 3),
                                           axis_maps=grid.axis_maps, paired=g.paired))
    dt = timeit(lambda: f3(g, q3))
    rows["model_interp3d_x2_per_s"] = round(B / dt, 1)  # per-EVAL rate (2 pts/eval)

    # 5. BC-grid 4-d interp alone: (B*2, 4) points, 4 band cols (paired
    # variant when the interpolator built one — what the hot kernels use)
    bcg = model.ic.bc_paired if model.ic.bc_paired is not None else model.ic.bc
    knb = [np.asarray(k) for k in bcg.knots]
    q4 = np.stack([rng.uniform(k[0], k[-1], 2 * B) for k in knb], axis=-1).astype(dtype)
    q4 = jnp.asarray(q4)
    bic = tuple(bcg.column_index[b] for b in bands)
    f4 = jax.jit(lambda grid, q: interp_nd(grid.values, grid.knots, q, icols=bic,
                                           axis_maps=grid.axis_maps, paired=bcg.paired))
    dt = timeit(lambda: f4(bcg, q4))
    rows["bc_interp4d_x2_per_s"] = round(B / dt, 1)

    # 6. cell location only (no gathers): all 3 model axes + all 4 BC axes
    def cells_only(q3, q4):
        acc = jnp.zeros(q3.shape[0], dtype=q3.dtype)
        for d in range(3):
            c, t, _ = find_cells_1d(g.knots[d], q3[:, d], axis_map=g.axis_maps[d])
            acc = acc + c.astype(q3.dtype) + t
        for d in range(4):
            c, t, _ = find_cells_1d(bcg.knots[d], q4[:, d], axis_map=bcg.axis_maps[d])
            acc = acc + c.astype(q3.dtype) + t
        return acc

    fc = jax.jit(cells_only)
    dt = timeit(lambda: fc(q3, q4))
    rows["cells_only_x2_per_s"] = round(B / dt, 1)

    # ---- analytic per-eval resource counts (binary, 4 bands)
    # gathers: model 2 comps x 8 corners (row path) or 2 block-gathers;
    #          BC 2 comps x 16 corners or 2 block-gathers
    # bytes:   model 2 x 8 rows x 4 cols x 4 B; BC 2 x 16 x 4 x 4 B
    bytes_per_eval = 2 * 8 * 4 * 4 + 2 * 16 * 4 * 4
    rows["gather_bytes_per_eval"] = bytes_per_eval
    rate = rows["lnpost_evals_per_s"]
    gbps = rate * bytes_per_eval / 1e9
    rows["achieved_gather_GBps"] = round(gbps, 2)
    # transcendentals: ~2x4 exp (flux) + 4 log10 (mag sum) + 1 log10 (dist)
    # + ~7 log/exp in lnprob/priors ~ 20/eval
    rows["transcendentals_per_eval_approx"] = 20

    print(json.dumps(rows, indent=1))


if __name__ == "__main__":
    main()
