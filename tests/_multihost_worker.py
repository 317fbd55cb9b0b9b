"""Subprocess worker for the two-process DCN fleet test (test_multihost.py).

Each process: initialize jax.distributed, take its shard of a shared work
list, run a real (tiny) fit per item on its local devices, write results.
Usage: python _multihost_worker.py <port> <process_id> <num_processes> <outdir>
"""

import json
import os
import sys


def main():
    port, pid, nproc, outdir = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    # Configure through jax.config (same pattern as tests/conftest.py), which
    # works even if jax was imported before the script body runs.
    # Multi-process CPU needs the gloo cross-process collectives backend.
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 2)
    jax.config.update("jax_enable_x64", True)
    jax.config.update("jax_cpu_collectives_implementation", "gloo")

    from isochrones_tpu.parallel.multihost import fleet_map, initialize_distributed, process_shard

    got_pid, got_nproc = initialize_distributed(
        coordinator_address=f"localhost:{port}", num_processes=nproc, process_id=pid
    )
    assert (got_pid, got_nproc) == (pid, nproc), (got_pid, got_nproc)

    import numpy as np

    from isochrones_tpu import get_ichrone
    from isochrones_tpu.starmodel import SingleStarModel

    iso = get_ichrone("synthetic", n_feh=5, n_mass=16, n_eep=50, n_age=16)
    work = [30.0, 32.0, 34.0, 36.0, 38.0]  # five "stars" (true EEPs)

    def fit_one(eep_true):
        Teff, logg, _, mags = iso.interp_mag([eep_true, 9.0, 0.0, 200.0, 0.1], ["J", "H"])
        m = SingleStarModel(
            iso, Teff=(Teff, 100.0), J=(float(mags[0]), 0.02), H=(float(mags[1]), 0.02),
            parallax=(5.0, 0.05),
        )
        df = m.fit_mcmc(nwalkers=64, nburn=500, niter=50, seed=int(eep_true), moves="mixed")
        return {"eep_true": eep_true, "eep_med": float(df["eep"].median())}

    results = fleet_map(fit_one, work)  # shards + barrier internally
    shard = process_shard(work, pid, nproc)
    assert [r["eep_true"] for r in results] == shard

    with open(os.path.join(outdir, f"proc{pid}.json"), "w") as f:
        json.dump({"pid": pid, "nproc": got_nproc, "results": results}, f)


if __name__ == "__main__":
    main()
