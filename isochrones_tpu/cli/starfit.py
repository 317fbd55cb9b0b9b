"""``starfit`` CLI (reference scripts/starfit:34-106)."""

from __future__ import annotations

import argparse
import sys


def build_parser():
    parser = argparse.ArgumentParser(
        description="Fit physical properties of a star conditioned on observed quantities."
    )
    parser.add_argument("--platform", default=None, help="force a JAX platform (e.g. cpu for a CPU-only run)")
    parser.add_argument("folders", nargs="*", default=["."])
    parser.add_argument("--binary", action="store_true")
    parser.add_argument("--triple", action="store_true")
    parser.add_argument("--all", action="store_true")
    parser.add_argument("--models", default="mist")
    parser.add_argument("--emcee", action="store_true", help="use on-device ensemble MCMC instead of nested sampling")
    parser.add_argument("--fehprior", default="local")
    parser.add_argument("--plot_only", action="store_true")
    parser.add_argument("-o", "--overwrite", action="store_true")
    parser.add_argument("-v", "--verbose", action="store_true")
    parser.add_argument("--no_plots", action="store_true")
    parser.add_argument("--n_live_points", type=int, default=1000)
    parser.add_argument("--max_iter", type=int, default=None)
    parser.add_argument("--dynamic", action="store_true",
                        help="dynamic nested sampling: posterior-focused threads to reach --min_ess cheaply (docs/samplers.md)")
    parser.add_argument("--resume", action="store_true",
                        help="checkpoint the nested-sampling state each compiled chunk "
                             "(under the model's chains basename) and resume from an "
                             "existing checkpoint — the role MultiNest's chains/* resume "
                             "plays in the reference; the completed fit is bitwise-identical "
                             "to an uninterrupted one")
    parser.add_argument("--min_ess", type=float, default=None,
                        help="posterior effective-sample-size target for the nested fit")
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--bands", nargs="*", default=None, help="Additional band(s) to include in samples.")
    parser.add_argument("--gaia", action="store_true",
                        help="condition on the closest Gaia source's parallax/photometry at the ini RA/dec (native; the reference gates this on the external tgastars package)")
    parser.add_argument("--write_ini", action="store_true",
                        help="with --gaia, persist the queried values into star.ini")
    parser.add_argument("--rootdir", type=str, default=None,
                        help="resolve folders relative to this directory")
    parser.add_argument("--gaia_radius", type=float, default=5.0,
                        help="Gaia query radius in arcsec")
    parser.add_argument("--tree", action="store_true", help="use the tree-based StarModel (resolved systems)")
    # multi-host (DCN) fleet sharding: each process fits its shard of folders
    # (the reference scripts/batch_starfit SLURM-array role, SURVEY §2.8c)
    parser.add_argument("--multihost", action="store_true",
                        help="shard the folder list across jax.distributed processes")
    parser.add_argument("--coordinator", default=None,
                        help="jax.distributed coordinator address host:port (multihost)")
    parser.add_argument("--num-processes", type=int, default=None, dest="num_processes")
    parser.add_argument("--process-id", type=int, default=None, dest="process_id")
    return parser


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.platform:
        import jax

        jax.config.update("jax_platforms", args.platform)

    from ..starfit import starfit

    folders = list(args.folders)
    if args.multihost or args.coordinator is not None:
        from ..parallel.multihost import initialize_distributed, process_shard

        pid, nproc = initialize_distributed(
            coordinator_address=args.coordinator,
            num_processes=args.num_processes,
            process_id=args.process_id,
        )
        folders = process_shard(folders, pid, nproc)
        print(f"[multihost] process {pid}/{nproc}: {len(folders)} folder(s)")

    if args.all:
        multiplicities = ["single", "binary", "triple"]
    elif args.binary:
        multiplicities = ["binary"]
    elif args.triple:
        multiplicities = ["triple"]
    else:
        multiplicities = ["single"]

    starmodel_type = None
    if args.tree:
        from ..treemodel import StarModel

        starmodel_type = StarModel

    logger = None
    fit_kwargs = dict(n_live_points=args.n_live_points, seed=args.seed)
    if args.max_iter is not None:
        fit_kwargs["max_iter"] = args.max_iter
    if args.dynamic:
        fit_kwargs["dynamic"] = True
    if args.min_ess is not None:
        fit_kwargs["min_ess"] = args.min_ess
    if args.resume:
        if args.emcee:
            parser.error("--resume applies to the nested-sampling path (drop --emcee; "
                         "the MCMC path resumes via fit.McmcBackend instead)")
        fit_kwargs["resume"] = True

    failures = []
    for i, folder in enumerate(folders):
        print(f"{i + 1} of {len(folders)}: {folder}")
        mod, logger = starfit(
            folder,
            failures=failures,
            multiplicities=multiplicities,
            models=args.models,
            use_emcee=args.emcee,
            feh_prior=args.fehprior,
            plot_only=args.plot_only,
            overwrite=args.overwrite,
            verbose=args.verbose,
            no_plots=args.no_plots,
            logger=logger,
            bands=args.bands,
            starmodel_type=starmodel_type,
            gaia=args.gaia,
            write_ini_file=args.write_ini,
            rootdir=args.rootdir,
            gaia_radius=args.gaia_radius,
            **fit_kwargs,
        )
        del mod
    if failures:
        # per-folder failures are logged-and-continued (reference
        # starfit.py:155-159) but must not report shell-level success —
        # batch/preemption-recovery workflows key off the exit code
        print(f"{len(failures)} fit(s) failed: "
              + ", ".join(f"{f} [{m}]" for f, m in failures), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
