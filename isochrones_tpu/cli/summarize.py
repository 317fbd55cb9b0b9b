"""``starfit-summarize`` CLI (reference scripts/starfit-summarize).

The reference uses schwimmbad for MPI/multiprocessing pools; summaries are
host-side file crunching, so a multiprocessing.Pool covers the role.
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None):
    parser = argparse.ArgumentParser(description="Summarize quantiles over many starfit results.")
    parser.add_argument("--platform", default=None, help="force a JAX platform (e.g. cpu for a CPU-only run)")
    parser.add_argument("names", nargs="*", help="star folder names (or use --filename)")
    parser.add_argument("-f", "--filename", "--listfile", dest="listfile", default=None,
                        help="file with one folder name per line")
    parser.add_argument("--rootdir", default=".")
    parser.add_argument("--modelname", default="mist_starmodel_single")
    parser.add_argument("--output", "-O", "-o", "--outfile", default="summary.csv")
    parser.add_argument("--ncores", "-p", "--processes", dest="ncores", type=int, default=1)
    parser.add_argument("--mpi", action="store_true",
                        help="reference compat: schwimmbad MPI pools are replaced by local multiprocessing over all cores (DCN fleets: starfit --multihost)")
    parser.add_argument("--raise_exceptions", action="store_true")
    parser.add_argument("--columns", nargs="*", default=["eep", "mass", "radius", "age", "feh", "distance", "AV"])
    # reference "folders" mode: per-folder {models}_{mult}_results.txt
    parser.add_argument("--results-txt", action="store_true", dest="results_txt",
                        help="write per-folder results.txt files instead of one summary table")
    parser.add_argument("--binary", action="store_true")
    parser.add_argument("--triple", action="store_true")
    parser.add_argument("--all", action="store_true")
    parser.add_argument("--models", default="mist")
    args = parser.parse_args(argv)
    if args.platform:
        import jax

        jax.config.update("jax_platforms", args.platform)

    names = list(args.names)
    if args.listfile:
        with open(args.listfile) as f:
            names += [line.strip() for line in f if line.strip()]
    if not names:
        # reference default: current folder (scripts/starfit-summarize:31)
        names = ["."]

    if args.results_txt or args.binary or args.triple or args.all:
        # reference scripts/starfit-summarize:63-110 ("old thing") — write
        # med/lo/hi tables next to each fitted model
        import logging

        from ..summary import write_results_txt

        if args.all:
            multiplicities = ["single", "binary", "triple"]
        elif args.binary:
            multiplicities = ["binary"]
        elif args.triple:
            multiplicities = ["triple"]
        else:
            multiplicities = ["single"]
        for folder in names:
            for mult in multiplicities:
                try:
                    path = write_results_txt(
                        os.path.join(args.rootdir, folder), models=args.models, mult=mult
                    )
                    print(path)
                except KeyboardInterrupt:
                    raise
                except Exception:
                    if args.raise_exceptions:
                        raise
                    logging.error(
                        "failed to write starfit summary file (%s) for %s.",
                        mult, folder, exc_info=True,
                    )
        return 0

    from ..summary import get_summary_df

    ncores = args.ncores
    if args.mpi:
        ncores = max(os.cpu_count() or 1, ncores)
    pool = None
    if ncores > 1:
        from multiprocessing import Pool

        pool = Pool(ncores)

    df = get_summary_df(
        names=names, pool=pool, rootdir=args.rootdir, modelname=args.modelname,
        columns=tuple(args.columns), filename=args.output,
        raise_exceptions=args.raise_exceptions,
    )
    if pool is not None:
        pool.close()
    print(df.head())
    return 0


if __name__ == "__main__":
    sys.exit(main())
