"""``clusterfit`` CLI (reference scripts/clusterfit.py). The reference
bcast's the model over mpi4py for MultiNest's rank-parallel likelihood; the
on-device sampler needs no message passing."""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    parser = argparse.ArgumentParser(description="Fit cluster properties to a table of member stars.")
    parser.add_argument("--platform", default=None, help="force a JAX platform (e.g. cpu for a CPU-only run)")
    parser.add_argument("starfile", help="HDF/CSV table of member-star photometry")
    parser.add_argument("--bands", nargs="*", default=None)
    parser.add_argument("--props", nargs="*", default=None)
    parser.add_argument("--models", default="mist")
    parser.add_argument("--max_distance", type=float, default=10000)
    parser.add_argument("--mineep", type=int, default=200)
    parser.add_argument("--maxeep", type=int, default=800)
    parser.add_argument("--maxAV", type=float, default=0.1)
    parser.add_argument("--minq", type=float, default=0.2)
    parser.add_argument("-o", "--overwrite", action="store_true")
    parser.add_argument("--nlive", type=int, default=1000)
    parser.add_argument("--name", default="")
    parser.add_argument("--halo_fraction", type=float, default=0.5)
    parser.add_argument("--max_iter", type=int, default=None)
    parser.add_argument("--dynamic", action="store_true", default=None,
                        help="dynamic NS (the default for cluster fits: the marginal is "
                             "expensive per call, so the thread call-saving is real "
                             "wall-clock); --static forces classic static NS")
    parser.add_argument("--static", action="store_false", dest="dynamic",
                        help="force static nested sampling")
    parser.add_argument("--min_ess", type=float, default=None)
    parser.add_argument("--eep-step", type=float, default=1.0,
                        help="EEP-ladder spacing for the marginalization; <1 resolves "
                             "sub-EEP likelihood peaks at few-mmag precision (docs/cluster.md)")
    parser.add_argument("--q-jacobian", action="store_true",
                        help="use the corrected mass-ratio measure (|dq/dEEP2| change of "
                             "variables) instead of exact reference parity")
    args = parser.parse_args(argv)
    if args.platform:
        import jax

        jax.config.update("jax_platforms", args.platform)

    from ..cluster import clusterfit

    clusterfit(
        args.starfile, bands=args.bands, props=args.props, models=args.models,
        max_distance=args.max_distance, mineep=args.mineep, maxeep=args.maxeep,
        maxAV=args.maxAV, minq=args.minq, overwrite=args.overwrite,
        nlive=args.nlive, name=args.name, halo_fraction=args.halo_fraction,
        max_iter=args.max_iter, eep_step=args.eep_step, q_jacobian=args.q_jacobian,
        dynamic=args.dynamic, min_ess=args.min_ess,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
