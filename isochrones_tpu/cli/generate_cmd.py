"""``generate-cmd`` CLI: synthesize an N-star CMD table with randomized
cluster parameters (reference scripts/generate_cmd.py)."""

from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser(description="Generate a synthetic cluster CMD table.")
    parser.add_argument("--platform", default=None, help="force a JAX platform (e.g. cpu for a CPU-only run)")
    parser.add_argument("N", type=int, nargs="?", default=None, help="number of stars")
    parser.add_argument("-N", dest="N_flag", type=int, default=None,
                        help="number of stars (reference-compat flag form)")
    parser.add_argument("--output", "-O", "-o", default="cmd.csv")
    parser.add_argument("--models", default="mist")
    parser.add_argument("--bands", default="JHK")
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--age", type=float, default=None, help="log10(age); random if omitted")
    parser.add_argument("--feh", type=float, default=None)
    parser.add_argument("--distance", type=float, default=None)
    parser.add_argument("--AV", type=float, default=None)
    args = parser.parse_args(argv)
    if args.N is None:
        args.N = args.N_flag
    if args.N is None:
        parser.error("number of stars required (positional or -N)")
    if args.platform:
        import jax

        jax.config.update("jax_platforms", args.platform)

    rng = np.random.default_rng(args.seed)
    age = args.age if args.age is not None else rng.uniform(8.0, 9.8)
    feh = args.feh if args.feh is not None else rng.uniform(-0.5, 0.3)
    distance = args.distance if args.distance is not None else rng.uniform(200, 2000)
    AV = args.AV if args.AV is not None else rng.uniform(0, 0.3)
    alpha = rng.uniform(-2.5, -1.8)
    gamma = rng.normal(0.3, 0.05)
    fB = rng.uniform(0.2, 0.5)

    from ..cluster import simulate_cluster
    from ..isochrone import get_ichrone

    iso = get_ichrone(args.models, bands=list(args.bands))
    cat = simulate_cluster(
        args.N, age, feh, distance, AV, alpha, gamma, fB,
        bands=list(args.bands), iso=iso, rng=rng,
    )
    cat.df.to_csv(args.output)
    print(f"{args.N}-star CMD written to {args.output}")
    print(f"truth: age={age:.3f} feh={feh:.3f} distance={distance:.0f} AV={AV:.3f} "
          f"alpha={alpha:.2f} gamma={gamma:.2f} fB={fB:.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
