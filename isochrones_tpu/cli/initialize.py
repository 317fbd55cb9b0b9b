"""``mist-initialize`` CLI: pre-download/pre-bake grids
(reference scripts/mist-initialize.py:1-9)."""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    parser = argparse.ArgumentParser(description="Pre-bake model grid caches.")
    parser.add_argument("--platform", default=None, help="force a JAX platform (e.g. cpu for a CPU-only run)")
    parser.add_argument("--models", default="mist")
    parser.add_argument("--bands", nargs="*", default=None)
    args = parser.parse_args(argv)
    if args.platform:
        import jax

        jax.config.update("jax_platforms", args.platform)

    from ..isochrone import get_ichrone

    iso = get_ichrone(args.models, bands=args.bands)
    iso.initialize()
    track = get_ichrone(args.models, bands=args.bands, tracks=True)
    track.initialize()
    print("Grids initialized.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
