"""``starmodel-select`` CLI: compare multiplicity models by nested-sampling
log-evidence (reference scripts/starmodel-select)."""

from __future__ import annotations

import argparse
import glob
import os
import re
import sys

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser(description="Model selection between fitted multiplicities via log-evidence.")
    parser.add_argument("--platform", default=None, help="force a JAX platform (e.g. cpu for a CPU-only run)")
    parser.add_argument("folders", nargs="*", default=["."])
    parser.add_argument("--models", default="mist")
    args = parser.parse_args(argv)
    if args.platform:
        import jax

        jax.config.update("jax_platforms", args.platform)

    from ..starmodel import BasicStarModel

    for folder in args.folders:
        starmodels = glob.glob(os.path.join(folder, f"{args.models}_starmodel_*.h5"))
        names, evidences = [], []
        for sm in starmodels:
            m = re.search(rf"{args.models}_starmodel_(\w+)\.h5", sm)
            if not m:
                continue
            model = BasicStarModel.load_hdf(sm)
            if model.evidence is None:
                print(f"{sm}: no evidence stored (emcee fit?)")
                continue
            names.append(m.group(1))
            evidences.append(model.evidence[0])
        if evidences:
            ev = np.array(evidences)
            ev -= ev.max()
            for n, e in sorted(zip(names, ev), key=lambda t: -t[1]):
                print(f"{folder}: {n}  delta_lnZ = {e:.2f}")
        else:
            print(f"{folder}: no fitted models found")
    return 0


if __name__ == "__main__":
    sys.exit(main())
