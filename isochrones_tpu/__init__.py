"""isochrones-tpu: accelerator-native stellar model-grid interpolation and Bayesian
star-parameter inference.

A from-scratch JAX/XLA/Pallas rebuild of the capabilities of
``timothydmorton/isochrones`` (reference public exports at
``isochrones/__init__.py:9-10``): MIST grid interpolation, synthetic
photometry, single/binary/triple star posterior inference with fully
on-device samplers, cluster fitting, and population synthesis.
"""

__version__ = "0.1.0"

from .ops import GridData, GridInterpolator, interp_nd

__all__ = [
    "GridData",
    "GridInterpolator",
    "interp_nd",
    "get_ichrone",
    "StarModel",
    "BasicStarModel",
    "SingleStarModel",
    "BinaryStarModel",
    "TripleStarModel",
]


def __getattr__(name):
    # Lazy imports keep `import isochrones_tpu` light (grid/model layers pull
    # in pandas only when used).
    if name == "get_ichrone":
        from .isochrone import get_ichrone

        return get_ichrone
    if name in ("StarModel", "StarModelGroup"):
        from . import treemodel

        return getattr(treemodel, name)
    if name in ("BasicStarModel", "SingleStarModel", "BinaryStarModel", "TripleStarModel", "IsoTrackModel"):
        from . import starmodel

        return getattr(starmodel, name)
    raise AttributeError(f"module 'isochrones_tpu' has no attribute {name!r}")
