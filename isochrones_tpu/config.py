"""Global configuration for isochrones-tpu.

Mirrors the role of the reference's ``isochrones/config.py:1-7`` (data-dir env
override), extended with the default compute dtype and the compile cache.
"""

import os

ISOCHRONES = os.getenv("ISOCHRONES", os.path.expanduser(os.path.join("~", ".isochrones")))

#: Default on-device dtype for grid data / kernels. float32 is the accelerator
#: dtype (the GPU's float64 rate is a fraction of its float32 rate, and the
#: compiled cluster kernel is float32 only); tests run float64 on the CPU for
#: high-precision parity.
DEFAULT_DTYPE = os.getenv("ISOCHRONES_TPU_DTYPE", "float32")

#: Set to "1" to disable any attempt at network downloads (e.g. hermetic CI).
OFFLINE = os.getenv("ISOCHRONES_TPU_OFFLINE", "0") == "1"

ON_RTD = os.getenv("READTHEDOCS", None) == "True"


#: Compile-cache directory used when ``JAX_COMPILATION_CACHE_DIR`` is unset:
#: a fixed path (the path is part of the cache key, so a moving directory
#: never hits), ``.jax_cache`` at the repo root (listed in .gitignore).
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def enable_compile_cache(cache_dir=None):
    """Turn on JAX's persistent compilation cache. Where
    ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and no
    directory is set here; otherwise the cache goes to ``cache_dir``
    (default :data:`DEFAULT_CACHE_DIR`). Shared by bench.py,
    chip_smoke.py, __graft_entry__.py, and tests/conftest.py."""
    import jax

    if "JAX_COMPILATION_CACHE_DIR" not in os.environ:
        jax.config.update("jax_compilation_cache_dir", cache_dir or DEFAULT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
