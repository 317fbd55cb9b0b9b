"""Test configuration: the CPU backend with 8 virtual devices (multi-device
sharding tests run on a virtual mesh) and float64 enabled for
high-precision parity tests against the reference semantics.

Tests that need a GPU are marked ``gpu`` and take the ``gpu`` fixture,
which skips them where JAX has no GPU backend. On a machine with a card
they run with ``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/``.
"""

import os

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_enable_x64", True)

# Persistent XLA compilation cache: the test suite is compile-dominated and
# most programs are identical between runs.
from isochrones_tpu.config import enable_compile_cache  # noqa: E402

enable_compile_cache()


@pytest.fixture
def gpu():
    """The first GPU device. Decided when a test asks for it, never at
    import time, so every pytest worker collects the same tests."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs a GPU backend: JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/")
