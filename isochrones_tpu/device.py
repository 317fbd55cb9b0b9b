"""The one question the program asks about the machine it runs on."""

import jax


def on_accelerator() -> bool:
    """True when JAX's default backend is a GPU.

    Accelerator sizes (sampler batch widths, the compiled cluster kernel,
    float32 grids) key on this; everything else is plain JAX that runs the
    same on any backend. Asked at call time, so a test can fake the backend
    with ``monkeypatch.setattr(jax, "default_backend", ...)``."""
    return jax.default_backend() == "gpu"
