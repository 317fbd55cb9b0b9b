"""chip_smoke.py and the compile-cache rule, checked on the CPU.

The smoke script measures the card: where JAX's default device is not a
GPU it must refuse, print no result line, and exit non-zero.
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke():
    sys.path.insert(0, REPO)
    import chip_smoke

    return chip_smoke


@pytest.mark.parametrize("argv", [[], ["--chips", "4"]])
def test_chip_smoke_refuses_without_gpu(argv, capsys):
    with pytest.raises(SystemExit) as exc:
        _smoke().main(argv)
    assert exc.value.code not in (0, None)
    assert "not a GPU" in str(exc.value.code)
    assert '"ok"' not in capsys.readouterr().out


def test_chip_smoke_alone_fails(tmp_path):
    """Without the package beside it the script cannot import the system
    and exits non-zero, with no result line."""
    import shutil

    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH="")
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_full_sizes():
    """The script's own run is the MIST-scale configuration: the full grid,
    50 stars x 1710 EEPs x 16 walkers, lnpost batch 2^17, 256-star catalog."""
    cs = _smoke()
    assert cs.FULL.grid == (15, 196, 1710, 107)
    assert cs.FULL.ladders == (800, 1710) and cs.FULL.n_walkers == 16
    assert cs.FULL.n_stars == 50 and cs.FULL.lnpost_batch == 1 << 17
    assert cs.FULL.catalog_stars == 256


def _cache_dir_after(monkeypatch, env_value):
    import jax

    from isochrones_tpu import config

    before = jax.config.jax_compilation_cache_dir
    if env_value is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_value)
    try:
        jax.config.update("jax_compilation_cache_dir", "sentinel-unset")
        config.enable_compile_cache()
        return jax.config.jax_compilation_cache_dir
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, the program sets no cache
    directory of its own."""
    assert _cache_dir_after(monkeypatch, str(tmp_path)) == "sentinel-unset"


def test_compile_cache_default_is_repo_dir(monkeypatch):
    """Without it, the cache is the fixed <repo>/.jax_cache."""
    from isochrones_tpu import config

    got = _cache_dir_after(monkeypatch, None)
    assert got == config.DEFAULT_CACHE_DIR == os.path.join(REPO, ".jax_cache")
