"""Process set-up shared by every entry point (CLI, bench.py, chip_smoke.py,
the test suite)."""

from __future__ import annotations

import os
import pathlib

#: The checkout root (the directory that holds the ``sdft_tpu`` package).
REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent


def setup_compile_cache() -> str:
    """Choose JAX's persistent compilation cache directory and return it.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
    sets nothing.  Otherwise the cache is ``.jax_cache/`` at the checkout
    root: a fixed path, so a second process on the same checkout finds what
    the first compiled.  Call before the first compilation.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    path = str(REPO_ROOT / ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
