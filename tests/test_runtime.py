"""The compile-cache helper every entry point calls (sdft_tpu.runtime)."""

import os
import subprocess
import sys

import jax

from sdft_tpu.runtime import REPO_ROOT, setup_compile_cache


def test_cache_defaults_to_checkout(monkeypatch):
    """Without JAX_COMPILATION_CACHE_DIR the cache is .jax_cache/ at the
    checkout root (a fixed path: a second process finds the first's)."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = setup_compile_cache()
    assert path == str(REPO_ROOT / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    assert (REPO_ROOT / "sdft_tpu").is_dir()


def test_cache_env_var_wins_and_sets_nothing(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert setup_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_cache_lands_in_env_dir(tmp_path):
    """A process started with JAX_COMPILATION_CACHE_DIR set writes its
    compiled programs there."""
    code = (
        "import jax, jax.numpy as jnp\n"
        "from sdft_tpu.runtime import setup_compile_cache\n"
        "setup_compile_cache()\n"
        "jax.jit(lambda x: jnp.sin(x) * 2)(jnp.ones(8)).block_until_ready()\n"
    )
    env = dict(os.environ, JAX_COMPILATION_CACHE_DIR=str(tmp_path),
               JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO_ROOT))
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   timeout=120, cwd=str(tmp_path))
    assert any(tmp_path.iterdir())
