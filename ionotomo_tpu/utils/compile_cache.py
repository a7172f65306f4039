"""Persistent XLA compilation cache at one fixed place.

The cache key includes the directory, so the directory must not move
between runs: ``JAX_COMPILATION_CACHE_DIR`` when the caller sets it (JAX
reads that variable itself, and nothing else is changed), otherwise
``<checkout>/.jax_cache`` (listed in ``.gitignore``).
"""
from __future__ import annotations

import os
import pathlib

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT = pathlib.Path(__file__).resolve().parents[2]


def cache_dir(environ=None) -> str:
    """The directory the cache lives in for this environment."""
    environ = os.environ if environ is None else environ
    return environ.get(ENV_VAR) or str(CHECKOUT / ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at ``cache_dir()``.

    Call before the first compilation. Returns the directory."""
    import jax

    path = cache_dir()
    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", path)
    return path
