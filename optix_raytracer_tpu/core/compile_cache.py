"""Where compiled executables persist between processes.

JAX reads `JAX_COMPILATION_CACHE_DIR` itself; when it is set, that cache is
used and nothing here sets another. When it is unset, the cache goes to a
fixed `.jax_cache/` directory in the checkout (listed in `.gitignore`), so
every entry point of the repository shares one cache whose path is stable
from run to run (the path is part of the cache key).
"""
from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def compile_cache_dir() -> str:
    """The directory the persistent compilation cache uses."""
    return os.environ.get(ENV) or CHECKOUT_CACHE_DIR


def enable_compile_cache() -> str:
    """Turn the persistent compilation cache on; returns its directory."""
    if os.environ.get(ENV):
        return os.environ[ENV]
    import jax
    os.makedirs(CHECKOUT_CACHE_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", CHECKOUT_CACHE_DIR)
    return CHECKOUT_CACHE_DIR
