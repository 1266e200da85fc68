"""JAX persistent compilation cache, at one fixed place per checkout.

The cache key includes the cache path, so a directory that moves between
runs never hits. Where `JAX_COMPILATION_CACHE_DIR` is set, JAX reads it
itself and nothing is set here; otherwise the cache is `<repo>/.jax_cache`.
"""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
REPO = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def cache_dir() -> str:
    """The directory the compile cache lives in."""
    return os.environ.get(ENV) or os.path.join(REPO, ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent cache at `cache_dir()`; returns that path."""
    if os.environ.get(ENV):
        return os.environ[ENV]
    import jax

    path = cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path
