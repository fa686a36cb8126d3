"""Persistent XLA compilation cache.

The 273-PRB programs take minutes to compile cold; the cache brings warm
starts down to seconds.  Call early in any CLI entry point.
"""
from __future__ import annotations

import os

DEFAULT_DIR = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", ".jax_cache"))


def enable_compile_cache() -> None:
    """Keep compiled programs in <repo>/.jax_cache, unless
    JAX_COMPILATION_CACHE_DIR is set: JAX reads that variable itself, and
    then nothing is set here.  The path is fixed because it is part of
    the cache key."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
