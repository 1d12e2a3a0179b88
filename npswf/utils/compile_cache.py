"""Persistent XLA compilation cache placement, shared by every entry point.

A cold pipeline compile takes tens of seconds; the cache makes a second
process start warm. The cache key includes the directory, so it lives at a
fixed path: ``JAX_COMPILATION_CACHE_DIR`` when the environment sets it (JAX
reads that variable itself, and no other directory is set here), otherwise
``<repo>/.jax_cache``.
"""
from __future__ import annotations

import os

REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def setup_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its fixed directory and
    return that directory. Call before the first compile."""
    import jax
    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    cache_dir = env_dir or REPO_CACHE_DIR
    if not env_dir:
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return cache_dir
