"""Persistent XLA compilation cache.

Every jitted shape (the fused flow's buckets, the staged chaining pass)
compiles once per process; JAX's persistent cache makes every later
process start hot. Where JAX_COMPILATION_CACHE_DIR is set, JAX reads it
itself and this module sets no other directory. Otherwise the cache lives
at one fixed path inside the checkout, build/xla_cache (listed in
.gitignore): the path is part of the cache key, so it must not move."""
from __future__ import annotations

import os

BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build")
CACHE_DIR = os.path.join(BUILD_DIR, "xla_cache")

_done = False


def cache_dir() -> str:
    """The directory the persistent cache uses in this environment."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or CACHE_DIR


def enable_persistent_cache() -> None:
    global _done
    if _done:
        return
    _done = True
    import jax
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(CACHE_DIR, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
