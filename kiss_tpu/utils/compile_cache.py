"""Persistent XLA compilation cache.

Every CLI process compiles the sort, build and query programs for its
shapes; the persistent cache lets a later process with the same shapes
load them instead. ``JAX_COMPILATION_CACHE_DIR``, when set, is JAX's own
setting and is left alone. Otherwise the cache lives at a fixed
``<repo root>/.jax_cache``: the directory is part of the cache key, so a
path that moved between runs would never hit. ``KISS_TPU_NO_CACHE=1``
turns the cache off (the test suite sets it).
"""

from __future__ import annotations

import os

REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))),
    ".jax_cache",
)

_enabled = False


def cache_dir() -> str:
    """The directory the persistent cache uses."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or REPO_CACHE_DIR


def enable() -> None:
    """Turn the persistent cache on (idempotent; a no-op under
    ``KISS_TPU_NO_CACHE``)."""
    global _enabled
    if _enabled or os.environ.get("KISS_TPU_NO_CACHE"):
        return
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        import jax

        os.makedirs(REPO_CACHE_DIR, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    _enabled = True
