"""Persistent XLA compilation cache.

Compiling the wavefront fills takes seconds to minutes; the persistent
cache lets every CLI invocation after the first start warm. The cache
directory is ``$JAX_COMPILATION_CACHE_DIR`` when that is set (JAX reads
it itself; nothing else is configured here), otherwise the fixed
``<repo>/.jax_cache`` inside the checkout. The path is part of the
cache key, so it never depends on a temporary name, a process id or
the time. Call before the first jit execution (idempotent).
"""

from __future__ import annotations

import logging
import os

log = logging.getLogger(__name__)

_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

#: Cache directory used when ``JAX_COMPILATION_CACHE_DIR`` is unset.
DEFAULT_CACHE_DIR = os.path.join(_REPO_ROOT, ".jax_cache")


def cache_dir() -> str:
    """The directory compiled programs persist to."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


def enable_persistent_cache() -> str:
    """Turn the persistent compilation cache on; returns its directory."""
    import jax

    path = cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return path
