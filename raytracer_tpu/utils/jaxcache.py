"""Persistent XLA compilation cache setup.

Called by the CLI, bench and driver entry points before first device use.
When JAX_COMPILATION_CACHE_DIR is set, JAX keeps its cache there and this
module sets no other directory; otherwise the cache goes to the fixed path
`<checkout>/.jax_cache` (a fixed path, because the path is part of the
cache's key).
"""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..", ".jax_cache"))


def cache_dir() -> str:
    """The directory the persistent compilation cache uses."""
    return os.environ.get(ENV) or DEFAULT_DIR


def enable() -> str:
    import jax

    if not os.environ.get(ENV):
        jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return cache_dir()
