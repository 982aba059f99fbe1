"""Where JAX keeps its persistent compilation cache.

If JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and nothing is
changed here. Otherwise the cache goes to the fixed directory
`<repository>/.jax_cache` (git-ignored): a fixed path, because the path
is part of what a cached entry is found by.
"""

from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory (module
    docstring) and return that directory."""
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
