"""The persistent compilation cache every entry point shares.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and no
directory is set here.  Otherwise the cache is ``<checkout>/.jax_cache``,
a fixed path (it is part of the cache key) found from this file.
"""

from __future__ import annotations

import os
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parent.parent
DEFAULT_DIR = CHECKOUT / ".jax_cache"


def enable_compile_cache() -> str:
    """Point JAX's persistent cache at the shared directory; returns it."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
