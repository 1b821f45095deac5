"""Persistent JAX compilation cache for the repo's entry points."""
from __future__ import annotations

import os

# <checkout>/.jax_cache, derived from this file's location
# (altro_jax/utils/cache.py → checkout root)
CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compilation_cache() -> str | None:
    """Turn on JAX's persistent compilation cache.

    If `JAX_COMPILATION_CACHE_DIR` is set, JAX already reads it and this
    sets nothing (returns None).  Otherwise the cache lives in the
    checkout's `.jax_cache` directory, whose path is returned.
    """
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    import jax

    jax.config.update("jax_compilation_cache_dir", CHECKOUT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return CHECKOUT_CACHE_DIR
