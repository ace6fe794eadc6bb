"""Where JAX keeps its persistent compilation cache.

The one place the package configures JAX. Every entry point (the CLI,
driver.Renderer, bench.py, chip_smoke.py) calls enable_compile_cache()
before its first compile.
"""

from __future__ import annotations

import os

import jax

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_CACHE_DIR = os.path.join(CHECKOUT, ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at JAX_COMPILATION_CACHE_DIR
    when that variable is set, else at <checkout>/.jax_cache (a fixed
    path: the path is part of the cache key). Returns the directory."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR
    jax.config.update("jax_compilation_cache_dir", path)
    return path
