"""Persistent XLA compile cache for the entry points (CLI, chip_smoke.py,
bench.py, tools)."""

from __future__ import annotations

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def enable_compile_cache() -> str:
    """Use ``JAX_COMPILATION_CACHE_DIR`` when it is set (JAX reads it
    itself; nothing else is set), else ``<checkout>/.jax_cache``. Returns
    the directory in use."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if path:
        return path
    import jax

    path = os.path.join(CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
