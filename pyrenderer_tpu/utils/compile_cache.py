"""Where JAX keeps its persistent compilation cache.

If JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and nothing here
overrides it. Otherwise the entry points (CLI, bench.py, chip_smoke.py,
examples, the multi-process worker) call `use_checkout_cache()`, which puts
the cache at `<checkout>/.jax_cache` (listed in .gitignore). The path is
fixed on purpose: it is part of the cache's key, so a path that moved
between runs would never hit.
"""

from __future__ import annotations

import os

import jax

CHECKOUT_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def use_checkout_cache() -> str:
    """Point JAX's persistent compilation cache at the checkout unless the
    environment already chose a directory. Returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(CHECKOUT_ROOT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
