"""Where JAX keeps its persistent compile cache for this package's entry
points (``cli.main``, ``bench.py``, ``chip_smoke.py``)."""

from __future__ import annotations

import os

# A fixed path: the cache directory is part of the cache key, so a
# directory that moved between runs would never hit.
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def use_compile_cache() -> str:
    """Enable the persistent compile cache and return its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and the
    cache is left alone; otherwise it goes to ``<repo>/.jax_cache``."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
