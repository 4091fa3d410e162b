"""JAX's persistent compilation cache for the entry points.

Every entry point (``bench.py``, ``chip_smoke.py``, the CLI, the bench
scripts) calls :func:`enable` before its first compile.  When
``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing is
set here.  Otherwise the cache lives at ``<repo>/.jax_cache``: a fixed path
(the path is part of the cache key, so a directory that moves never hits)
that ``.gitignore`` lists.
"""

from __future__ import annotations

import os

import jax

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable() -> str:
    """Turn the persistent cache on; returns the directory in use."""
    if os.environ.get(ENV):
        return os.environ[ENV]
    os.makedirs(DEFAULT_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
