"""Where the persistent XLA compilation cache lives.

``JAX_COMPILATION_CACHE_DIR`` wins when it is set. Otherwise the cache is a
fixed directory inside the repository (``<repo>/.jax_cache``, listed in
``.gitignore``): the path is part of the cache key, so a path that changes
between runs never hits.
"""

from __future__ import annotations

import os

import jax

REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
DEFAULT_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def cache_dir() -> str:
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at ``cache_dir()``; returns it."""
    path = cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
