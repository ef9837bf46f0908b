"""Persistent XLA compile cache shared by the CLI, bench.py and
chip_smoke.py.

Repeat runs of the same (scene class, size, spp) skip recompiling — the
reference binary's analog is its ahead-of-time metallib (build.rs).
"""

from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"

# <checkout>/.jax_cache: a fixed path (the cache key includes it), listed
# in .gitignore.
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))),
    ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on the persistent compile cache; returns its directory.

    If JAX_COMPILATION_CACHE_DIR is set, JAX already reads it and nothing
    is set in code; otherwise the cache lives in DEFAULT_DIR."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
