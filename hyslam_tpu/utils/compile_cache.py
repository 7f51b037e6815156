"""Persistent XLA compilation cache for the entry-point scripts.

The system compiles many large programs (extraction, tracking step, mapper
jobs, bundle adjustment). Entry points call `enable_compile_cache()` once,
before their first compile, so a second run of the same code skips XLA.
The test suite does not call it.
"""

from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"

# fixed, git-ignored, inside the checkout: the cache key includes nothing
# about the path, but a directory that moves between runs never hits
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Use `$JAX_COMPILATION_CACHE_DIR` when it is set (JAX reads it itself
    and nothing else is configured), else `<checkout>/.jax_cache`. Returns
    the directory in use."""
    path = os.environ.get(ENV_VAR)
    if path:
        return path
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
