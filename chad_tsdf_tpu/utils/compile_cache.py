"""Where JAX keeps its persistent compilation cache.

Compiling the insert, finalize and marching-cubes graphs for the GPU takes
tens of seconds; the persistent cache makes a second process start in
seconds.  The cache directory is part of the cache's key, so it is a fixed
path: ``JAX_COMPILATION_CACHE_DIR`` when the environment sets it (JAX reads
that variable itself), otherwise ``.jax_cache`` at the root of this
checkout.
"""

from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def checkout_cache_dir() -> str:
    """``<checkout>/.jax_cache``, from this file's location."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(root, ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's compile cache at its fixed directory; returns it.

    Sets nothing when ``JAX_COMPILATION_CACHE_DIR`` is set."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    path = checkout_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
