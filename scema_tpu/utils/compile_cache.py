"""Where JAX keeps its persistent compilation cache.

One rule for every entry point (the CLI, bench.py, chip_smoke.py): where
``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing is
set here; otherwise the cache lives at the checkout's fixed ``.jax_cache/``
(listed in .gitignore), so that runs from the same checkout hit it.
"""
from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and return
    that directory.  Call before the first compile."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    return REPO_CACHE_DIR
