"""Where JAX keeps its persistent compilation cache.

One rule for every entry point (``bench.py``, ``chip_smoke.py``, the
experiments, the tools): if ``JAX_COMPILATION_CACHE_DIR`` is set, JAX
reads it itself and nothing is set in code; otherwise the cache lives at
one fixed path inside the checkout, ``<repo>/.jax_cache`` (listed in
``.gitignore``). The path is part of the cache key, so a fixed path is
what lets a later process find what an earlier one compiled.
"""

from __future__ import annotations

import os
from pathlib import Path

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def compile_cache_dir() -> Path:
    """The directory the persistent compilation cache uses."""
    env = os.environ.get(ENV_VAR)
    return Path(env) if env else DEFAULT_DIR


def enable_compile_cache() -> Path:
    """Point JAX's persistent compilation cache at :func:`compile_cache_dir`
    (a no-op when ``JAX_COMPILATION_CACHE_DIR`` is set: JAX has already
    read it). Call before the first compilation; returns the directory."""
    path = compile_cache_dir()
    if os.environ.get(ENV_VAR):
        return path
    import jax

    jax.config.update("jax_compilation_cache_dir", str(path))
    return path
