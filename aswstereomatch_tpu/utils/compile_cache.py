"""Where JAX's persistent compilation cache lives.

Entry points (``bench.py``, ``cli.py``, ``chip_smoke.py``, ``tools/*.py``)
call ``enable()`` once at start-up, never at import.  A compiled program is
keyed by its HLO, so every process in this checkout — and every entry point
that traces the same program — compiles it once.
"""

from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"

# The cache directory is part of the cache key, so it is a fixed path inside
# the checkout: never a temporary name, a pid or a time.
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable() -> str:
    """Turn the persistent compilation cache on; return its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
    sets nothing.  Otherwise the cache goes to ``<checkout>/.jax_cache``.
    """
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
