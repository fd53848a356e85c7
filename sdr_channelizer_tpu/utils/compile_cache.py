"""JAX's persistent compilation cache, at one fixed place.

A cache hit needs the same directory every time, so the path is fixed:
``JAX_COMPILATION_CACHE_DIR`` when the environment sets it (JAX reads it
itself, and nothing is set here), else ``<repo>/.jax_cache`` (listed in
``.gitignore``).
"""

from __future__ import annotations

import os

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(_REPO, ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and return
    the path.  Call before the first compilation."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
