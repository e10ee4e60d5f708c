"""Persistent XLA compilation cache location.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
nothing is set here. Otherwise the cache lives at ``<checkout>/.jax_cache``
(listed in .gitignore), a fixed path so that the next process finds
what this one compiled.
"""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def cache_dir(checkout: str = CHECKOUT) -> str:
    """The directory the persistent cache uses for this process."""
    return os.environ.get(ENV) or os.path.join(checkout, ".jax_cache")


def enable(checkout: str = CHECKOUT) -> str:
    """Point JAX's persistent cache at ``cache_dir``; returns it."""
    path = cache_dir(checkout)
    if not os.environ.get(ENV):
        import jax

        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    return path
