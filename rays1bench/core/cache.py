"""Persistent compilation cache.

Where JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and this module
sets nothing. Otherwise the cache lives at one fixed path inside the
checkout, `.jax_cache/` (listed in .gitignore): the path is part of what
makes a later process find the entries again.
"""

from __future__ import annotations

import os

import jax

CHECKOUT_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(CHECKOUT_DIR, ".jax_cache")


def enable() -> str:
    """Turn on the persistent compilation cache (idempotent); returns the
    directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    os.makedirs(DEFAULT_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
