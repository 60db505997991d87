"""JAX persistent compilation cache location, set in one place.

When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it and nothing here
changes it.  Otherwise the cache lives at the fixed ``<checkout>/.jax_cache``
(git-ignored): a fixed path keeps its entries valid from one run to the next.
"""

from __future__ import annotations

import os
import pathlib
import sys

CACHE_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def configure() -> str:
    """Point JAX's persistent compilation cache at its directory; returns
    the directory in use.  Safe to call before or after ``import jax``."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = str(CACHE_DIR)
    os.environ["JAX_COMPILATION_CACHE_DIR"] = path
    if "jax" in sys.modules:
        sys.modules["jax"].config.update("jax_compilation_cache_dir", path)
    return path
