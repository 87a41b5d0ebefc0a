"""One rule for JAX's persistent compilation cache.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
module configures nothing. Otherwise the cache lives in ``.jax_cache`` at the
root of the checkout, a fixed path, so a later process finds its programs.
"""

from __future__ import annotations

import os
import pathlib

CACHE_DIR = pathlib.Path(__file__).resolve().parent.parent / ".jax_cache"


def configure() -> None:
    """Point JAX at the cache; call before the first compilation."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax

    jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))
