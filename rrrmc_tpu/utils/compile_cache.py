"""One place that decides where JAX keeps its persistent compilation cache.

If JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and nothing is set
here. Otherwise the cache lives at one fixed path inside the checkout,
`<repo>/.jax_cache` (listed in .gitignore): a fixed path keeps cache keys
stable from run to run.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

ENV = "JAX_COMPILATION_CACHE_DIR"

#: the checkout's own cache directory, used when ENV is unset
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and return
    that directory. Call before the first compilation."""
    if os.environ.get(ENV):
        return os.environ[ENV]
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
