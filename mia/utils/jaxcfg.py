"""Process-wide JAX configuration for the device engines.

The reference is a single ahead-of-time compiled C binary; our equivalent of
"compile once" is JAX's persistent compilation cache.  Kernel shapes are
process-constant by design (see core/jax_engine.py), so the cache holds one
program per (reference bucket, backend) pair and a second process loads it
instead of compiling.

Where the cache lives: ``JAX_COMPILATION_CACHE_DIR`` when it is set (JAX
reads it itself; this module then sets no directory), otherwise one fixed
directory inside the checkout, ``.jax_cache/`` (listed in ``.gitignore``).
"""
from __future__ import annotations

import os

_done = False

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def cache_dir_path() -> str:
    """Directory of the persistent compile cache (and the server's
    warm-shape list)."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or CACHE_DIR


def setup_jax_cache() -> None:
    """Enable the persistent compilation cache for every program, however
    short its compile (idempotent)."""
    global _done
    if _done:
        return
    _done = True
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(CACHE_DIR, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
