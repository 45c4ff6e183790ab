"""Persistent XLA compilation cache for the entry points.

The fused estimator step takes tens of seconds to compile; the persistent
cache lets a later process with unchanged programs load the executables
instead. The CLI, the bench, the examples and chip_smoke.py run inside
`compilation_cache()`, which restores JAX's global configuration on exit, so
a library user or a test that calls an entry point in-process is left as it
was.
"""

from __future__ import annotations

import contextlib
import os

# <checkout>/.jax_cache: a fixed path, because the cache key includes it.
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")

# Persist every executable. On the GPU even a trivial jitted helper runs
# XLA's LLVM and ptxas pipeline when compiled (tens of milliseconds), and an
# entry point compiles dozens of them besides the step; a cache hit is one
# small file read.
MIN_COMPILE_TIME_SECS = 0.0

_OPTIONS = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")


@contextlib.contextmanager
def compilation_cache():
    """Cache compiled executables in $JAX_COMPILATION_CACHE_DIR when it is
    set, else in DEFAULT_DIR, for the duration of the block. Yields the
    directory."""
    import jax
    from jax.experimental.compilation_cache import compilation_cache as cc

    saved = {name: getattr(jax.config, name) for name in _OPTIONS}
    cache_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR
    os.makedirs(cache_dir, exist_ok=True)
    cc.reset_cache()
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      MIN_COMPILE_TIME_SECS)
    try:
        yield cache_dir
    finally:
        for name, value in saved.items():
            jax.config.update(name, value)
        cc.reset_cache()
