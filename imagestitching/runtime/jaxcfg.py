"""Process-wide JAX runtime configuration (the persistent compile cache).

The analog of the reference's probed-and-cached device limits
(pages/index/index.js:345-417, results cached in storage at index.js:408-412):
expensive environment discovery done once and persisted.  Here the expensive
thing is XLA compilation — a persistent compilation cache turns the
first-compile of each layout signature into a reload across processes.
"""

from __future__ import annotations

import os

_configured = False

# <checkout>/.jax_cache: a fixed path (the path is part of the cache key, so
# a directory that moves never hits), inside the checkout and git-ignored.
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def compile_cache_dir() -> str | None:
    """The directory this process should point JAX's cache at, or None when
    ``JAX_COMPILATION_CACHE_DIR`` is set: JAX reads that variable itself,
    and the program then sets no other directory."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return DEFAULT_CACHE_DIR


def ensure_compile_cache() -> None:
    """Enable JAX's persistent compilation cache (idempotent).

    ``JAX_COMPILATION_CACHE_DIR``, when set, is the cache; otherwise
    :data:`DEFAULT_CACHE_DIR`.
    """
    global _configured
    if _configured:
        return
    _configured = True
    import jax

    path = compile_cache_dir()
    try:
        if path is not None:
            os.makedirs(path, exist_ok=True)
            jax.config.update("jax_compilation_cache_dir", path)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    except OSError:
        pass  # cache is an optimization; never fail a job over it


def is_device_array(x) -> bool:
    """True for jax arrays (device-resident canvases), False for numpy.

    The one shared implementation — keep_on_device/export/preview behavior
    must agree on what counts as "on device".
    """
    return type(x).__module__.startswith("jax")
