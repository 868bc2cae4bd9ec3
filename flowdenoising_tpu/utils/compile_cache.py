"""Persistent XLA compilation cache.

The per-pass programs take many seconds to compile cold (one shared
per-pass program, see core/pipeline.py); the reference has no compile step
at all, so repeated CLI invocations must not re-pay it.  JAX's persistent
compilation cache stores serialized XLA executables on disk keyed by HLO +
compile options + backend, so the second run of a configuration loads its
programs instead of compiling them.  On the GPU the cache directory also
holds XLA's per-fusion autotuning results, so a new program reuses the
kernel choices of earlier ones.

Enabled by default for CLI/bench entry points; library users opt in by
calling :func:`enable_compilation_cache`.  Placement:

- ``JAX_COMPILATION_CACHE_DIR``, when set, is used as it is (JAX reads it
  itself; no other directory is set here);
- otherwise ``.jax_cache/`` at the root of the checkout (listed in
  ``.gitignore``).  The path is part of the autotune cache's key, so it is
  fixed: never derived from the home directory, a temporary name, a
  process id or the time.

``FDTPU_NO_CACHE=1`` disables the cache.
"""

from __future__ import annotations

import logging
import os

CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def cache_dir() -> str:
    """The directory the persistent cache uses."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or CHECKOUT_CACHE_DIR


def enable_compilation_cache() -> str | None:
    """Point JAX's persistent compilation cache at :func:`cache_dir`.

    Idempotent; returns the cache dir in use, or None when disabled.
    """
    if os.environ.get("FDTPU_NO_CACHE"):
        return None
    path = cache_dir()
    try:
        os.makedirs(path, exist_ok=True)
    except OSError as e:
        logging.warning(f"could not create compilation cache dir {path}: {e}")
        return None
    import jax

    jax.config.update("jax_compilation_cache_dir", path)
    # Cache every program that took noticeable compile time; the per-pass
    # programs are few and large, so disk use stays small.
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    logging.debug(f"XLA compilation cache at {path}")
    return path
