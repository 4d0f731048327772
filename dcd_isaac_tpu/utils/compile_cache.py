"""Persistent XLA compilation cache.

The fused cycle programs take minutes to compile cold; a disk cache lets
every process after the first (train restarts, bench reruns, eval after
train) skip that. The reference has no equivalent concern (torch eager).

Where the cache lives:
  * ``JAX_COMPILATION_CACHE_DIR`` set and non-empty: that directory, and no
    other;
  * set to the empty string: no persistent cache (hermetic opt-out);
  * unset: ``<checkout>/.jax_cache`` (listed in ``.gitignore``). A fixed
    path matters: it is part of what a later process looks up.
"""

from __future__ import annotations

import os

DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), '.jax_cache')


def cache_dir_from_env() -> str | None:
    """The cache directory the rules above select (None = disabled)."""
    env_dir = os.environ.get('JAX_COMPILATION_CACHE_DIR')
    if env_dir is None:
        return DEFAULT_CACHE_DIR
    return env_dir or None


def enable_persistent_cache() -> str | None:
    """Enable the JAX persistent compilation cache. Returns the dir used
    (None when disabled or unavailable — never raises)."""
    import jax

    cache_dir = cache_dir_from_env()
    if cache_dir is None:
        return None
    try:
        os.makedirs(cache_dir, exist_ok=True)
        jax.config.update('jax_compilation_cache_dir', cache_dir)
        # cache anything that took >1s to compile, regardless of size
        jax.config.update('jax_persistent_cache_min_compile_time_secs', 1.0)
        jax.config.update('jax_persistent_cache_min_entry_size_bytes', -1)
    except Exception as e:   # read-only checkout, old jax
        print(f'compile cache disabled ({e})', flush=True)
        return None
    return cache_dir
