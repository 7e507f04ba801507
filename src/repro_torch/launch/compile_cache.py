"""Persistent kernel cache (counterpart of `repro.launch.compile_cache`).

The JAX package points jax's persistent compilation cache at a directory,
so that a second process skips re-jit. The port compiles no graph; what it
builds is the one shared library of its CUDA kernels (`kernels/_build.py`),
keyed on a hash of the sources and the nvcc flags, and reused as it is
from the directory it was built into. `enable_compilation_cache(dir)`
points that directory at `dir`: a later process that enables the same
directory loads the library from it without starting nvcc. Exposed as the
`compilation_cache_dir=` knob on `ServingEngine`, as in the JAX package.

Safe to call more than once (idempotent per directory). A different
directory re-points the cache for a library not yet loaded in this
process; a library already loaded stays the one in use.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

from repro_torch.kernels import _build

_enabled_dir: Optional[str] = None


def enable_compilation_cache(cache_dir: str, *,
                             min_entry_size_bytes: int = 0,
                             min_compile_time_secs: float = 0.0) -> bool:
    """Point the kernel library's build and load directory at `cache_dir`
    (created if missing). Returns True when the cache is active, False when
    the directory cannot be made. The floors are accepted for the JAX
    signature's sake: the cache holds one library, so it has no entry
    floors."""
    global _enabled_dir
    cache_dir = os.path.abspath(os.path.expanduser(str(cache_dir)))
    if _enabled_dir == cache_dir:
        return True
    try:
        os.makedirs(cache_dir, exist_ok=True)
    except OSError:
        return False
    _build.BUILD_DIR = Path(cache_dir)
    _enabled_dir = cache_dir
    return True


def compilation_cache_dir() -> Optional[str]:
    """The directory the persistent cache was enabled with (None = off)."""
    return _enabled_dir
