"""Runtime setup helpers (compilation cache, profiling traces).

SURVEY.md §5.1/§7 hard-part 5: per-bucket static shapes mean one XLA compile
per bucket, and long scans take a while to compile, so every entry point
(all CLIs through ``cli/common.py``, ``chip_smoke.py``, ``bench.py``) turns
on the persistent compilation cache — warm restarts then reuse every
bucket's program.
"""

from __future__ import annotations

import os

# repo root: the cache stays inside the checkout (listed in .gitignore)
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_CACHE_DIR = os.path.join(_ROOT, ".jax_cache")


def compilation_cache_dir() -> str:
    """``$JAX_COMPILATION_CACHE_DIR`` when set, else ``<repo>/.jax_cache``."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


def enable_compilation_cache() -> str | None:
    """Point JAX's persistent compilation cache at
    ``compilation_cache_dir()`` and return that path (None on the CPU
    backend: XLA:CPU cache entries embed host-feature flags that the
    loader mis-compares across processes, and CPU compiles are fast). No
    other cache is set in code."""
    import jax

    if jax.default_backend() == "cpu":
        return None
    cache_dir = compilation_cache_dir()
    os.makedirs(cache_dir, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return cache_dir


def profile_trace(log_dir: str):
    """Context manager: jax.profiler trace around a training window
    (SURVEY.md §5.1 — tracing/profiling subsystem)."""
    import jax

    return jax.profiler.trace(log_dir, create_perfetto_trace=True)
