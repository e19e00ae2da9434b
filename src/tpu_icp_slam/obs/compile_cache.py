"""Persistent XLA compilation cache (opt-out via TPU_ICP_SLAM_NO_CACHE=1).

Where `JAX_COMPILATION_CACHE_DIR` is set, JAX uses that directory and this
module sets no other path. Otherwise the cache lives at a fixed directory
inside the checkout (`.jax_cache/`, listed in .gitignore): the path is part
of what makes a later process find the entry, so it holds no temporary
name, process id or time. Called by the CLI, bench.py and chip_smoke.py
before any jit.
"""

from __future__ import annotations

import os

CHECKOUT_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))),
    ".jax_cache",
)


def cache_dir() -> str:
    """The directory the cache uses in this process."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or CHECKOUT_CACHE


def enable(path: str | None = None) -> None:
    """Turn the cache on; `path` replaces the checkout directory only where
    `JAX_COMPILATION_CACHE_DIR` is not set."""
    if os.environ.get("TPU_ICP_SLAM_NO_CACHE") == "1":
        return
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        path = path or CHECKOUT_CACHE
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 5.0)
