"""Profiler integration (SURVEY.md §5 "Tracing/profiling", §2b N20).

The reference instrumented with CUDA events + wall timers for its README
charts (SURVEY.md §2a R10; mount empty, §0). The JAX equivalents:

- `trace(dir)`: context manager around `jax.profiler.trace` — captures an XLA
  trace viewable in TensorBoard/Perfetto (per-kernel device timelines, HLO
  cost attribution).
- `annotate(name)`: `jax.profiler.TraceAnnotation` so pipeline stages show up
  as named spans inside the device trace.
- `scope(name)`: `jax.named_scope` — names the HLO so compiled-kernel
  attribution maps back to pipeline stages even without a trace session.

All three degrade to no-ops if the profiler is unavailable (e.g. a backend
without profiling support), so production paths can call them
unconditionally.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def trace(log_dir: str, create_perfetto_link: bool = False):
    import jax

    try:
        with jax.profiler.trace(log_dir, create_perfetto_link=create_perfetto_link):
            yield
    except Exception:  # profiling not supported on this backend — degrade
        yield


@contextlib.contextmanager
def annotate(name: str):
    import jax

    try:
        with jax.profiler.TraceAnnotation(name):
            yield
    except Exception:
        yield


def scope(name: str):
    """jax.named_scope passthrough (usable as decorator or context manager)."""
    import jax

    return jax.named_scope(name)
