"""Wall timers and profiling hooks (SURVEY.md §5 "Tracing/profiling").

`Timer` accumulates named spans; `timed` is the contextmanager; `trace`
wraps jax.profiler.trace for TensorBoard/Perfetto captures around pipeline
steps. Device work is asynchronous — call `sync` (readback) inside the span
when the span must cover device execution, as bench does.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict


class Timer:
    def __init__(self):
        self.spans = defaultdict(list)

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.spans[name].append(time.perf_counter() - t0)

    def total(self, name: str) -> float:
        return sum(self.spans[name])

    def summary(self) -> dict:
        return {
            k: {"n": len(v), "total_s": sum(v), "mean_s": sum(v) / len(v)}
            for k, v in self.spans.items()
            if v
        }


@contextlib.contextmanager
def timed(name: str, timer: Timer):
    with timer.span(name):
        yield


def realize(tree):
    """Force device execution to complete and return the values as numpy.

    A host readback of the outputs: all outputs of one executable
    materialize together, so reading the (F,4,4) pose array is enough to
    prove the whole program ran.
    """
    import jax

    return jax.tree_util.tree_map(lambda x: jax.device_get(x), tree)


@contextlib.contextmanager
def trace(logdir: str | None):
    """jax.profiler trace if a logdir is given, else no-op."""
    if logdir is None:
        yield
        return
    import jax

    with jax.profiler.trace(logdir):
        yield
