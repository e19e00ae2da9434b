"""Worker-failure detection for multi-host collectives (SURVEY.md §5).

A dead peer leaves a collective HANGING, not erroring: the surviving
process blocks inside the runtime forever (measured: the 2-process CPU
`jax.distributed` psum never returns after the peer dies). The reference
had no multi-device path at all; the recovery story here
(SURVEY.md §5 "Failure detection") is detect-by-timeout + restart from
checkpoint:

- `with_timeout(fn, timeout_s)` runs a blocking device computation
  (including its collectives and the host readback fence) on a watchdog
  thread and raises `WorkerFailure` when it doesn't complete in time.
- The caller's recovery is process-level: checkpoint state is already on
  disk (slam/checkpoint.py writes atomically), so the supervisor restarts
  the job and `--resume` continues from the last frame. The hung runtime
  thread cannot be cancelled from Python — after WorkerFailure the process
  must exit; that is exactly the restart-from-checkpoint path.

Used by tests/test_multiprocess.py's worker-kill injection and available
to any long-running multi-host driver loop.
"""

from __future__ import annotations

import concurrent.futures as _fut
from typing import Any, Callable


class WorkerFailure(RuntimeError):
    """A distributed computation failed to complete within its deadline —
    the canonical signature of a dead/partitioned peer in a collective."""


_POOL: _fut.ThreadPoolExecutor | None = None


def with_timeout(fn: Callable[[], Any], timeout_s: float) -> Any:
    """Run `fn()` (blocking device work, e.g. a psum-carrying step + realize
    fence) with a deadline. Returns fn's result, re-raises fn's exception,
    or raises WorkerFailure on deadline.

    The watchdog thread is daemonic and shared: a timed-out computation
    leaves its thread blocked in the runtime (unkillable from Python), so
    after WorkerFailure the caller should persist what it has and exit —
    recovery is restart-from-checkpoint, not in-process retry.
    """
    global _POOL
    if _POOL is None:
        _POOL = _fut.ThreadPoolExecutor(
            max_workers=4, thread_name_prefix="dist-watchdog"
        )
    future = _POOL.submit(fn)
    try:
        return future.result(timeout=timeout_s)
    except _fut.TimeoutError:
        raise WorkerFailure(
            f"distributed computation exceeded {timeout_s:.1f}s deadline — "
            "peer process presumed dead; restart from checkpoint"
        ) from None
