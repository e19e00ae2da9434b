"""Device-mesh construction helpers (SURVEY.md §2b N15).

The reference is single-process/single-GPU with no communication backend
(SURVEY.md §2a "Parallelism & communication"; mount empty, §0). The new
framework scales through a `jax.sharding.Mesh`: axis "dp" batches independent
alignments (frame pairs, loop-closure verifications), axis "sp" shards the
source-point dimension of the distance matrix (the spatial/tensor-parallel
analogue), and pose-graph keyframe blocks partition over "dp" in the backend.
All collectives are XLA's (psum/all_gather/reduce_scatter), which it hands to
NCCL on the GPU. The cards of one host are joined all to all by NVLink, so
the mesh shape follows the algorithm, not the wiring.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

import jax


def _two_way_factor(n: int) -> tuple[int, int]:
    """Largest divisor pair (a, b), a <= b, a*b = n — balanced 2D mesh."""
    best = (1, n)
    for a in range(1, int(np.sqrt(n)) + 1):
        if n % a == 0:
            best = (a, n // a)
    return best


def make_mesh(
    n_devices: Optional[int] = None,
    axes: Sequence[str] = ("dp", "sp"),
    shape: Optional[Sequence[int]] = None,
    devices=None,
) -> jax.sharding.Mesh:
    """Build a Mesh over the first n_devices. shape=None auto-factors.

    Raises when the default platform has fewer than n_devices: a mesh
    request is never served on another platform or with fewer devices.
    """
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            if len(devices) < n_devices:
                raise ValueError(
                    f"make_mesh: {n_devices} devices requested but only "
                    f"{len(devices)} on platform {devices[0].platform!r}"
                )
            devices = devices[:n_devices]
    n = len(devices)
    if shape is None:
        if len(axes) == 1:
            shape = (n,)
        elif len(axes) == 2:
            shape = _two_way_factor(n)
        else:
            raise ValueError("pass an explicit shape for >2 mesh axes")
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    return jax.sharding.Mesh(np.asarray(devices).reshape(shape), tuple(axes))


def multihost_init(coordinator: Optional[str] = None) -> None:
    """Multi-host bootstrap: `jax.distributed.initialize` (config 5).

    Must run BEFORE any jax op touches a backend (initialize raises after
    backend init — and `jax.process_count()` itself initializes backends, so
    we probe `jax.distributed.is_initialized()` instead). In a multi-host run each
    host calls this first; the coordinator comes from the argument or from
    JAX's own variables (JAX_COORDINATOR_ADDRESS, with JAX_NUM_PROCESSES and
    JAX_PROCESS_ID).

    Failure policy: an *explicitly requested* coordinator that fails to
    connect raises — a misconfigured cluster must not silently degrade to
    single-process. With no coordinator argument and no such variable this
    is a no-op (the single-process case), logged at debug level.
    """
    import logging

    log = logging.getLogger(__name__)
    dist_state = getattr(jax.distributed, "global_state", None)
    already = (
        jax.distributed.is_initialized()
        if hasattr(jax.distributed, "is_initialized")
        else (dist_state is not None and dist_state.client is not None)
    )
    if already:
        log.debug("jax.distributed already initialized; multihost_init no-op")
        return
    if coordinator is None and not os.environ.get("JAX_COORDINATOR_ADDRESS"):
        log.debug("no coordinator configured; staying single-process")
        return
    try:
        if coordinator is not None:
            jax.distributed.initialize(coordinator_address=coordinator)
        else:
            jax.distributed.initialize()  # JAX_* environment variables
    except Exception as exc:
        # explicit request → hard failure; silent degradation is the trap
        log.error("jax.distributed.initialize failed: %s", exc)
        raise
