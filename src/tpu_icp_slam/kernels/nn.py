"""Nearest-neighbour dispatch: the Triton-route Pallas kernel or plain XLA.

`nearest_neighbor(src, dst, backend=...)`:
  - "pallas": the fused running-argmin kernel (kernels/nn_pallas.py)
  - "xla":    the chunked distance-matrix version (kernels/nn_xla.py)
  - "auto":   `resolve_backend` picks by platform
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from tpu_icp_slam.kernels.nn_xla import nn_bruteforce_xla

# what "auto" means on each platform the program runs on; any other
# platform is an error, never a silent fallback
AUTO_BACKEND = {"gpu": "pallas", "cpu": "xla"}


def resolve_backend(backend: str, platform: str | None = None) -> str:
    """The concrete NN backend for `backend` on `platform` (default: JAX's)."""
    platform = platform or jax.default_backend()
    if platform not in AUTO_BACKEND:
        raise RuntimeError(f"unsupported platform {platform!r}")
    if backend == "auto":
        return AUTO_BACKEND[platform]
    if backend not in ("pallas", "xla"):
        raise ValueError(f"unknown NN backend: {backend}")
    return backend


def nearest_neighbor(
    src: jnp.ndarray,
    dst: jnp.ndarray,
    backend: str = "auto",
    chunk: int = 2048,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(M, D), (N, D) -> (idx (M,) int32, dist_sq (M,) f32)."""
    if resolve_backend(backend) == "pallas":
        from tpu_icp_slam.kernels.nn_pallas import nn_bruteforce_pallas

        return nn_bruteforce_pallas(src, dst)
    return nn_bruteforce_xla(src, dst, chunk=chunk)
