"""Fixed-capacity padded point clouds with validity masks.

XLA requires static shapes: every cloud is stored as a (capacity, D) array
plus a (capacity,) bool mask. Invalid slots hold a large sentinel coordinate so
brute-force nearest-neighbor kernels never pick them without needing an
explicit mask argument (SURVEY.md §7 "static shapes everywhere").

Replaces the raw device buffers of the reference's CUDA ICP (SURVEY.md §2a
R5/R6; mount empty, §0 — no file:line citations possible).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

# Sentinel coordinate for padded slots: far from any real scene point, but
# small enough that squared distances stay finite in float32.
PAD_COORD = 1.0e6


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PointCloud:
    """points: (C, D) float; mask: (C,) bool; normals: optional (C, D)."""

    points: jnp.ndarray
    mask: jnp.ndarray
    normals: Optional[jnp.ndarray] = None

    @property
    def capacity(self) -> int:
        return self.points.shape[0]

    @property
    def dim(self) -> int:
        return self.points.shape[1]


def make(
    points,
    capacity: Optional[int] = None,
    normals=None,
    dtype=jnp.float32,
) -> PointCloud:
    """Build a padded cloud from a (N, D) array; pads/truncates to capacity."""
    points = jnp.asarray(points, dtype=dtype)
    n, d = points.shape
    cap = capacity if capacity is not None else n
    if n > cap:
        points = points[:cap]
        if normals is not None:
            normals = jnp.asarray(normals, dtype=dtype)[:cap]
        n = cap
    pad = cap - n
    mask = jnp.concatenate([jnp.ones((n,), bool), jnp.zeros((pad,), bool)])
    points = jnp.concatenate(
        [points, jnp.full((pad, d), PAD_COORD, dtype=dtype)], axis=0
    )
    if normals is not None:
        normals = jnp.asarray(normals, dtype=dtype)
        normals = jnp.concatenate([normals, jnp.zeros((pad, d), dtype=dtype)], axis=0)
    return PointCloud(points=points, mask=mask, normals=normals)


def count(pc: PointCloud) -> jnp.ndarray:
    return jnp.sum(pc.mask.astype(jnp.int32))


def fill_invalid(pc: PointCloud) -> PointCloud:
    """Force padded slots to the sentinel coordinate (idempotent)."""
    pts = jnp.where(pc.mask[:, None], pc.points, PAD_COORD)
    return dataclasses.replace(pc, points=pts)


def transform(T: jnp.ndarray, pc: PointCloud) -> PointCloud:
    """Apply a rigid transform; sentinel slots are re-pinned afterwards."""
    d = pc.dim
    R = T[..., :d, :d]
    t = T[..., :d, d]
    pts = pc.points @ R.T + t
    pts = jnp.where(pc.mask[:, None], pts, PAD_COORD)
    normals = None
    if pc.normals is not None:
        normals = jnp.where(pc.mask[:, None], pc.normals @ R.T, 0.0)
    return PointCloud(points=pts, mask=pc.mask, normals=normals)


def valid_points_np(pc: PointCloud) -> np.ndarray:
    """Host-side: extract only the valid points as a NumPy array."""
    pts = np.asarray(pc.points)
    mask = np.asarray(pc.mask)
    return pts[mask]


def round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def voxel_downsample_np(points: np.ndarray, voxel: float) -> np.ndarray:
    """Host-side voxel-grid downsample (first point per voxel), native/numpy.

    Used by dataset loaders before padding (the 'Velodyne downsampled' step of
    BASELINE.json config 4). Deterministic: keeps the first point per voxel in
    scan order. Fast path is the C hash-table pass (tpu_icp_slam.native);
    falls back to the numpy sort when the native lib is unavailable.
    """
    from tpu_icp_slam import native

    out = native.voxel_downsample(points, voxel)
    if out is not None:
        return out
    keys = np.floor(points / voxel).astype(np.int64)
    # lexicographic unique over rows
    _, idx = np.unique(keys, axis=0, return_index=True)
    return points[np.sort(idx)]
