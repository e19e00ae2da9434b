"""Voxel-bucket nearest neighbor (SURVEY.md §2b N4) — the KD-tree's role.

The reference accelerated NN with a GPU KD-tree (SURVEY.md §2a R6; mount
empty, §0). Pointer-chasing trees serialize on divergent traversal; the
static-shape replacement is a *hash-grid bucket* search, the same structure modern lidar
odometry uses on GPU (KISS-ICP-style): quantize target points to voxels,
hash voxel ids into a power-of-two table of fixed-size buckets (one sort +
one scatter — all XLA), then answer each query from the 27 neighbor buckets
(one gather + a tiny dense distance block — elementwise work, because
candidates per query are O(100), not O(N)).

Complexity per ICP iteration: O(M · 27 B) instead of O(M · N) — at KITTI
scale (N ≈ 64k map points) that's ~30× less arithmetic than the brute-force
kernel, trading arithmetic for gathers.

Approximation contract (callers rely on this, mirroring the gated ICP loop):
- exact whenever the true NN lies within one voxel ring (always true when the
  correspondence gate max_corr_dist ≤ voxel) AND its bucket didn't overflow;
- bucket overflow drops the overflow points (choose `bucket` ≥ expected max
  points per voxel — with map-side voxel dedup at resolution `voxel/k`, at
  most k³ points share a search voxel);
- queries with no candidate in the 27 buckets return idx 0 with d² = +inf
  (the distance gate kills them).

Build once per align (the target/map is fixed across ICP iterations), query
inside the `lax.while_loop`.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

# three large primes for the spatial hash (Teschner et al.)
_P1, _P2, _P3 = 73856093, 19349669, 83492791


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class VoxelHashGrid:
    table: jnp.ndarray  # (H, B) int32 indices into points; -1 = empty
    points: jnp.ndarray  # (N, 3) the target cloud (padded slots = sentinel)


def _hash(q: jnp.ndarray, table_size: int) -> jnp.ndarray:
    """(..., D) int32 voxel coords (D = 2 or 3) -> (...) slot in [0, table_size)."""
    h = q[..., 0] * _P1 ^ q[..., 1] * _P2
    if q.shape[-1] >= 3:
        h = h ^ q[..., 2] * _P3
    return (h & (table_size - 1)).astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("voxel", "table_size", "bucket"))
def build(
    points: jnp.ndarray,
    mask: jnp.ndarray,
    voxel: float,
    table_size: int = 1 << 14,
    bucket: int = 16,
) -> VoxelHashGrid:
    """Bucket the valid target points by hashed voxel id. All-XLA: one sort,
    one searchsorted (run-position trick), one scatter."""
    n = points.shape[0]
    q = jnp.floor(points / voxel).astype(jnp.int32)
    slot = jnp.where(mask, _hash(q, table_size), table_size)  # invalid -> drop row
    order = jnp.argsort(slot)
    slot_s = slot[order]
    # position within each equal-slot run
    first = jnp.searchsorted(slot_s, slot_s, side="left")
    pos = jnp.arange(n, dtype=jnp.int32) - first.astype(jnp.int32)
    # overflow (pos >= bucket) and invalid (slot == table_size) rows drop out
    row = jnp.where(slot_s < table_size, slot_s, table_size)
    col = jnp.where(pos < bucket, pos, bucket)
    table = jnp.full((table_size + 1, bucket + 1), -1, jnp.int32)
    table = table.at[row, col].set(order.astype(jnp.int32), mode="drop")
    return VoxelHashGrid(table=table[:table_size, :bucket], points=points)


@functools.partial(jax.jit, static_argnames=("voxel",))
def query(grid: VoxelHashGrid, src: jnp.ndarray, voxel: float):
    """(M, 3) queries -> (idx (M,) int32, d2 (M,)); d2=+inf if no candidate."""
    table_size, bucket = grid.table.shape
    d = src.shape[1]
    q = jnp.floor(src / voxel).astype(jnp.int32)  # (M, D)
    # 27 (3D) / 9 (2D) neighbor voxels
    off = jnp.stack(
        jnp.meshgrid(*([jnp.arange(-1, 2)] * d), indexing="ij"), axis=-1
    ).reshape(3**d, d)
    slots = _hash(q[:, None, :] + off[None, :, :], table_size)  # (M, 27)
    cand = grid.table[slots].reshape(src.shape[0], -1)  # (M, 27·B)
    valid = cand >= 0
    cand_safe = jnp.where(valid, cand, 0)
    cpts = grid.points[cand_safe]  # (M, 27B, 3)
    diff = cpts - src[:, None, :]
    d2 = jnp.sum(diff * diff, axis=-1)
    d2 = jnp.where(valid, d2, jnp.inf)
    best = jnp.argmin(d2, axis=-1)
    take = jnp.take_along_axis
    idx = take(cand_safe, best[:, None], axis=1)[:, 0]
    bd2 = take(d2, best[:, None], axis=1)[:, 0]
    return idx.astype(jnp.int32), bd2
