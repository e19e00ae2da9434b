"""2D log-odds occupancy grid (SURVEY.md §2b N10).

The vectorized equivalent of the reference's occupancy-grid CUDA kernel
(SURVEY.md §2a R9; mount empty, §0). Design: instead of per-thread Bresenham
ray traversal (divergent, scatter-heavy), each beam contributes K evenly
spaced free-space samples along the ray plus its endpoint hit — everything is
two fused scatter-adds over static shapes, jit/vmap-friendly, with
out-of-bounds updates dropped by XLA scatter semantics.

Approximation note: a cell crossed by several samples of one beam gets
multiple free-space decrements. With K * resolution ≈ max_range the sample
spacing ≈ one cell, so the bias is small and uniform; the same trade is
standard in vectorized occupancy mappers.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class OccupancyGrid2D:
    logodds: jnp.ndarray  # (H, W) float32
    origin: jnp.ndarray  # (2,) world coords of cell (0, 0) corner
    resolution: jnp.ndarray  # () meters per cell


def create(
    size: int, resolution: float, center: tuple[float, float] = (0.0, 0.0)
) -> OccupancyGrid2D:
    half = size * resolution / 2.0
    origin = jnp.asarray(
        [center[0] - half, center[1] - half], dtype=jnp.float32
    )
    return OccupancyGrid2D(
        logodds=jnp.zeros((size, size), jnp.float32),
        origin=origin,
        resolution=jnp.asarray(resolution, jnp.float32),
    )


def world_to_cell(grid: OccupancyGrid2D, pts: jnp.ndarray) -> jnp.ndarray:
    """(N, 2) world -> (N, 2) int32 cell indices (iy, ix)."""
    rel = (pts - grid.origin) / grid.resolution
    ij = jnp.floor(rel).astype(jnp.int32)
    return jnp.flip(ij, axis=-1)  # (ix, iy) -> (iy, ix)


def update(
    grid: OccupancyGrid2D,
    pose: jnp.ndarray,  # (3, 3) SE(2): world <- sensor
    points: jnp.ndarray,  # (B, 2) hit endpoints in sensor frame
    mask: jnp.ndarray,  # (B,) bool: real hit
    hit: float = 0.9,
    free: float = -0.4,
    clip: float = 10.0,
    ray_samples: int = 128,
) -> OccupancyGrid2D:
    """Fold one registered scan into the grid (pure function — returns new grid)."""
    h, w = grid.logodds.shape
    sensor = pose[:2, 2]  # world-frame sensor origin
    pts_w = points @ pose[:2, :2].T + sensor  # (B, 2)
    mf = mask.astype(jnp.float32)

    # ---- hit cells: one scatter-add per beam ----
    cells = world_to_cell(grid, pts_w)  # (B, 2) (iy, ix)
    in_bounds = (
        (cells[:, 0] >= 0) & (cells[:, 0] < h) & (cells[:, 1] >= 0) & (cells[:, 1] < w)
    )
    hit_vals = mf * in_bounds * hit
    lo = grid.logodds.at[cells[:, 0], cells[:, 1]].add(hit_vals, mode="drop")

    # ---- free-space: K samples strictly inside each ray ----
    # stop 1.5 cells short of the endpoint so the hit cell is never
    # decremented by its own beam (worst-case diagonal crossing is sqrt(2))
    ray = pts_w - sensor  # (B, 2)
    ray_len = jnp.linalg.norm(ray, axis=-1)
    u_stop = jnp.clip(1.0 - 1.5 * grid.resolution / jnp.maximum(ray_len, 1e-6), 0.0, 1.0)
    u = (jnp.arange(ray_samples, dtype=jnp.float32) + 0.5) / ray_samples
    u_scaled = u[None, :] * u_stop[:, None]  # (B, K)
    sample_pts = sensor + u_scaled[:, :, None] * ray[:, None, :]  # (B, K, 2)
    scells = world_to_cell(grid, sample_pts.reshape(-1, 2))  # (B*K, 2)
    sin_b = (
        (scells[:, 0] >= 0) & (scells[:, 0] < h) & (scells[:, 1] >= 0) & (scells[:, 1] < w)
    )
    # only samples closer than the endpoint count (they all are by construction)
    svals = jnp.repeat(mf, ray_samples) * sin_b * free
    lo = lo.at[scells[:, 0], scells[:, 1]].add(svals, mode="drop")

    lo = jnp.clip(lo, -clip, clip)
    return dataclasses.replace(grid, logodds=lo)


def to_probability(grid: OccupancyGrid2D) -> jnp.ndarray:
    return jax.nn.sigmoid(grid.logodds)


def render_png(grid: OccupancyGrid2D, path: str, trajectory=None) -> None:
    """Host-side artifact render — the headless stand-in for the reference's
    GL window (SURVEY.md §2c, R2 row): free cells white, occupied black,
    trajectory red; one pixel per cell."""
    import numpy as np

    from tpu_icp_slam.obs.png import draw_path, write_png

    p = np.asarray(to_probability(grid))  # [row = y, col = x]
    gray = (255.0 * (1.0 - p)).astype(np.uint8)[::-1]  # y up
    img = np.repeat(gray[:, :, None], 3, axis=2)
    if trajectory is not None:
        draw_path(img, np.asarray(trajectory, np.float64)[:, :2],
                  np.asarray(grid.origin, np.float64), float(grid.resolution))
    write_png(path, img)
