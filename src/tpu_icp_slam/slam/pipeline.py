"""Per-frame SLAM pipeline (SURVEY.md §2b N12) — scan-to-scan odometry.

The reference's host-side per-frame orchestration (`slamUpdate`: preprocess →
ICP vs previous scan → compose pose → update grid; SURVEY.md §2a R3 / §3a —
mount empty, §0) becomes ONE jitted step whose entire body stays on device:
motion-model initial guess, the full ICP while_loop, pose composition, and
the occupancy-grid fold. The host only uploads the next scan.

Two execution modes (SURVEY.md §3b):
- streaming: python loop, one device dispatch per frame (a real sensor feed);
- fused: the whole log is a single `lax.scan` over a preloaded (F, C, D)
  array — one dispatch for the entire trajectory, the accelerator-idiomatic shape
  for benchmarking and batch reprocessing.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp

from tpu_icp_slam.config import SlamConfig
from tpu_icp_slam.core.pointcloud import PointCloud
from tpu_icp_slam.icp.loop import align_with_correspondence, _nn_correspondence
from tpu_icp_slam.mapping import occupancy2d


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class OdomState:
    pose: jnp.ndarray  # (D+1, D+1) world <- sensor
    T_rel: jnp.ndarray  # (D+1, D+1) last inter-frame transform (motion model)
    prev_points: jnp.ndarray  # (C, D) previous scan (padded)
    prev_mask: jnp.ndarray  # (C,)
    grid: Optional[occupancy2d.OccupancyGrid2D]  # 2D mode only
    frame: jnp.ndarray  # () int32


class OdometryPipeline:
    """Scan-to-scan ICP odometry over 2D or 3D padded scans."""

    def __init__(self, cfg: SlamConfig, dim: int):
        self.cfg = cfg
        self.dim = dim
        donate = (0,) if cfg.pipeline.donate_state else ()
        self._step = jax.jit(
            functools.partial(_step, cfg=cfg, dim=dim), donate_argnums=donate
        )
        self._fused = jax.jit(functools.partial(_fused_run, cfg=cfg, dim=dim))

    def init_state(self, first_points, first_mask, with_grid: bool = None) -> OdomState:
        d = self.dim
        if with_grid is None:
            with_grid = d == 2
        grid = None
        if with_grid:
            m = self.cfg.mapping
            grid = occupancy2d.create(m.grid_size, m.grid_resolution)
            grid = occupancy2d.update(
                grid,
                jnp.eye(3, dtype=jnp.float32),
                jnp.asarray(first_points),
                jnp.asarray(first_mask),
                hit=m.logodds_hit,
                free=m.logodds_free,
                clip=m.logodds_clip,
                ray_samples=m.ray_samples,
            )
        return OdomState(
            pose=jnp.eye(d + 1, dtype=jnp.float32),
            T_rel=jnp.eye(d + 1, dtype=jnp.float32),
            prev_points=jnp.asarray(first_points, jnp.float32),
            prev_mask=jnp.asarray(first_mask),
            grid=grid,
            frame=jnp.asarray(0, jnp.int32),
        )

    def step(self, state: OdomState, points, mask):
        """One frame: returns (new_state, info dict of device scalars/arrays)."""
        return self._step(state, jnp.asarray(points, jnp.float32), jnp.asarray(mask))

    def run_fused(self, state: OdomState, all_points, all_masks):
        """Whole log in one dispatch: (F, C, D), (F, C) -> (state, poses (F+1,...))."""
        return self._fused(state, jnp.asarray(all_points, jnp.float32), jnp.asarray(all_masks))


def _step(state: OdomState, points, mask, *, cfg: SlamConfig, dim: int):
    src = PointCloud(points=points, mask=mask)
    dst = PointCloud(points=state.prev_points, mask=state.prev_mask)
    init = (
        state.T_rel
        if cfg.pipeline.motion_model == "constant_velocity"
        else jnp.eye(dim + 1, dtype=jnp.float32)
    )
    corr = _nn_correspondence(cfg.icp, dst)
    res = align_with_correspondence(src, corr, init, cfg.icp)
    pose = state.pose @ res.T
    grid = state.grid
    if grid is not None:
        m = cfg.mapping
        grid = occupancy2d.update(
            grid,
            pose,
            points,
            mask,
            hit=m.logodds_hit,
            free=m.logodds_free,
            clip=m.logodds_clip,
            ray_samples=m.ray_samples,
        )
    new_state = OdomState(
        pose=pose,
        T_rel=res.T,
        prev_points=points,
        prev_mask=mask,
        grid=grid,
        frame=state.frame + 1,
    )
    info = {
        "pose": pose,
        "rmse": res.rmse,
        "iters": res.iters,
        "n_inliers": res.n_inliers,
        "converged": res.converged,
    }
    return new_state, info


def _fused_run(state: OdomState, all_points, all_masks, *, cfg: SlamConfig, dim: int):
    def body(st, frame):
        pts, msk = frame
        st, info = _step(st, pts, msk, cfg=cfg, dim=dim)
        return st, info

    final, infos = jax.lax.scan(body, state, (all_points, all_masks))
    return final, infos
