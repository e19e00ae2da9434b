"""Scan-to-map SLAM pipeline (BASELINE.json config 4; SURVEY.md §2b N11/N12).

Odometry registers each scan against a *local model* extracted from the
global voxel map instead of the previous scan — drift accumulates much more
slowly because the map is the fusion of all keyframes. One jitted step per
frame (streaming) or one `lax.scan` over the whole log (fused):

  extract local model (top_k near predicted pose)
    → ICP align scan→model in the PREDICTED SENSOR frame (the local model is
      moved into the sensor frame first; world coords wreck f32 conditioning
      — see the comment at the align site), pose = prediction ∘ correction
    → keyframe gate (translation/rotation since last keyframe)
    → lax.cond: voxel-dedup insert of the world-frame scan (+ normals)

The keyframe insert runs under `lax.cond` so non-keyframe frames skip the
sort entirely. The reference had only scan-to-scan (+ occupancy grid); this
is the driver-mandated extension (SURVEY.md §2a vs §2b).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

from tpu_icp_slam.config import SlamConfig
from tpu_icp_slam.core import se3
from tpu_icp_slam.core.pointcloud import PointCloud
from tpu_icp_slam.icp.loop import _nn_correspondence, align_with_correspondence
from tpu_icp_slam.mapping import voxel_map
from tpu_icp_slam.mapping.normals import normals_knn


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class MapOdomState:
    pose: jnp.ndarray  # (4, 4) world <- sensor
    T_rel: jnp.ndarray  # (4, 4) last inter-frame motion (constant-velocity)
    last_kf_pose: jnp.ndarray  # (4, 4) pose at the last keyframe
    vmap: voxel_map.VoxelMap
    frame: jnp.ndarray  # () int32
    n_keyframes: jnp.ndarray  # () int32
    # carried local model (world frame) for extract hysteresis: re-extracted
    # only when the sensor moved > cfg.mapping.extract_hysteresis from
    # extract_center or the map changed (need_extract) — saves the
    # every-frame top_k (r3 SOL decomposition)
    loc_pts: jnp.ndarray  # (L, 3)
    loc_nrm: jnp.ndarray  # (L, 3)
    loc_msk: jnp.ndarray  # (L,) bool
    r_cover: jnp.ndarray  # () f32 coverage radius of the carried model
    extract_center: jnp.ndarray  # (3,) world position of the extraction
    need_extract: jnp.ndarray  # () bool; set after keyframe inserts


class ScanToMapPipeline:
    """3D scan-to-map ICP odometry against a voxel-deduplicated map."""

    def __init__(self, cfg: SlamConfig):
        self.cfg = cfg
        donate = (0,) if cfg.pipeline.donate_state else ()
        self._step = jax.jit(
            functools.partial(_step, cfg=cfg), donate_argnums=donate
        )
        self._fused = jax.jit(functools.partial(_fused_run, cfg=cfg))

    def init_state(self, first_points, first_mask) -> MapOdomState:
        return init_state(
            jnp.asarray(first_points, jnp.float32),
            jnp.asarray(first_mask),
            self.cfg,
        )

    def step(self, state: MapOdomState, points, mask):
        return self._step(state, jnp.asarray(points, jnp.float32), jnp.asarray(mask))

    def run_fused(self, state: MapOdomState, all_points, all_masks):
        return self._fused(
            state, jnp.asarray(all_points, jnp.float32), jnp.asarray(all_masks)
        )


def init_state(first_points, first_mask, cfg: SlamConfig) -> MapOdomState:
    """Build the frame-0 state: map seeded with the first scan, identity
    pose. Traceable (multi_seq calls it under shard_map/lax.map)."""
    m = cfg.mapping
    vm = voxel_map.create(m.map_capacity)
    nrm = normals_knn(
        first_points, first_mask, k=cfg.pipeline.normal_k,
        ref_stride=cfg.pipeline.normal_ref_stride,
        approx=cfg.pipeline.normal_approx,
        oversample=cfg.pipeline.normal_oversample,
    )
    vm = voxel_map.insert(vm, first_points, first_mask, nrm, voxel=m.map_voxel)
    size = m.local_model_size
    return MapOdomState(
        pose=jnp.eye(4, dtype=jnp.float32),
        T_rel=jnp.eye(4, dtype=jnp.float32),
        last_kf_pose=jnp.eye(4, dtype=jnp.float32),
        vmap=vm,
        frame=jnp.asarray(0, jnp.int32),
        n_keyframes=jnp.asarray(1, jnp.int32),
        loc_pts=jnp.full((size, 3), 1.0e6, jnp.float32),
        loc_nrm=jnp.zeros((size, 3), jnp.float32),
        loc_msk=jnp.zeros((size,), bool),
        r_cover=jnp.asarray(0.0, jnp.float32),
        extract_center=jnp.zeros(3, jnp.float32),
        need_extract=jnp.asarray(True),
    )


def _step(state: MapOdomState, points, mask, *, cfg: SlamConfig):
    m = cfg.mapping
    p = cfg.pipeline
    # predicted pose: damped constant-velocity motion model. Full CV (damping
    # 1.0) is UNSTABLE in a feedback loop with map-based ICP: the prediction
    # extrapolates the previous pose error, and whenever ICP recovers less
    # than ~half the init error per frame the error doubles every frame
    # (measured on the synthetic KITTI-regime log). Damping the twist breaks
    # the loop while keeping most of the basin-of-convergence benefit.
    if p.motion_model == "constant_velocity":
        alpha = p.motion_damping
        alpha_r = p.motion_damping_rot if p.motion_damping_rot >= 0 else alpha
        if alpha >= 1.0 and alpha_r >= 1.0:
            init = state.pose @ state.T_rel
        elif alpha <= 0.0 and alpha_r <= 0.0:
            init = state.pose
        else:
            xi = se3.log(state.T_rel)
            # split damping: rotation under-prediction starves sharp
            # corners (see PipelineConfig.motion_damping_rot); the r2
            # instability that motivated damping is translational
            scale = jnp.concatenate([
                jnp.full(3, alpha, xi.dtype), jnp.full(3, alpha_r, xi.dtype)
            ])
            init = state.pose @ se3.exp(scale * xi)
    else:
        init = state.pose
    center = init[:3, 3]
    if m.extract_hysteresis > 0.0:
        # reuse the carried local model while fresh enough; the coverage
        # gate below shrinks by the staleness offset so correctness holds
        moved = (
            jnp.linalg.norm(center - state.extract_center)
            > m.extract_hysteresis
        )
        need = jnp.logical_or(state.need_extract, moved)
        loc_pts, loc_nrm, loc_msk, r_cover, ex_center = jax.lax.cond(
            need,
            lambda: (
                *voxel_map.extract_local(
                    state.vmap, center, m.local_model_size,
                    approx=m.extract_approx,
                ),
                center,
            ),
            lambda: (
                state.loc_pts, state.loc_nrm, state.loc_msk,
                state.r_cover, state.extract_center,
            ),
        )
        stale_off = jnp.linalg.norm(center - ex_center)
    else:
        loc_pts, loc_nrm, loc_msk, r_cover = voxel_map.extract_local(
            state.vmap, center, m.local_model_size, approx=m.extract_approx
        )
        ex_center = center
        stale_off = jnp.asarray(0.0, jnp.float32)
    # Align in the PREDICTED SENSOR frame, not world: world coordinates grow
    # with travelled distance, wrecking f32 conditioning (the p×n Jacobian
    # block scales with |p|, and the factored NN distance cancels ~|p|²ε).
    # Transform the small local model once; the hot loop then sees O(scene)
    # magnitudes and the ICP correction starts at identity.
    init_inv = se3.inverse(init)
    loc_local = loc_pts @ init_inv[:3, :3].T + init_inv[:3, 3]
    loc_local = jnp.where(loc_msk[:, None], loc_local, 1.0e6)
    nrm_local = loc_nrm @ init_inv[:3, :3].T
    dst = PointCloud(
        points=loc_local,
        mask=loc_msk,
        normals=nrm_local if cfg.icp.method == "point_to_plane" else None,
    )
    src = PointCloud(points=points, mask=mask)
    # coverage gate: scan points beyond the local model's radius have no
    # genuine counterpart and would latch onto the model boundary, dragging
    # the solve — zero their weight instead (sensor origin ≈ model center)
    # stale_off: with hysteresis the model is centered up to that far from
    # the sensor, so the guaranteed-coverage radius shrinks by it
    r_gate = jnp.maximum(r_cover - stale_off - cfg.icp.max_corr_dist, 0.0)
    nn_corr = _nn_correspondence(cfg.icp, dst)

    def corr(cur_pts):
        q, n, gate, d2 = nn_corr(cur_pts)
        in_cover = jnp.sum(cur_pts * cur_pts, axis=-1) <= r_gate * r_gate
        return q, n, gate * in_cover.astype(gate.dtype), d2

    res = align_with_correspondence(src, corr, None, cfg.icp)
    pose = init @ res.T  # world pose = prediction ∘ sensor-frame correction
    T_rel = se3.inverse(state.pose) @ pose

    # trust-region binding flag (post-hoc): the align runs in the predicted
    # sensor frame with identity init, so ‖log(res.T)‖ sitting ON the
    # max_total_trans/rot ball means the projection clamped the correction
    # — the solver wanted to go further. Endurance forensics (BASELINE.md
    # r5b) show constant-radius walk-off segments that are iteration-strain
    # silent; this flag is the signal that catches them
    # (BackendConfig.strain_on_clamp feeds it into odometry factor weights).
    ic = cfg.icp
    clamped = jnp.asarray(False)
    if ic.max_total_trans > 0.0 or ic.max_total_rot > 0.0:
        xi_corr = se3.log(res.T)
        if ic.max_total_trans > 0.0:
            clamped = (jnp.linalg.norm(xi_corr[:3])
                       >= 0.995 * ic.max_total_trans)
        if ic.max_total_rot > 0.0:
            clamped = jnp.logical_or(
                clamped,
                jnp.linalg.norm(xi_corr[3:]) >= 0.995 * ic.max_total_rot,
            )

    dK = se3.inverse(state.last_kf_pose) @ pose
    trans = jnp.linalg.norm(dK[:3, 3])
    rot = se3.rotation_geodesic(dK[:3, :3], jnp.eye(3, dtype=dK.dtype))
    moved = jnp.logical_or(trans > p.keyframe_trans, rot > p.keyframe_rot)
    # map-hygiene gate: a poorly-converged or low-inlier registration must
    # never write to the map — misplaced keyframes are what later frames
    # align against, so one bad insert compounds into runaway drift.
    # Denominator = points the gate could POSSIBLY accept: valid AND within
    # the model's coverage radius at the converged pose. Points looking
    # into unexplored space can never be inliers; counting them starved
    # keyframes exactly at corners (r3 endurance trace: at the circuit's
    # first 90° turn ~half the scan faces unmapped corridor, inlier frac
    # 0.28 < 0.30 → no keyframe → frontier frozen → pose never turns,
    # ATE 28.7 m; with the testable-set denominator the corner frames are
    # 70%+ healthy and the map follows the turn).
    cur_aligned = points @ res.T[:3, :3].T + res.T[:3, 3]
    in_cov = jnp.sum(cur_aligned * cur_aligned, axis=-1) <= r_gate * r_gate
    n_total = jnp.maximum(jnp.sum(mask.astype(jnp.int32)), 1)
    n_valid = jnp.maximum(
        jnp.sum(jnp.logical_and(mask, in_cov).astype(jnp.int32)), 1
    )
    # ...but a pose so lost that almost nothing is testable must not count
    # as healthy either (a teleported pose can align a tiny sliver well):
    # require at least 10% of the scan inside coverage
    enough_testable = n_valid * 10 >= n_total
    # "converged" alone is too strict at turns (max_iters exhausted while the
    # registration is still good); an absolute rmse bound keeps coverage
    # extending exactly where the motion is hardest
    quality = jnp.logical_or(res.converged, res.rmse < p.keyframe_max_rmse)
    healthy = jnp.logical_and(
        jnp.logical_and(quality, enough_testable),
        res.n_inliers >= (n_valid * p.keyframe_min_inlier_frac).astype(jnp.int32),
    )
    is_kf = jnp.logical_and(moved, healthy)
    # frontier-pressure map insert (decoupled from keyframe REGISTRATION:
    # is_kf still gates the backend DB / last_kf_pose cadence): healthy
    # frames also insert when coverage is collapsing or mid-turn, so the
    # frontier follows the sensor through corners (see PipelineConfig)
    if p.frontier_insert:
        pressure = jnp.logical_or(
            n_valid < n_total * p.frontier_cov_frac,
            rot > 0.5 * p.keyframe_rot,
        )
        # require some motion so a parked sensor doesn't re-insert
        moved_a_bit = jnp.logical_or(trans > 0.3, rot > 0.05)
        is_map_insert = jnp.logical_and(
            healthy, jnp.logical_or(moved, jnp.logical_and(pressure,
                                                           moved_a_bit))
        )
    else:
        is_map_insert = is_kf

    def do_insert(vm):
        world_pts = points @ pose[:3, :3].T + pose[:3, 3]
        world_pts = jnp.where(mask[:, None], world_pts, 1.0e6)
        nrm = normals_knn(
            points, mask, k=p.normal_k, ref_stride=p.normal_ref_stride,
            approx=p.normal_approx, oversample=p.normal_oversample,
        ) @ pose[:3, :3].T
        # spatial eviction around the current pose (see voxel_map.insert)
        ins = (
            voxel_map.insert_hash
            if m.insert_backend == "hash"
            else voxel_map.insert
        )
        return ins(
            vm, world_pts, mask, nrm, voxel=m.map_voxel, center=pose[:3, 3]
        )

    vm = jax.lax.cond(is_map_insert, do_insert, lambda v: v, state.vmap)
    new_state = MapOdomState(
        pose=pose,
        T_rel=T_rel,
        last_kf_pose=jnp.where(is_kf, pose, state.last_kf_pose),
        vmap=vm,
        frame=state.frame + 1,
        n_keyframes=state.n_keyframes + is_kf.astype(jnp.int32),
        loc_pts=loc_pts,
        loc_nrm=loc_nrm,
        loc_msk=loc_msk,
        r_cover=r_cover,
        extract_center=ex_center,
        need_extract=is_map_insert,  # map changed -> re-extract next frame
    )
    info = {
        "pose": pose,
        "rmse": res.rmse,
        "iters": res.iters,
        "n_inliers": res.n_inliers,
        "converged": res.converged,
        "clamped": clamped,
        "is_keyframe": is_kf,
        "map_inserted": is_map_insert,
        "map_points": voxel_map.count(vm),
    }
    return new_state, info


def _fused_run(state: MapOdomState, all_points, all_masks, *, cfg: SlamConfig):
    def body(st, frame):
        pts, msk = frame
        return _step(st, pts, msk, cfg=cfg)

    return jax.lax.scan(body, state, (all_points, all_masks))
