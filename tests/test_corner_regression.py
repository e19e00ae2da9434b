"""Corner-robustness regression gate (VERDICT r3 weak 3 / next-round 5).

The endurance lap's 90° corners are where the front-end historically died
(r3: ATE 28.7 m from one corner; r4 root cause v2: at a corner mouth,
unmapped-frontier scan points latch onto the mapped corridor boundary
inside a loose correspondence gate, and 18 per-iteration-clamped GN steps
walk the pose 4-9 m into an aliased basin, whose misplaced frame then
poisons the map). The r4 fix pair — max_corr_dist=1.0 + the total-
correction trust region (icp.max_total_trans/rot) — was calibrated on the
small-scale 200-frame lap (BASELINE.md r4 table). This test pins that
calibration in CI: a refactor that silently re-breaks corners must fail
here, not in the next endurance run on the card.

Runs the first 131 frames of the lap (through the first two corners,
~2 x 45 s on the 1-core CPU runner). Thresholds carry ~2x margin over the
measured values (good: err@125 = 5.0 m; bad: 25.2 m).
"""

import numpy as np
import pytest

from tpu_icp_slam.config import (
    BackendConfig, ICPConfig, MappingConfig, PipelineConfig, SlamConfig,
)
from tpu_icp_slam.core.pointcloud import voxel_downsample_np
from tpu_icp_slam.datasets import synthetic
from tpu_icp_slam.slam.runner import pad_scans
from tpu_icp_slam.slam.slam3d import Slam3D

# the endurance loop circuit (scripts/exp_endurance._LAP); 200-frame lap at
# ~0.95 m/frame, truncated after the second corner
_LAP = [(-40, 0), (-8, 0), (16, 0), (36, 0), (36, 16), (8, 18), (-20, 18),
        (-38, 16), (-40, 8), (-39, 1), (-30, 0.2)]
_FRAMES = 131


@pytest.fixture(scope="module")
def lap_scans():
    scans, gt = synthetic.velodyne_log(
        n_frames=200, n_rings=14, n_azimuth=288, seed=0,
        waypoints=np.asarray(_LAP, np.float64),
    )
    scans = [voxel_downsample_np(s, 0.45) for s in scans[:_FRAMES]]
    pts, msk = pad_scans(scans, 1536)
    gt_rel = np.einsum("ij,fjk->fik", np.linalg.inv(gt[0]), gt[:_FRAMES])
    return pts, msk, gt_rel


def _cfg(max_corr_dist, max_total_trans, max_total_rot):
    return SlamConfig(
        icp=ICPConfig(
            method="point_to_plane", max_iters=18,
            max_corr_dist=max_corr_dist,
            damping=1e-3, max_step_trans=1.0, max_step_rot=0.3,
            min_inliers=50, huber_delta=0.3, tol=1e-5,
            step_scale=1.4, tol_update=0.01,
            prior_trans_weight=0.004, prior_rot_weight=0.04,
            max_total_trans=max_total_trans, max_total_rot=max_total_rot,
        ),
        mapping=MappingConfig(
            map_capacity=32768, local_model_size=4096, map_voxel=0.35
        ),
        pipeline=PipelineConfig(
            mode="scan_to_map", scan_capacity=1536,
            keyframe_trans=2.5, keyframe_rot=0.3,
            normal_ref_stride=4, frontier_insert=True,
        ),
        backend=BackendConfig(enabled=False),
    )


def _err(pts, msk, gt_rel, cfg):
    poses, _ = Slam3D(cfg).run(pts, msk, mode="fused")
    return np.linalg.norm(
        poses[:, :3, 3] - gt_rel[: len(poses), :3, 3], axis=1
    )


def test_endurance_config_bounds_two_corners(lap_scans):
    """The calibrated endurance config (corr 1.0 + trust region) must track
    through both corners: measured err@125 = 5.0 m, gate at 2x margin."""
    pts, msk, gt_rel = lap_scans
    err = _err(pts, msk, gt_rel, _cfg(1.0, 1.5, 0.5))
    assert err[125] < 8.0, f"corner-exit error {err[125]:.1f} m (was 5.0)"
    assert err.max() < 11.0, f"peak error {err.max():.1f} m (was ~5.3)"


def test_known_bad_config_still_fails(lap_scans):
    """The r3-as-committed settings (corr 2.0, no trust region) measured
    25.2 m at f=125 — if this ever PASSES the corner trace, the trace has
    become too easy and the gate above proves nothing."""
    pts, msk, gt_rel = lap_scans
    err = _err(pts, msk, gt_rel, _cfg(2.0, 0.0, 0.0))
    assert err[125] > 10.0, (
        f"bad config now bounds the corners ({err[125]:.1f} m) — "
        "recalibrate the trace or tighten the good-config gate"
    )
