"""Full-scale lap calibration sweep (r4): the small-scale corner fix did
not transfer to flagship scale (lap_eval: odometry ATE 18.5 m vs 3.9 at
small scale). Arms:

- correspondence gate relative to voxel size: corr 1.0 m is 2.9 voxels at
  small scale (0.35 m) but 5 voxels at flagship (0.2 m) — relatively
  looser, the boundary-latch drag regime.
- NN backend (the Triton kernel vs XLA's chunked version; both select the
  exact f32 nearest neighbour) and normals (exact top_k vs the oversampled
  approx_min_k path).

Each arm: 200-frame / 212 m lap, odometry-only, fused dispatch, host
readback. Reports err@125 (two corners in), max err, rotation error.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from tpu_icp_slam.obs.compile_cache import enable as _enable_cache  # noqa: E402

_enable_cache()

import numpy as np  # noqa: E402
import jax  # noqa: E402

_LAP = [(-40, 0), (-8, 0), (16, 0), (36, 0), (36, 16), (8, 18), (-20, 18),
        (-38, 16), (-40, 8), (-39, 1), (-30, 0.2)]
FRAMES = int(os.environ.get("LAP_SWEEP_FRAMES", "200"))


def main() -> int:
    from tpu_icp_slam.config import (
        BackendConfig, ICPConfig, MappingConfig, PipelineConfig, SlamConfig,
    )
    from tpu_icp_slam.core.pointcloud import voxel_downsample_np
    from tpu_icp_slam.datasets import synthetic
    from tpu_icp_slam.slam.runner import pad_scans
    from tpu_icp_slam.slam.slam3d import Slam3D

    scans, gt = synthetic.velodyne_log(
        n_frames=FRAMES, n_rings=48, n_azimuth=1024, seed=0,
        waypoints=np.asarray(_LAP, np.float64),
    )
    scans = [voxel_downsample_np(s, 0.15) for s in scans]
    pts, msk = pad_scans(scans, 16384)
    gt_rel = np.einsum("ij,fjk->fik", np.linalg.inv(gt[0]), gt)
    from tpu_icp_slam.obs.bench import measurement_stamp
    print(json.dumps(measurement_stamp()), flush=True)
    print(json.dumps({"platform": jax.default_backend(), "frames": FRAMES,
                      "mean_pts": int(np.mean([len(s) for s in scans]))}),
          flush=True)

    def run(tag, corr, trust=1.5, normal_approx=True,
            nn_backend="auto", normal_oversample=0, map_voxel=0.2):
        cfg = SlamConfig(
            icp=ICPConfig(
                method="point_to_plane", max_iters=18, max_corr_dist=corr,
                damping=1e-3, max_step_trans=1.0, max_step_rot=0.3,
                min_inliers=100, huber_delta=0.3, tol=1e-5,
                step_scale=1.4, tol_update=0.01, nn_backend=nn_backend,
                prior_trans_weight=0.004, prior_rot_weight=0.04,
                max_total_trans=trust, max_total_rot=0.5,
            ),
            mapping=MappingConfig(map_capacity=131072,
                                  local_model_size=16384,
                                  map_voxel=map_voxel),
            pipeline=PipelineConfig(
                mode="scan_to_map", scan_capacity=16384,
                keyframe_trans=2.5, keyframe_rot=0.3, normal_ref_stride=4,
                normal_approx=normal_approx,
                normal_oversample=normal_oversample,
            ),
            backend=BackendConfig(enabled=False),
        )
        t0 = time.perf_counter()
        try:
            poses, _ = Slam3D(cfg).run(pts, msk, mode="fused")
        except Exception as exc:
            print(json.dumps({"tag": tag, "error": str(exc)[:300]}),
                  flush=True)
            return
        wall = time.perf_counter() - t0
        err = np.linalg.norm(
            poses[:, :3, 3] - gt_rel[: len(poses), :3, 3], axis=1)
        rot = []
        for f in range(len(poses)):
            dR = poses[f][:3, :3] @ gt_rel[f][:3, :3].T
            rot.append(np.degrees(
                np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1))))
        print(json.dumps({
            "tag": tag, "wall_s": round(wall, 1),
            "err@125": round(float(err[125]), 2),
            "err_final": round(float(err[-1]), 2),
            "err_max": round(float(err.max()), 2),
            "rot_max_deg": round(float(max(rot)), 1),
        }), flush=True)

    only = os.environ.get("LAP_SWEEP_ONLY")
    # a CPU control (exact NN + exact normals) bounds the two-corner trace
    # at err@125=4.8 with corr 1.0 and DIVERGES at 0.6 (rotation envelope)
    arms = {
        "corr1.0": dict(corr=1.0),  # the flagship settings
        "corr1.0_exn": dict(corr=1.0, normal_approx=False),  # exact normals
        "corr1.0_xla_exn": dict(corr=1.0, normal_approx=False,
                                nn_backend="xla"),
        "corr1.0_ovs": dict(corr=1.0, normal_oversample=4),
        "corr1.0_xla_ovs": dict(corr=1.0, nn_backend="xla",
                                normal_oversample=4),
        # gate x voxel-ratio isolation (VERDICT r4 item 6): small scale
        # bounds at 4.6 m final with corr/voxel = 1.0/0.35 = 2.9; the
        # flagship ratio is 1.0/0.2 = 5. If the RATIO is the residual
        # mechanism, matching it at full scale (voxel 0.35) should close
        # toward the small-scale 2.2%-of-distance bound, and tightening
        # corr at voxel 0.2 should move the same direction (0.7 is above
        # the 0.6 rotation-envelope divergence measured on CPU).
        "corr0.7_exn": dict(corr=0.7, normal_approx=False),
        "vox0.35_exn": dict(corr=1.0, normal_approx=False, map_voxel=0.35),
    }
    for tag, kw in arms.items():
        if only and tag not in only.split(","):
            continue
        run(tag, **kw)
    return 0


if __name__ == "__main__":
    sys.exit(main())
