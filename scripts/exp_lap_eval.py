"""Lap-scale accuracy evaluation: odometry vs backend vs golden oracle.

VERDICT r3 items 4 & 6 in one artifact. Runs the 200-frame endurance lap
(212 m loop circuit) three ways and reports:

  1. pipeline odometry-only (backend disabled)        -> ATE vs GT
  2. pipeline + backend (closures + pose graph)       -> ATE vs GT,
     closure acceptance stats, closure_confidence summary
  3. golden fp64 CPU ICP odometry (eval/golden.py)    -> ATE vs GT

plus the driver's literal metric: pipeline trajectory vs the golden
"reference ICP trajectory" (ATE between the two estimates).

Scale via LAP_SCALE=small (default; 1-core CPU-feasible) or full (GPU).
Config = the r4-calibrated endurance settings (exp_endurance.py).
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import numpy as np  # noqa: E402

from tpu_icp_slam.obs.compile_cache import enable as _enable_cache  # noqa: E402

_enable_cache()

import jax  # noqa: E402

if os.environ.get("LAP_CPU"):
    jax.config.update("jax_platforms", "cpu")

SMALL = os.environ.get("LAP_SCALE", "small") == "small"
FRAMES = int(os.environ.get("LAP_FRAMES", "200"))

_LAP = [(-40, 0), (-8, 0), (16, 0), (36, 0), (36, 16), (8, 18), (-20, 18),
        (-38, 16), (-40, 8), (-39, 1), (-30, 0.2)]


def _cfg(backend_on: bool):
    from tpu_icp_slam.config import (
        BackendConfig, ICPConfig, MappingConfig, PipelineConfig, SlamConfig,
    )

    return SlamConfig(
        icp=ICPConfig(
            method="point_to_plane", max_iters=18,
            # LAP_CORR: gate-x-voxel-ratio cross-check (VERDICT r4 item 6)
            # — at small scale (voxel 0.35) corr 1.75 reproduces the
            # flagship's corr/voxel ratio of 5
            max_corr_dist=float(os.environ.get("LAP_CORR", "1.0")),
            damping=1e-3, max_step_trans=1.0, max_step_rot=0.3,
            min_inliers=50 if SMALL else 100, huber_delta=0.3, tol=1e-5,
            step_scale=1.4, tol_update=0.01,
            nn_backend=os.environ.get("LAP_NN", "auto"),
            prior_trans_weight=0.004, prior_rot_weight=0.04,
            max_total_trans=1.5, max_total_rot=0.5,
        ),
        mapping=(
            MappingConfig(map_capacity=32768, local_model_size=4096,
                          map_voxel=float(os.environ.get("LAP_VOXEL", "0"))
                          or 0.35)
            if SMALL else
            # LAP_LMS: local-model-size lever (scripts/exp_local_model.py
            # gates this arm — coverage risk shows at corners, not straights)
            MappingConfig(map_capacity=131072,
                          local_model_size=int(
                              os.environ.get("LAP_LMS", "16384")),
                          map_voxel=float(os.environ.get("LAP_VOXEL", "0"))
                          or 0.2)
        ),
        pipeline=PipelineConfig(
            mode="scan_to_map", scan_capacity=1536 if SMALL else 16384,
            keyframe_trans=2.5, keyframe_rot=0.3, normal_ref_stride=4,
            normal_approx=int(os.environ.get("LAP_NOVS", "8")) > 1,
            normal_oversample=int(os.environ.get("LAP_NOVS", "8")),
        ),
        backend=BackendConfig(
            enabled=backend_on, min_loop_separation=25, gating_radius=20.0,
            verify_max_dev=4.0, verify_drift_rate=0.08, max_keyframes=512,
            # r5 backend-cost levers (defaults preserve the r4 baseline;
            # set for A/B): LAP_VSTRIDE / LAP_VYAWS / LAP_DEDUP
            verify_stride=int(os.environ.get("LAP_VSTRIDE", "1")),
            verify_yaws=int(os.environ.get("LAP_VYAWS", "8")),
            closure_dedup_kf=int(os.environ.get("LAP_DEDUP", "0")),
        ),
    )


def main() -> int:
    from tpu_icp_slam.core.pointcloud import voxel_downsample_np
    from tpu_icp_slam.datasets import synthetic
    from tpu_icp_slam.eval import golden, metrics as em
    from tpu_icp_slam.slam.runner import pad_scans
    from tpu_icp_slam.slam.slam3d import Slam3D

    rings, azim, dsv = (14, 288, 0.45) if SMALL else (48, 1024, 0.15)
    # LAP_DSV: scan-voxel override at full scale — the scan-DENSITY arm of
    # the item-6 residual chase (DESIGN.md §18 r5d verdict): full-scale
    # geometry/sensor with small-scale-class point budgets isolates scan
    # density as the last untried single factor
    # LAP_RINGS/LAP_AZIM: sensor angular-sampling override — after density
    # was refuted (BASELINE.md r5d), the sensor pattern (ring spacing /
    # grazing geometry) is the last cross-scale difference standing
    if not SMALL:
        dsv = float(os.environ.get("LAP_DSV", "0")) or dsv
        rings = int(os.environ.get("LAP_RINGS", "0")) or rings
        azim = int(os.environ.get("LAP_AZIM", "0")) or azim
    scans, gt = synthetic.velodyne_log(
        n_frames=FRAMES, n_rings=rings, n_azimuth=azim, seed=0,
        waypoints=np.asarray(_LAP, np.float64),
    )
    scans = [voxel_downsample_np(s, dsv) for s in scans]
    gt_rel = np.einsum("ij,fjk->fik", np.linalg.inv(gt[0]), gt)
    cap = 1536 if SMALL else 16384
    pts, msk = pad_scans(scans, cap)

    def gt_stats(poses):
        err = np.linalg.norm(
            poses[:, :3, 3] - gt_rel[: len(poses), :3, 3], axis=1)
        return {
            "ate_vs_gt": round(float(em.ate_rmse(
                poses[:, :3, 3], gt_rel[: len(poses), :3, 3])), 3),
            "err_final": round(float(err[-1]), 2),
            "err_max": round(float(err.max()), 2),
        }

    from tpu_icp_slam.obs.bench import measurement_stamp

    print(json.dumps(measurement_stamp()), flush=True)

    report = {"platform": jax.default_backend(), "frames": FRAMES,
              "scale": "small" if SMALL else "full"}

    t0 = time.perf_counter()
    odo_poses, _ = Slam3D(_cfg(False)).run(pts, msk, mode="fused")
    report["odometry"] = {**gt_stats(odo_poses),
                          "wall_s": round(time.perf_counter() - t0, 1)}
    print(json.dumps({"odometry": report["odometry"]}), flush=True)

    t0 = time.perf_counter()
    slam = Slam3D(_cfg(True))
    bk_poses, rep = slam.run(pts, msk, mode="fused")
    report["backend"] = {
        **gt_stats(bk_poses),
        "wall_s": round(time.perf_counter() - t0, 1),
        "candidates": rep.n_loop_candidates,
        "closures": rep.n_loop_closures,
        "rejected": rep.n_loops_rejected,
        "suspect": rep.n_suspect_closures,
    }
    print(json.dumps({"backend": report["backend"]}), flush=True)

    if os.environ.get("LAP_NO_GOLDEN"):  # isolation arms: the fp64 oracle
        # leg costs 10-20 CPU-min and is already on record for this regime
        # (BASELINE.md lap-scale golden rows) — skip for sweep arms that
        # only compare pipeline configs against GT
        print(json.dumps({"golden": "skipped (LAP_NO_GOLDEN)"}), flush=True)
    else:
        t0 = time.perf_counter()
        g_poses = golden.odometry(scans, max_iters=30)
        report["golden"] = {**gt_stats(np.asarray(g_poses)),
                            "wall_s": round(time.perf_counter() - t0, 1)}
        # the driver's literal metric: our trajectory vs the golden ref
        n = min(len(bk_poses), len(g_poses))
        report["pipeline_vs_golden_ate"] = round(float(em.ate_rmse(
            bk_poses[:n, :3, 3], np.asarray(g_poses)[:n, :3, 3])), 3)
        print(json.dumps({"golden": report["golden"],
                          "pipeline_vs_golden_ate":
                              report["pipeline_vs_golden_ate"]}), flush=True)

    out_dir = os.environ.get("LAP_OUT", "/tmp/lap_eval")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "lap_eval.json"), "w") as fh:
        json.dump(report, fh, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
