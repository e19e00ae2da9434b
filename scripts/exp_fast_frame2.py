"""Fast-frame A/B round 2 (after round 1 rejected hysteresis and k=4).

Round-1 findings (BASELINE.md r3): extract-hysteresis lost (cond+carry
overhead > top_k saved); normal_k=4 lost; max_iters=3 won. Round 2
measures the surviving levers:

  it3           max_iters=3 only (round-1 winner, now without hysteresis)
  it3_kf        + keyframe_trans 2.5 / rot 0.3 (halve keyframe density ->
                  halve amortized normals+insert)
  it3_ns4       + normals ref_stride=4 (shrink the 16k x 16k normals
                  distance matrix 4x at unchanged k=8)
  it3_kf_ns4    both
  it2_kf_ns4    max_iters=2 fixed (tol=0) + both

Each with ATE; levers that break ATE are rejected regardless of fps.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import numpy as np  # noqa: E402

from tpu_icp_slam.obs.compile_cache import enable as _enable_cache  # noqa: E402

_enable_cache()

import jax  # noqa: E402

from tpu_icp_slam.obs import realize  # noqa: E402

FRAMES = int(os.environ.get("FF_FRAMES", "30"))
REPEATS = int(os.environ.get("FF_REPEATS", "3"))


def _scans():
    from tpu_icp_slam.core.pointcloud import voxel_downsample_np
    from tpu_icp_slam.datasets import synthetic

    scans, gt = synthetic.velodyne_log(
        n_frames=FRAMES, n_rings=48, n_azimuth=1024,
        path_fraction=min(1.0, FRAMES / 110.0),
    )
    return [voxel_downsample_np(s, 0.15) for s in scans], gt


def _cfg(max_iters=20, tol=1e-5, tol_update=0.01, kf_trans=1.5, kf_rot=0.2,
         ref_stride=1):
    from tpu_icp_slam.config import (
        ICPConfig, MappingConfig, PipelineConfig, SlamConfig,
    )

    return SlamConfig(
        icp=ICPConfig(
            method="point_to_plane", max_iters=max_iters, max_corr_dist=1.0,
            damping=1e-3, max_step_trans=1.0, max_step_rot=0.3,
            min_inliers=100, huber_delta=0.3, tol=tol,
            step_scale=1.4, tol_update=tol_update,
        ),
        mapping=MappingConfig(
            map_capacity=131072, local_model_size=16384, map_voxel=0.2,
        ),
        pipeline=PipelineConfig(
            mode="scan_to_map", scan_capacity=16384,
            keyframe_trans=kf_trans, keyframe_rot=kf_rot,
            normal_ref_stride=ref_stride,
        ),
    )


def run_variant(name, cfg, scans, gt):
    from tpu_icp_slam.eval import metrics as em
    from tpu_icp_slam.slam.runner import pad_scans
    from tpu_icp_slam.slam.scan_to_map import ScanToMapPipeline

    pts, msk = pad_scans(scans, cfg.pipeline.scan_capacity)
    pipe = ScanToMapPipeline(cfg)
    st0 = pipe.init_state(pts[0], msk[0])
    t0 = time.perf_counter()
    st, infos = pipe.run_fused(st0, pts[1:], msk[1:])
    realize(infos["pose"])
    compile_s = time.perf_counter() - t0
    poses = np.concatenate(
        [np.eye(4)[None], np.asarray(infos["pose"], np.float64)]
    )
    gt_rel = np.einsum("ij,fjk->fik", np.linalg.inv(gt[0]), gt)
    ate = em.ate_rmse(poses[:, :3, 3], gt_rel[: len(poses), :3, 3])
    best = np.inf
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        st, infos = pipe.run_fused(st0, pts[1:], msk[1:])
        realize(infos["pose"])
        best = min(best, time.perf_counter() - t0)
    print(json.dumps({
        "variant": name,
        "fps": round((len(scans) - 1) / best, 1),
        "ms_per_frame": round(1e3 * best / (len(scans) - 1), 2),
        "ate_m": round(float(ate), 4),
        "mean_iters": round(float(np.asarray(infos["iters"]).mean()), 2),
        "keyframes": int(np.asarray(infos["is_keyframe"]).sum()),
        "compile_s": round(compile_s, 1),
    }), flush=True)


if __name__ == "__main__":
    scans, gt = _scans()
    from tpu_icp_slam.obs.bench import measurement_stamp
    print(json.dumps(measurement_stamp()), flush=True)
    print(json.dumps({"platform": jax.default_backend(), "frames": FRAMES}),
          flush=True)
    variants = {
        "it3": _cfg(max_iters=3),
        "it3_kf": _cfg(max_iters=3, kf_trans=2.5, kf_rot=0.3),
        "it3_ns4": _cfg(max_iters=3, ref_stride=4),
        "it3_kf_ns4": _cfg(max_iters=3, kf_trans=2.5, kf_rot=0.3,
                           ref_stride=4),
        "it2_kf_ns4": _cfg(max_iters=2, tol=0.0, tol_update=0.0,
                           kf_trans=2.5, kf_rot=0.3, ref_stride=4),
    }
    for name, cfg in variants.items():
        run_variant(name, cfg, scans, gt)
