"""Fast-frame A/B round 3: the map-op levers (after round 2 set the
flagship config).

The remaining budget (BASELINE.md r3 decomposition): the per-frame
extract_local top_k and the keyframe insert lexsort. Variants:

  flagship      bench.py _kitti_cfg (it6 + kf2.5/0.3 + ns4)
  x_approx      + mapping.extract_approx (approx_min_k local model)
  ins_hash      + mapping.insert_backend=hash (sort-free voxel insert)
  both          + both

Each with ATE; accuracy-breaking levers are rejected.
"""

from __future__ import annotations

import dataclasses
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


def _base():
    sys.path.insert(0, os.path.join(
        os.path.dirname(os.path.abspath(__file__)), ".."))
    import bench

    return bench._kitti_cfg()


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
        "map_points": int(np.asarray(infos["map_points"])[-1]),
        "compile_s": round(compile_s, 1),
    }), flush=True)


def _mapcfg(cfg, **kw):
    return dataclasses.replace(
        cfg, mapping=dataclasses.replace(cfg.mapping, **kw)
    )


if __name__ == "__main__":
    scans, gt = _scans()
    from tpu_icp_slam.obs.bench import measurement_stamp
    print(json.dumps(measurement_stamp()), flush=True)
    print(json.dumps({"platform": jax.default_backend(), "frames": FRAMES}),
          flush=True)
    base = _base()
    variants = {
        "flagship": base,
        "x_approx": _mapcfg(base, extract_approx=True),
        "ins_hash": _mapcfg(base, insert_backend="hash"),
        "both": _mapcfg(base, extract_approx=True, insert_backend="hash"),
    }
    for name, cfg in variants.items():
        try:
            run_variant(name, cfg, scans, gt)
        except Exception as exc:  # one failing arm must not kill the A/B
            print(json.dumps({"variant": name, "error": str(exc)[:400]}),
                  flush=True)
