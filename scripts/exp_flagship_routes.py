"""Which synthetic route makes the flagship revisit a place within its
loop-candidate gate at full KITTI width?

Runs `configs/kitti_full_res.json` (scan-to-map + loop closure + pose graph)
through Slam3D on a few seeded routes at 48 rings × 1,024 azimuths and
prints, per route: ATE, final error, keyframes, loop candidates verified and
closures accepted. One GPU.

    python scripts/exp_flagship_routes.py
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import numpy as np  # noqa: E402

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def _semi(cx, cy, r, sign):
    return [(cx + sign * r * np.cos(a), cy + r * np.sin(a))
            for a in np.linspace(-np.pi / 2, np.pi / 2, 7)]


ROUTES = {
    # the built-in loop circuit (~190 m, four corners)
    "loop170": (None, 170),
    # out along one corridor lane, a 4 m-radius U-turn, back along the
    # other lane 8 m away (~125 m)
    "lanes110": ([(-36, -4), (20, -4)] + _semi(20, 0, 4, +1)
                 + [(20, 4), (-36, 4)], 110),
    # the compact loop of scripts/exp_loop.py (~100 m)
    "compact90": ([(-36, -4), (-12, -4), (-4, -4), (-2, 2), (-4, 13),
                   (-20, 13), (-34, 12), (-38, 4), (-35, -3.6), (-28, -4)], 90),
}


def main() -> int:
    from tpu_icp_slam.config import from_json
    from tpu_icp_slam.core.pointcloud import voxel_downsample_np
    from tpu_icp_slam.datasets import synthetic
    from tpu_icp_slam.eval import metrics as em
    from tpu_icp_slam.obs.compile_cache import enable
    from tpu_icp_slam.slam.runner import pad_scans
    from tpu_icp_slam.slam.slam3d import Slam3D

    enable()
    with open(os.path.join(REPO, "configs", "kitti_full_res.json")) as fh:
        cfg = from_json(fh.read())
    names = os.environ.get("ROUTES", ",".join(ROUTES)).split(",")
    for name in names:
        wps, frames = ROUTES[name]
        kw = ({"loop": True} if wps is None
              else {"waypoints": np.asarray(wps, np.float64)})
        scans, gt = synthetic.velodyne_log(n_frames=frames, seed=0, n_rings=48,
                                           n_azimuth=1024, **kw)
        gt = np.einsum("ij,fjk->fik", np.linalg.inv(gt[0]), gt)
        ds = [voxel_downsample_np(s, cfg.pipeline.downsample_voxel)
              for s in scans]
        pts, msk = pad_scans(ds, cfg.pipeline.scan_capacity)
        t0 = time.perf_counter()
        poses, rep = Slam3D(cfg).run(pts, msk)
        wall = time.perf_counter() - t0
        err = np.linalg.norm(poses[:, :3, 3] - gt[:, :3, 3], axis=1)
        path = float(np.sum(np.linalg.norm(np.diff(gt[:, :3, 3], axis=0),
                                           axis=1)))
        print(json.dumps({
            "route": name, "frames": frames, "path_m": round(path, 1),
            "ate_m": em.ate_rmse(poses[:, :3, 3], gt[:, :3, 3]),
            "err_final_m": float(err[-1]), "err_max_m": float(err.max()),
            "rpe": em.rpe(poses, gt), "keyframes": rep.n_keyframes,
            "candidates": rep.n_loop_candidates,
            "closures": rep.n_loop_closures, "wall_s": wall,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
