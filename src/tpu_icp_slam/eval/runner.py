"""`cli eval`: run the device pipeline AND the golden fp64 CPU oracle on the
same log, report ATE/RPE of each vs ground truth and vs each other — the
operative form of "ATE RMSE vs reference ICP trajectory" (BASELINE.json;
the CUDA reference being unavailable, the golden oracle stands in,
SURVEY.md §0.4)."""

from __future__ import annotations

import json

import numpy as np

from tpu_icp_slam.config import SlamConfig, from_json, override
from tpu_icp_slam.eval import golden
from tpu_icp_slam.eval import metrics as em
from tpu_icp_slam.slam.runner import load_dataset, run_slam


def eval_from_cli(args) -> int:
    cfg = SlamConfig()
    if getattr(args, "config", None):
        with open(args.config) as fh:
            cfg = from_json(fh.read())
    if getattr(args, "override_dict", None):
        cfg = override(cfg, args.override_dict)
    data = load_dataset(args.dataset, args.frames)
    poses, report = run_slam(cfg, data, out_dir=None, mode="fused")

    mcd = cfg.icp.max_corr_dist if cfg.icp.max_corr_dist < 1e8 else 1.0
    scans = data.scans
    if cfg.pipeline.downsample_voxel > 0 and scans:
        from tpu_icp_slam.core.pointcloud import voxel_downsample_np

        scans = [voxel_downsample_np(s, cfg.pipeline.downsample_voxel) for s in scans]
    d = data.dim
    out = {
        "dataset": data.name,
        "frames": int(len(poses)),
        "mode": report.get("mode", "fused"),
    }
    if scans:
        gpose = golden.odometry(scans, max_iters=30, max_corr_dist=mcd)
        out["tpu_vs_golden_ate"] = em.ate_rmse(
            poses[:, :d, d], gpose[: len(poses), :d, d]
        )
    if data.gt_poses is not None:
        gt = data.gt_poses[: len(poses)]
        out["tpu_ate"] = report.get("ate_rmse")
        if scans:
            out["golden_ate"] = em.ate_rmse(gpose[: len(gt), :d, d], gt[:, :d, d])
    for k in ("n_loop_closures", "n_keyframes"):
        if k in report:
            out[k] = report[k]
    print(json.dumps(out, indent=2))
    return 0
