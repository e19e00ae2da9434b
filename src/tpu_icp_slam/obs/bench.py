"""Benchmark harness (SURVEY.md §2b N19) behind `cli bench`.

One subcommand per BASELINE.json config rung:
  1  single align, 4k points (the reference's headline microbench regime)
  2  2D lidar fused pipeline frames/s
  3  RGB-D projective fused odometry frames/s
  4  scan-to-map fused pipeline frames/s (the KITTI regime; repo-root
     bench.py wraps this same measurement for the driver)
  5  scaling harness: batched point-sharded ICP over growing device counts;
     reports throughput per device count and parallel efficiency

Measurement rules (BASELINE.md): steady-state wall time around the jitted
step, compile/warmup excluded, best of `repeats`, device count + platform
recorded.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np


def measurement_stamp(allow_dirty: bool | None = None) -> dict:
    """Git SHA + dirty flag for every recorded perf/accuracy row.

    The r3 lap record was invalidated because it was taken with uncommitted
    local state (BASELINE.md "measurement rules" say record the SHA, but
    nothing enforced it — VERDICT r4 weak 4). This is the rule as code:
    every exp_* harness and bench.py merges this dict into each JSON row.
    A dirty tree raises unless ALLOW_DIRTY_BENCH=1 (or allow_dirty=True),
    in which case the row is loudly marked {"git_dirty": true} so it can
    never masquerade as a reproducible record.
    """
    import subprocess

    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    try:
        sha = subprocess.run(
            ["git", "-C", root, "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=10,
        ).stdout.strip()
        dirty = bool(subprocess.run(
            ["git", "-C", root, "status", "--porcelain"],
            capture_output=True, text=True, timeout=10,
        ).stdout.strip())
    except Exception:
        return {"git_sha": "unknown", "git_dirty": None}
    if allow_dirty is None:
        allow_dirty = os.environ.get("ALLOW_DIRTY_BENCH") == "1"
    if dirty and not allow_dirty:
        raise RuntimeError(
            "refusing to record a measurement from a dirty tree (the r3 "
            "phantom-lap lesson): commit first, or set ALLOW_DIRTY_BENCH=1 "
            "to record a row loudly marked git_dirty=true"
        )
    return {"git_sha": sha or "unknown", "git_dirty": dirty}


def _steady(fn, repeats: int = 3) -> float:
    from tpu_icp_slam.obs import realize

    realize(fn())  # compile + warmup
    best = np.inf
    for _ in range(repeats):
        t0 = time.perf_counter()
        realize(fn())
        best = min(best, time.perf_counter() - t0)
    return best


def bench_align(n: int = 4096, repeats: int = 3) -> dict:
    import jax.numpy as jnp

    from tpu_icp_slam.config import ICPConfig
    from tpu_icp_slam.core import pointcloud as pcm
    from tpu_icp_slam.datasets import synthetic
    from tpu_icp_slam.icp import align

    src, dst, _ = synthetic.two_scan_pair(n=n, seed=0)
    cs, cd = pcm.make(src, n), pcm.make(dst, n)
    cfg = ICPConfig(max_iters=30)
    dt = _steady(lambda: align(cs, cd, cfg=cfg).T, repeats)
    return {"metric": "align_4k_solves_per_s", "value": round(1.0 / dt, 2),
            "unit": "solves/s", "n_points": n}


def _fused_frames(kind: str, frames: int, repeats: int) -> dict:
    from tpu_icp_slam.config import (
        ICPConfig, MappingConfig, PipelineConfig, SlamConfig,
    )
    from tpu_icp_slam.core.pointcloud import voxel_downsample_np
    from tpu_icp_slam.datasets import synthetic
    from tpu_icp_slam.slam.runner import pad_scans

    if kind == "2d":
        log = synthetic.lidar2d_log(n_frames=frames, n_beams=360)
        scans = [
            synthetic.scan_to_points(log.ranges[i], log.angles, log.max_range)
            for i in range(frames)
        ]
        cfg = SlamConfig(pipeline=PipelineConfig(scan_capacity=512))
        pts, msk = pad_scans(scans, 512)
        from tpu_icp_slam.slam.pipeline import OdometryPipeline

        pipe = OdometryPipeline(cfg, dim=2)
        state = pipe.init_state(pts[0], msk[0])
        dt = _steady(
            lambda: pipe.run_fused(state, pts[1:], msk[1:])[1]["pose"], repeats
        )
        name = "lidar2d_frames_per_s"
    elif kind == "rgbd":
        depths, _, K = synthetic.rgbd_log(n_frames=frames)
        from tpu_icp_slam.icp.projective import CameraIntrinsics
        from tpu_icp_slam.slam.rgbd import RGBDOdometry

        cfg = SlamConfig(icp=ICPConfig(method="point_to_plane"))
        pipe = RGBDOdometry(
            cfg,
            CameraIntrinsics(fx=K.fx, fy=K.fy, cx=K.cx, cy=K.cy,
                             width=K.width, height=K.height),
        )
        state = pipe.init_state(depths[0])
        dt = _steady(
            lambda: pipe.run_fused(state, depths[1:])[1]["pose"], repeats
        )
        name = "rgbd_frames_per_s"
    else:  # scan_to_map
        scans, _ = synthetic.velodyne_log(n_frames=frames, n_rings=16, n_azimuth=512)
        scans = [voxel_downsample_np(s, 0.3) for s in scans]
        cfg = SlamConfig(
            icp=ICPConfig(method="point_to_plane", max_iters=20, max_corr_dist=1.5,
                          damping=1e-3, max_step_trans=1.0, max_step_rot=0.3,
                          min_inliers=50, huber_delta=0.3, tol=1e-5),
            mapping=MappingConfig(map_capacity=65536, local_model_size=8192,
                                  map_voxel=0.3),
            pipeline=PipelineConfig(mode="scan_to_map", scan_capacity=4096,
                                    keyframe_trans=2.0, keyframe_rot=0.2),
        )
        pts, msk = pad_scans(scans, 4096)
        from tpu_icp_slam.slam.scan_to_map import ScanToMapPipeline

        pipe = ScanToMapPipeline(cfg)
        state = pipe.init_state(pts[0], msk[0])
        dt = _steady(
            lambda: pipe.run_fused(state, pts[1:], msk[1:])[1]["pose"], repeats
        )
        name = "scan_to_map_frames_per_s"
    return {"metric": name, "value": round((frames - 1) / dt, 2),
            "unit": "frames/s", "frames": frames}


def bench_scaling(repeats: int = 3, points: int = 4096) -> dict:
    """Parallel efficiency of the point-sharded batched align vs 1 device."""
    import jax
    import jax.numpy as jnp

    from tpu_icp_slam.config import ICPConfig
    from tpu_icp_slam.core import pointcloud as pcm
    from tpu_icp_slam.datasets import synthetic
    from tpu_icp_slam.dist import ShardedAligner, make_mesh

    n_dev = len(jax.devices())
    counts = [d for d in (1, 2, 4, 8, 16) if d <= n_dev]
    cfg = ICPConfig(method="point_to_point", max_iters=10, nn_backend="xla")
    rows = []
    for d in counts:
        mesh = make_mesh(d, axes=("dp", "sp"), shape=(1, d))
        batch = 4
        src_b, msk_b, dst_b = [], [], []
        for i in range(batch):
            src, dst, _ = synthetic.two_scan_pair(n=points - 5, seed=i)
            cs = pcm.make(src, capacity=points)
            cd = pcm.make(dst, capacity=points)
            src_b.append(cs.points)
            msk_b.append(cs.mask)
            dst_b.append(cd.points)
        aligner = ShardedAligner(mesh=mesh, cfg=cfg)
        sb, mb, db = map(jnp.stack, (src_b, msk_b, dst_b))
        dt = _steady(lambda: aligner(sb, mb, db).T, repeats)
        rows.append({"devices": d, "aligns_per_s": round(batch / dt, 2)})
    base = rows[0]["aligns_per_s"]
    for r in rows:
        r["efficiency"] = round(r["aligns_per_s"] / (base * r["devices"]), 3)

    # distributed Schur pose-graph step over the same device counts
    from tpu_icp_slam.backend import pose_graph as pgm
    from tpu_icp_slam.backend import schur as schur_m

    rng = np.random.default_rng(0)
    n_kf = 64
    chain = [np.eye(4)]
    factors = []
    for i in range(1, n_kf):
        rel = synthetic.rigid_transform(3, rng, rot_scale=0.1, trans_scale=1.0)
        chain.append(chain[-1] @ rel)
        factors.append((i - 1, i, rel, 1.0))
    factors.append((0, n_kf - 1, np.linalg.inv(chain[0]) @ chain[-1], 2.0))
    g = pgm.from_arrays(np.stack(chain), factors, dtype=jnp.float32)
    schur_rows = []
    for d in counts:
        gmesh = make_mesh(d, axes=("graph",))

        def one():
            out, _ = schur_m.optimize_distributed(
                g, gmesh, iters=2, damping=1e-6
            )
            return out.poses

        dt = _steady(one, repeats)
        schur_rows.append({"devices": d, "gn_steps_per_s": round(2.0 / dt, 2)})

    # communication-volume accounting (VERDICT r2 item 8): exact per-step
    # collective payloads + the analytic compute-vs-interconnect efficiency
    # bound against the device kind's published peaks (dist/comm.py;
    # interpretation in DESIGN.md §8)
    from tpu_icp_slam.dist import comm

    kind = jax.devices()[0].device_kind
    comm_rows = []
    for d in counts:
        if d < 2:
            continue
        comm_rows.append(comm.sharded_icp_scaling_model(
            m_points=points, n_points=points, iters=10, n_devices=d,
            device_kind=kind, method="point_to_point",
        ))
        ns = comm.schur_separator_count(g, d)
        comm_rows.append(comm.schur_scaling_model(
            n_separator=ns,
            n_interior_max=max(1, (n_kf - ns) // d),
            n_factors=len(factors), iters=2, n_devices=d, device_kind=kind,
        ))
    return {"metric": "sharded_align_scaling", "rows": rows,
            "schur_rows": schur_rows, "comm_model": comm_rows,
            "unit": "aligns/s", "points": points}


def bench_from_cli(args) -> int:
    cid = args.config_id
    if cid == 1:
        report = bench_align(repeats=3)
    elif cid == 2:
        report = _fused_frames("2d", args.frames, 3)
    elif cid == 3:
        report = _fused_frames("rgbd", min(args.frames, 20), 3)
    elif cid == 4:
        report = _fused_frames("scan_to_map", args.frames, 3)
    else:
        report = bench_scaling()
    import jax

    report["platform"] = jax.default_backend()
    report["device_kind"] = jax.devices()[0].device_kind
    report["devices"] = len(jax.devices())
    if getattr(args, "json", False):
        print(json.dumps(report))
    else:
        print(json.dumps(report, indent=2))
    return 0
