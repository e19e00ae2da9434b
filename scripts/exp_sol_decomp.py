"""Speed-of-light decomposition of the KITTI-regime frame (VERDICT r2 item 2).

Answers, with host-readback-fenced measurements on the device:
  1. What is the per-scan-step floor IN CONTEXT (no-op body inside one fused
     lax.scan dispatch — not an isolated-harness number)?
  2. Is the floor per-STEP or per-OP? (body with k identical CSE-defeated
     matmuls; the marginal cost per op separates the two hypotheses — this
     is what the r2 unroll_iters paradox hinges on: unrolling removes loop
     steps but keeps the op count.)
  3. Where does the frame time go? Components measured by pipeline ablation:
     a. full pipeline (while_loop ICP)                 — the headline
     b. unroll_iters=5 variant                         — loop control removed
     c. max_iters=1 (single ICP iteration)             — ICP work removed
     d. no-ICP skeleton (extract_local + insert only)  — map ops only
     e. outer lax.scan unroll=4                        — outer loop control
  4. The speed-of-light bound: traced device kernel time vs what the
     ablation says is irreducible backend floor.

Writes one JSON line per measurement; summarize into BASELINE.md.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import numpy as np  # noqa: E402

from tpu_icp_slam.obs.compile_cache import enable as _enable_cache  # noqa: E402

_enable_cache()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpu_icp_slam.obs import realize  # noqa: E402

FRAMES = int(os.environ.get("SOL_FRAMES", "30"))
REPEATS = int(os.environ.get("SOL_REPEATS", "3"))


def timed(fn, *args, label="", frames=1):
    """Compile, then best-of-REPEATS wall time with host-readback fence."""
    t0 = time.perf_counter()
    out = fn(*args)
    realize(out)
    compile_s = time.perf_counter() - t0
    best = np.inf
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        out = fn(*args)
        realize(out)
        best = min(best, time.perf_counter() - t0)
    row = {
        "label": label,
        "total_ms": round(best * 1e3, 2),
        "ms_per_frame": round(best * 1e3 / frames, 3),
        "compile_s": round(compile_s, 1),
    }
    print(json.dumps(row), flush=True)
    return row


def scan_floor():
    """No-op and k-op lax.scan bodies: per-step floor + marginal per-op cost."""
    x0 = jnp.zeros((8, 128), jnp.float32)

    def make(k_ops):
        def body(c, _):
            for i in range(k_ops):
                # CSE-defeated: each op depends on the previous
                c = c + jnp.float32(1.0 + i * 1e-6)
            return c, ()

        @jax.jit
        def run(c):
            c, _ = jax.lax.scan(body, c, None, length=FRAMES)
            return c

        return run

    rows = {}
    for k in (0, 1, 8, 32):
        rows[k] = timed(make(k), x0, label=f"scan_noop_body_{k}ops",
                        frames=FRAMES)
    # marginal per-op cost from the 8->32 slope (first ops may fuse)
    slope_us = (rows[32]["ms_per_frame"] - rows[8]["ms_per_frame"]) / 24 * 1e3
    print(json.dumps({"label": "marginal_us_per_op", "value": round(slope_us, 1)}),
          flush=True)


def _scans():
    from tpu_icp_slam.core.pointcloud import voxel_downsample_np
    from tpu_icp_slam.datasets import synthetic

    scans, _ = synthetic.velodyne_log(
        n_frames=FRAMES, n_rings=48, n_azimuth=1024,
        path_fraction=min(1.0, FRAMES / 110.0),
    )
    return [voxel_downsample_np(s, 0.15) for s in scans]


def _kitti_cfg(**icp_over):
    from tpu_icp_slam.config import (
        ICPConfig, MappingConfig, PipelineConfig, SlamConfig,
    )

    icp = dict(
        method="point_to_plane", max_iters=20, max_corr_dist=1.0,
        damping=1e-3, max_step_trans=1.0, max_step_rot=0.3,
        min_inliers=100, huber_delta=0.3, tol=1e-5,
        step_scale=1.4, tol_update=0.01,
    )
    icp.update(icp_over)
    return SlamConfig(
        icp=ICPConfig(**icp),
        mapping=MappingConfig(map_capacity=131072, local_model_size=16384,
                              map_voxel=0.2),
        pipeline=PipelineConfig(mode="scan_to_map", scan_capacity=16384,
                                keyframe_trans=1.5, keyframe_rot=0.2),
    )


def pipeline_ablation():
    from tpu_icp_slam.slam.runner import pad_scans
    from tpu_icp_slam.slam.scan_to_map import ScanToMapPipeline, _step

    scans = _scans()
    variants = {
        "full_whileloop": _kitti_cfg(),
        "unroll5": _kitti_cfg(unroll_iters=5),
        "unroll3": _kitti_cfg(unroll_iters=3),
        "max_iters1": _kitti_cfg(max_iters=1),
        "max_iters2_fixed": _kitti_cfg(max_iters=2, tol=0.0, tol_update=0.0),
    }
    for name, cfg in variants.items():
        pts, msk = pad_scans(scans, cfg.pipeline.scan_capacity)
        pipe = ScanToMapPipeline(cfg)
        st0 = pipe.init_state(pts[0], msk[0])

        def run(st, p, m, _pipe=pipe):
            st, infos = _pipe.run_fused(st, p, m)
            return infos["pose"], infos["iters"]

        row = timed(run, st0, pts[1:], msk[1:], label=f"pipe_{name}",
                    frames=len(scans) - 1)
        # mean iters for interpretation
        _, infos = pipe.run_fused(st0, pts[1:], msk[1:])
        row["mean_iters"] = float(np.asarray(infos["iters"]).mean())
        print(json.dumps({"label": f"pipe_{name}_iters",
                          "mean_iters": round(row["mean_iters"], 2)}),
              flush=True)

    # outer-scan unroll: same body, fewer outer loop steps
    cfg = _kitti_cfg()
    pts, msk = pad_scans(scans, cfg.pipeline.scan_capacity)
    pipe = ScanToMapPipeline(cfg)
    st0 = pipe.init_state(pts[0], msk[0])

    @jax.jit
    def fused_unrolled(st, ap, am):
        def body(s, fr):
            p, m = fr
            return _step(s, p, m, cfg=cfg)

        st, infos = jax.lax.scan(body, st, (ap, am), unroll=4)
        return infos["pose"]

    timed(fused_unrolled, st0, pts[1:29], msk[1:29],
          label="pipe_full_outer_unroll4", frames=28)

    # no-ICP skeleton: extract_local + (always) insert — the map-op budget
    from tpu_icp_slam.mapping import voxel_map
    from tpu_icp_slam.mapping.normals import normals_knn

    m = cfg.mapping

    @jax.jit
    def skeleton(st, ap, am):
        def body(vm, fr):
            p, msk_ = fr
            loc_pts, loc_nrm, loc_msk, r = voxel_map.extract_local(
                vm, jnp.zeros(3), m.local_model_size
            )
            nrm = normals_knn(p, msk_, k=8)
            vm = voxel_map.insert(vm, p, msk_, nrm, voxel=m.map_voxel)
            return vm, (loc_pts.sum(), r)

        vm, out = jax.lax.scan(body, st.vmap, (ap, am))
        return out

    timed(skeleton, st0, pts[1:], msk[1:], label="skeleton_extract_insert",
          frames=len(scans) - 1)


if __name__ == "__main__":
    from tpu_icp_slam.obs.bench import measurement_stamp
    print(json.dumps(measurement_stamp()), flush=True)
    print(json.dumps({"platform": jax.default_backend(),
                      "frames": FRAMES}), flush=True)
    scan_floor()
    pipeline_ablation()
