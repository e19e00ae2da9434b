#!/usr/bin/env python3
"""The quickest proof that the system runs on an NVIDIA GPU.

    python chip_smoke.py          # one card
    python chip_smoke.py --four   # four cards of one host

One card: the device, the Triton-route NN kernel against XLA's plain version
and a float64 brute force at the flagship width, the flagship KITTI-width
scan-to-map SLAM (loop closure and pose graph on) through `cli run` with the
kernel and with XLA's NN, and configs 1-3 through the CLI. Four cards: the
multi-sequence runner, the point-sharded ICP and the distributed Schur pose
graph, each against its single-device counterpart.

Every phase runs in this one process, and any failed check raises, so the
exit code is non-zero. Nothing falls back to the CPU: with no GPU the script
stops before any phase. The last line of standard output is one JSON object,
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(REPO, "src")
CONFIGS = os.path.join(REPO, "configs")

SEED = 0
# the flagship log: 48 rings × 1,024 azimuths per sweep (KITTI HDL-64
# class), downsampled at 0.15 m by the config to ~16k points, on a compact
# ~100 m loop (scripts/exp_loop.py) driven in 90 frames at ~1.1 m/frame.
# The sensor revisits its start, so loop verification runs. On the
# built-in ~190 m circuit the front-end drifts ~30 m before the revisit,
# beyond the config's 12 m candidate gate, and no candidate is ever found
# (scripts/exp_flagship_routes.py, PERF.md).
COMPACT_LOOP = [(-36, -4), (-12, -4), (-4, -4), (-2, 2), (-4, 13), (-20, 13),
                (-34, 12), (-38, 4), (-35, -3.6), (-28, -4)]
FLAGSHIP_FRAMES = 90
RINGS, AZIMUTHS = 48, 1024
GOLDEN_FRAMES = 6

# NN check shapes: the flagship's scan capacity and local model, and the 2D
# path's scan capacity and local model (configs/lidar2d_scan_to_map.json)
NN_M = NN_N = 16384
NN_VALID = 15000  # local-model slots that hold map points; the rest are sentinels
NN_2D_M, NN_2D_N = 512, 2048
ORACLE_ROWS = 1024
CANDIDATES, YAWS = 2, 8  # loop verification batch (configs/kitti_full_res.json)

# --four: frames per multi-sequence log, points per sharded ICP problem,
# keyframes of the distributed pose graph
FOUR_FRAMES = 24
FOUR_ICP_POINTS = 16384
FOUR_KEYFRAMES = 64

# The kernel computes Σ(a−b)² in f32: each difference and square rounds once,
# so the picked distance is within a few ulp of the float64 minimum.
NN_KERNEL_REL_TOL = 1e-6
NN_KERNEL_ABS_TOL = 1e-9  # m²
# XLA's version uses ‖a‖² + ‖b‖² − 2a·b, which cancels: its error is about
# (‖a‖² + ‖b‖²)·2⁻²² — ~2e-3 m² for points 60 m from the sensor.
NN_XLA_ABS_TOL = 5e-3  # m²

# Flagship accuracy bounds. The front-end's recorded full-width accuracy on
# cornered routes is ~5 % of the distance travelled, and runs differ from
# each other by up to 2× (the corners amplify last-bit differences); a
# diverged run is off by tens of metres. So ATE is held under 10 % of the
# distance, and the per-frame RPE under one frame's motion (1.13 m) and
# 0.25 rad (the sharpest turn of the route is ~0.2 rad/frame).
FLAGSHIP_ATE_FRACTION = 0.10
FLAGSHIP_RPE_TRANS_M = 1.13
FLAGSHIP_RPE_ROT_RAD = 0.25
# the first GOLDEN_FRAMES frames against the fp64 scan-to-scan oracle: the
# map-based front-end is a different algorithm, so it is held to the
# oracle's error plus 5 cm.
GOLDEN_MARGIN_M = 0.05
# configs 2 and 3 (same bounds as the CPU suite: tests/test_pipeline_2d.py
# and tests/test_rgbd.py); config 2's loop run measured 0.056 m on the CPU.
LIDAR2D_ATE_M = 0.10
RGBD_ATE_M = 0.03


def card_line() -> str:
    """`nvidia-smi` name and power limit of every card, from a child
    process that never imports JAX."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def phases_for(four: bool) -> list[str]:
    return ["four"] if four else ["nn", "flagship", "configs"]


def require_gpu(devices) -> None:
    if not devices or devices[0].platform != "gpu":
        found = devices[0].platform if devices else "none"
        raise SystemExit(f"chip_smoke: needs an NVIDIA GPU, JAX found {found!r}")


def contract_line(devices) -> str:
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": len(devices)}})


def triton_calls(hlo_text: str) -> list[str]:
    """Instructions of compiled GPU HLO that launch the Pallas NN kernel
    through Triton: the custom call Pallas emits (or the fusion XLA turns it
    into) for the `nn_argmin` pallas_call. XLA's own Triton fusions carry
    neither name, and interpret mode emits no Triton call at all."""
    return [line for line in hlo_text.splitlines()
            if ("xla.gpu.triton" in line or '"__triton"' in line)
            and ("pallas_call" in line or "nn_argmin" in line)]


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)
    log(f"  ok: {what}")


def _time_ms(fn, *args, reps: int = 20) -> float:
    import jax
    import numpy as np

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(ts))


def _cli(argv: list[str]) -> int:
    """`cli.main` in this process, its stdout kept off ours."""
    from tpu_icp_slam import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        return cli.main(argv)


def flagship_log(n_frames: int, seed: int, loop: bool):
    """Seeded synthetic Velodyne log on the compact loop or (loop=False) the
    straight route at ~1.1 m/frame: (raw scans, poses relative to frame 0)."""
    import numpy as np

    from tpu_icp_slam.datasets import synthetic

    kw = {"waypoints": np.asarray(COMPACT_LOOP, np.float64)} if loop else {
        "path_fraction": min(1.0, n_frames / 110.0)}
    scans, gt = synthetic.velodyne_log(
        n_frames=n_frames, seed=seed, n_rings=RINGS, n_azimuth=AZIMUTHS, **kw)
    return scans, np.einsum("ij,fjk->fik", np.linalg.inv(gt[0]), gt)


# ---------------------------------------------------------------- phases ---


def phase_nn(scans) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from tpu_icp_slam.core.pointcloud import voxel_downsample_np
    from tpu_icp_slam.kernels.nn import resolve_backend
    from tpu_icp_slam.kernels.nn_pallas import nn_bruteforce_pallas
    from tpu_icp_slam.kernels.nn_xla import nn_bruteforce_xla
    from tpu_icp_slam.slam.runner import pad_scans

    log("[nn] Triton kernel vs XLA vs float64 brute force")
    check(resolve_backend("auto") == "pallas", "auto resolves to the kernel")
    ds = [voxel_downsample_np(s, 0.15) for s in scans[:3]]

    def local_model(points):  # NN_VALID map points, then sentinels
        keep = np.linspace(0, len(points) - 1, NN_VALID).astype(np.int64)
        return pad_scans([points[keep]], NN_N)[0][0]

    src, src_valid = (x[0] for x in pad_scans([ds[1]], NN_M))
    dst = local_model(ds[0])

    kernel = jax.jit(nn_bruteforce_pallas)
    xla = jax.jit(nn_bruteforce_xla)
    s_d, d_d = jnp.asarray(src), jnp.asarray(dst)
    idx_k, d2_k = (np.asarray(x) for x in kernel(s_d, d_d))
    idx_x, _ = (np.asarray(x) for x in xla(s_d, d_d))

    def oracle_check(src, dst, idx, d2, rows, name):
        a = src[rows].astype(np.float64)
        D = ((a[:, None, :] - dst[None].astype(np.float64)) ** 2).sum(-1)
        dmin = D.min(1)
        r = np.arange(len(rows))
        tol = NN_KERNEL_REL_TOL * dmin + NN_KERNEL_ABS_TOL
        picked = D[r, idx[rows]]
        check(np.all(picked - dmin <= tol),
              f"{name}: picked distance = float64 minimum "
              f"(max excess {float(np.max(picked - dmin)):.3g} m²)")
        check(np.all(np.abs(d2[rows] - dmin) <= tol),
              f"{name}: returned distance = float64 minimum "
              f"(max error {float(np.max(np.abs(d2[rows] - dmin))):.3g} m²)")
        differ = idx[rows] != D.argmin(1)
        check(np.all(picked[differ] - dmin[differ] <= tol[differ]),
              f"{name}: index differs from the oracle only at ties within "
              f"f32 resolution ({int(differ.sum())} such rows)")

    # real scan points only: sentinel-padded source rows have no meaning
    real = np.flatnonzero(src_valid)
    rows = real[np.linspace(0, len(real) - 1, ORACLE_ROWS).astype(np.int64)]
    oracle_check(src, dst, idx_k, d2_k, rows, f"kernel {NN_M}x{NN_N}")
    check(np.all(idx_k[src_valid] < NN_VALID),
          "sentinel targets never win for a real source point")
    a64, b64 = src.astype(np.float64), dst.astype(np.float64)
    pk = ((a64 - b64[idx_k]) ** 2).sum(-1)
    px = ((a64 - b64[idx_x]) ** 2).sum(-1)
    check(np.all(px - pk <= NN_XLA_ABS_TOL)
          and np.all(pk - px <= NN_KERNEL_REL_TOL * px + NN_KERNEL_ABS_TOL),
          f"kernel vs XLA on all {NN_M} rows: kernel never farther, XLA "
          f"within {NN_XLA_ABS_TOL} m² (max {float(np.max(px - pk)):.3g})")

    rng = np.random.default_rng(SEED)
    s2 = rng.uniform(-20, 20, (NN_2D_M, 2)).astype(np.float32)
    t2 = np.full((NN_2D_N, 2), 1.0e6, np.float32)
    t2[:NN_2D_N - 100] = rng.uniform(-20, 20, (NN_2D_N - 100, 2))
    i2, e2 = (np.asarray(x) for x in kernel(jnp.asarray(s2), jnp.asarray(t2)))
    oracle_check(s2, t2, i2, e2, np.arange(NN_2D_M), f"kernel D=2 "
                 f"{NN_2D_M}x{NN_2D_N}")

    # loop verification: candidates × yaw hypotheses, nested vmap
    yaws = np.linspace(0, 2 * np.pi, YAWS, endpoint=False)
    rot = np.stack([[[np.cos(y), -np.sin(y), 0], [np.sin(y), np.cos(y), 0],
                     [0, 0, 1]] for y in yaws]).astype(np.float32)
    srcs = jnp.asarray(np.einsum("yij,mj->ymi", rot, src))  # (Y, M, 3)
    dsts = jnp.asarray(np.stack([dst, local_model(ds[2])]))  # (C, N, 3)
    batched = jax.jit(jax.vmap(jax.vmap(nn_bruteforce_pallas, (0, None)),
                               (None, 0)))
    ib, db = (np.asarray(x) for x in batched(srcs, dsts))
    same = all(
        np.array_equal(ib[c, y], np.asarray(kernel(srcs[y], dsts[c])[0]))
        for c in range(CANDIDATES) for y in range(YAWS))
    check(ib.shape == (CANDIDATES, YAWS, NN_M) and same,
          f"vmap {CANDIDATES}x{YAWS}: every problem equals its unbatched call")
    oracle_check(np.asarray(srcs[3]), np.asarray(dsts[1]), ib[1, 3], db[1, 3],
                 rows[::4], "vmap problem (1, 3)")

    sb = jnp.broadcast_to(s_d, (CANDIDATES * YAWS, NN_M, 3))
    db_ = jnp.broadcast_to(d_d, (CANDIDATES * YAWS, NN_N, 3))
    t = {
        "kernel_ms": _time_ms(kernel, s_d, d_d),
        "xla_ms": _time_ms(xla, s_d, d_d),
        "kernel_vmap16_ms": _time_ms(jax.jit(jax.vmap(nn_bruteforce_pallas)),
                                     sb, db_, reps=5),
        "xla_vmap16_ms": _time_ms(jax.jit(jax.vmap(nn_bruteforce_xla)),
                                  sb, db_, reps=5),
    }
    log(f"  nn timing {NN_M}x{NN_N} (median ms/call): {json.dumps(t)}")


def _front_end_timing(cfg, pts, msk, want_triton: bool):
    """Compile the fused scan-to-map front-end, check the compiled HLO for
    the Triton kernel, and time steady-state runs. Returns the front-end's
    odometry poses (no loop closure) and the timing record."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from tpu_icp_slam.slam.scan_to_map import ScanToMapPipeline

    pipe = ScanToMapPipeline(cfg)
    pts, msk = jnp.asarray(pts), jnp.asarray(msk)
    state0 = pipe.init_state(pts[0], msk[0])
    t0 = time.perf_counter()
    compiled = pipe._fused.lower(state0, pts[1:], msk[1:]).compile()
    compile_s = time.perf_counter() - t0
    calls = triton_calls(compiled.as_text())
    check(bool(calls) == want_triton,
          f"compiled scan-to-map step {'holds' if want_triton else 'lacks'} "
          f"the Triton NN kernel ({len(calls)} launch instructions"
          + (f", e.g. {calls[0].split('=')[0].strip()})" if calls else ")"))
    _, infos = jax.block_until_ready(compiled(state0, pts[1:], msk[1:]))
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(state0, pts[1:], msk[1:]))
        best = min(best, time.perf_counter() - t0)
    mem = compiled.memory_analysis()
    poses = np.concatenate([np.eye(4)[None], np.asarray(infos["pose"],
                                                         np.float64)])
    return poses, {
        "front_end_fps": (len(pts) - 1) / best,
        "front_end_s": best,
        "compile_s": compile_s,
        "temp_bytes": getattr(mem, "temp_size_in_bytes", None),
        "peak_bytes_in_use": (jax.devices()[0].memory_stats() or {}).get(
            "peak_bytes_in_use"),
    }


def phase_flagship(scans, gt, tmp: str) -> None:
    import numpy as np

    from tpu_icp_slam.config import from_json, override
    from tpu_icp_slam.core.pointcloud import voxel_downsample_np
    from tpu_icp_slam.datasets import kitti
    from tpu_icp_slam.eval import golden
    from tpu_icp_slam.eval import metrics as em
    from tpu_icp_slam.slam.runner import pad_scans

    log(f"[flagship] KITTI-width scan-to-map SLAM, {len(scans)} frames, "
        "loop closure and pose graph on, through cli run")
    seq = os.path.join(tmp, "kitti_seq")
    kitti.write_sequence(seq, scans, poses=gt)
    cfg_path = os.path.join(CONFIGS, "kitti_full_res.json")
    with open(cfg_path) as fh:
        base = from_json(fh.read())
    ds = [voxel_downsample_np(s, base.pipeline.downsample_voxel) for s in scans]
    pts, msk = pad_scans(ds, base.pipeline.scan_capacity)
    path_m = float(np.sum(np.linalg.norm(np.diff(gt[:, :3, 3], axis=0),
                                         axis=1)))

    results = {}
    for backend in ("pallas", "xla"):
        cfg = override(base, {"icp.nn_backend": backend})
        odom, timing = _front_end_timing(cfg, pts, msk,
                                         want_triton=backend == "pallas")
        timing["front_end_ate_m"] = em.ate_rmse(odom[:, :3, 3], gt[:, :3, 3])
        timing["front_end_rpe"] = em.rpe(odom, gt)
        results[backend] = dict(timing, odom=odom)
        out = os.path.join(tmp, f"flagship_{backend}")
        t0 = time.perf_counter()
        rc = _cli(["run", "--dataset", seq, "--config", cfg_path,
                   "--frames", str(len(scans)), "--out", out,
                   f"icp.nn_backend={backend}"])
        wall = time.perf_counter() - t0
        check(rc == 0, f"cli run ({backend}) exit code 0")
        with open(os.path.join(out, "report.json")) as fh:
            rep = json.load(fh)
        poses = np.load(os.path.join(out, "trajectory.npz"))["poses"]
        summary = {k: rep[k] for k in (
            "frames", "n_keyframes", "n_loop_candidates", "n_loop_closures",
            "n_loops_rejected", "ate_rmse", "rpe_trans", "rpe_rot")}
        summary["cli_run_wall_s"] = wall
        log(f"  {backend}: {json.dumps(summary)}")
        log(f"  {backend} front end: {json.dumps(timing)}")
        check(rep["frames"] == len(scans) and np.isfinite(poses).all(),
              f"{backend}: finite trajectory of {len(scans)} frames")
        check(rep["n_loop_candidates"] > 0,
              f"{backend}: loop verification ran "
              f"({rep['n_loop_candidates']} candidates)")
        bound = FLAGSHIP_ATE_FRACTION * path_m
        check(rep["ate_rmse"] < bound,
              f"{backend}: ATE {rep['ate_rmse']:.4f} m < {bound:.2f} m "
              f"({FLAGSHIP_ATE_FRACTION:.0%} of {path_m:.1f} m)")
        check(rep["rpe_trans"] < FLAGSHIP_RPE_TRANS_M
              and rep["rpe_rot"] < FLAGSHIP_RPE_ROT_RAD,
              f"{backend}: RPE {rep['rpe_trans']:.4f} m, "
              f"{rep['rpe_rot']:.5f} rad per frame")

    k = GOLDEN_FRAMES
    g = golden.odometry([s.astype(np.float64) for s in ds[:k]])
    g_ate = em.ate_rmse(g[:, :3, 3], gt[:k, :3, 3])
    g_rpe = em.rpe(g, gt[:k])
    s_pos = results["pallas"]["odom"][:k]  # odometry, like the oracle
    s_ate = em.ate_rmse(s_pos[:, :3, 3], gt[:k, :3, 3])
    s_rpe = em.rpe(s_pos, gt[:k])
    log(f"  first {k} frames: golden fp64 ATE {g_ate:.4f} m, RPE "
        f"{g_rpe[0]:.4f} m / {g_rpe[1]:.5f} rad; system odometry ATE "
        f"{s_ate:.4f} m, RPE {s_rpe[0]:.4f} m / {s_rpe[1]:.5f} rad")
    check(s_ate <= g_ate + GOLDEN_MARGIN_M,
          f"system ATE within the golden oracle's + {GOLDEN_MARGIN_M} m")
    fps_k = results["pallas"]["front_end_fps"]
    fps_x = results["xla"]["front_end_fps"]
    log(f"  front-end frames/s: kernel {fps_k:.2f}, xla {fps_x:.2f} "
        f"(ratio {fps_k / fps_x:.3f})")


def phase_configs(tmp: str) -> None:
    log("[configs] configs 1-3 through the CLI at their real widths")
    check(_cli(["align", "--n", "4096"]) == 0,
          "config 1: align --n 4096 recovered_under_1e-3")
    for name, dataset, frames, cfg, bound, loops in (
        ("config 2 (2D occupancy, loop)", "sim2d_loop", 60,
         "lidar2d_scan_to_map.json", LIDAR2D_ATE_M, True),
        ("config 3 (RGB-D 640x480)", "simrgbd_fullres", 8, "rgbd.json",
         RGBD_ATE_M, False),
    ):
        out = os.path.join(tmp, dataset)
        rc = _cli(["run", "--dataset", dataset, "--frames", str(frames),
                   "--config", os.path.join(CONFIGS, cfg), "--out", out])
        check(rc == 0, f"{name}: cli run exit code 0")
        with open(os.path.join(out, "report.json")) as fh:
            rep = json.load(fh)
        log(f"  {name}: ATE {rep['ate_rmse']:.4f} m, RPE "
            f"{rep['rpe_trans']:.4f} m / {rep['rpe_rot']:.5f} rad")
        check(rep["ate_rmse"] < bound, f"{name}: ATE < {bound} m")
        if loops:
            check(rep["n_loop_candidates"] > 0,
                  f"{name}: loop verification ran "
                  f"({rep['n_loop_candidates']} candidates)")


def _spans(x) -> int:
    return len({s.device for s in x.addressable_shards})


def phase_four() -> None:
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from tpu_icp_slam.backend import pose_graph as pg
    from tpu_icp_slam.backend import schur
    from tpu_icp_slam.config import ICPConfig, from_json
    from tpu_icp_slam.core import pointcloud as pcm
    from tpu_icp_slam.core.pointcloud import voxel_downsample_np
    from tpu_icp_slam.datasets import synthetic
    from tpu_icp_slam.dist import (ShardedAligner, make_mesh,
                                   make_multi_sequence_runner)
    from tpu_icp_slam.icp import align
    from tpu_icp_slam.slam.runner import pad_scans
    from tpu_icp_slam.slam.scan_to_map import ScanToMapPipeline

    devs = jax.devices()
    check(len(devs) == 4, "four devices")

    log("[four] multi-sequence runner: 4 full-width sequences, one per card")
    with open(os.path.join(CONFIGS, "kitti_full_res.json")) as fh:
        cfg = from_json(fh.read())
    cfg = dataclasses.replace(
        cfg, backend=dataclasses.replace(cfg.backend, enabled=False))
    frames = FOUR_FRAMES
    seqs = []
    for s in range(4):
        raw, _ = flagship_log(frames, seed=SEED + s, loop=False)
        ds = [voxel_downsample_np(x, cfg.pipeline.downsample_voxel) for x in raw]
        seqs.append(pad_scans(ds, cfg.pipeline.scan_capacity))
    pts = np.stack([p for p, _ in seqs])
    msk = np.stack([m for _, m in seqs])
    mesh = make_mesh(4, axes=("dp",))
    shard = NamedSharding(mesh, P("dp"))
    runner = make_multi_sequence_runner(mesh, cfg)
    p_d, m_d = jax.device_put(pts, shard), jax.device_put(msk, shard)
    out = jax.block_until_ready(runner(p_d, m_d))
    check(_spans(out) == 4, "multi-sequence poses live on all four cards")
    t0 = time.perf_counter()
    out = jax.block_until_ready(runner(p_d, m_d))
    t4 = time.perf_counter() - t0
    poses4 = np.asarray(out)
    pipe = ScanToMapPipeline(cfg)
    worst = 0.0
    t1 = 0.0
    for s in range(4):
        with jax.default_device(devs[0]):
            st = pipe.init_state(pts[s, 0], msk[s, 0])
            jax.block_until_ready(pipe.run_fused(st, pts[s, 1:], msk[s, 1:]))
            t0 = time.perf_counter()
            _, infos = pipe.run_fused(st, pts[s, 1:], msk[s, 1:])
            alone = np.asarray(infos["pose"])
            t1 += time.perf_counter() - t0
        worst = max(worst, float(np.abs(poses4[s, 1:, :3, 3]
                                        - alone[:, :3, 3]).max()))
    log(f"  4 sequences x {frames} frames: {t4:.3f} s on 4 cards, "
        f"{t1:.3f} s one after another on card 0; max position "
        f"difference {worst:.3g} m")
    check(worst < 1e-2, "each sequence matches its run alone on card 0 "
          "(< 1 cm)")

    log("[four] ShardedAligner on a (dp, sp) = (2, 2) mesh vs align")
    n = FOUR_ICP_POINTS
    cfg_icp = ICPConfig(method="point_to_point", max_iters=40, tol=1e-7)
    src_b, msk_b, dst_b, gts = [], [], [], []
    for i in range(2):
        s, d, T = synthetic.two_scan_pair(n=n - 16, seed=SEED + i)
        cs, cd = pcm.make(s, n), pcm.make(d, n)
        src_b.append(cs.points)
        msk_b.append(cs.mask)
        dst_b.append(cd.points)
        gts.append(T)
    mesh22 = make_mesh(4, axes=("dp", "sp"), shape=(2, 2))
    res = ShardedAligner(mesh=mesh22, cfg=cfg_icp)(
        jnp.stack(src_b), jnp.stack(msk_b), jnp.stack(dst_b))
    check(_spans(res.T) == 4, "sharded ICP result spans all four cards")
    for b in range(2):
        with jax.default_device(devs[0]):
            ref = align(pcm.PointCloud(points=src_b[b], mask=msk_b[b]),
                        pcm.PointCloud(points=dst_b[b],
                                       mask=jnp.ones(n, bool)), cfg=cfg_icp)
        diff = float(np.abs(np.asarray(res.T)[b] - np.asarray(ref.T)).max())
        err = float(np.abs(np.asarray(res.T)[b] - gts[b]).max())
        log(f"  problem {b}: max |T_sharded - T_single| {diff:.3g}, "
            f"max |T_sharded - T_true| {err:.3g}")
        check(diff < 1e-4 and err < 1e-3,
              f"problem {b}: sharded == single-device, both recover T")

    log("[four] distributed Schur pose graph vs dense optimize")
    rng = np.random.default_rng(SEED)
    n_kf = FOUR_KEYFRAMES
    chain, factors = [np.eye(4)], []
    for i in range(1, n_kf):
        rel = synthetic.rigid_transform(3, rng, rot_scale=0.05,
                                        trans_scale=1.0)
        chain.append(chain[-1] @ rel)
        noisy = rel @ synthetic.rigid_transform(3, rng, rot_scale=0.002,
                                                trans_scale=0.02)
        factors.append((i - 1, i, noisy, 1.0))
    factors.append((0, n_kf - 1, np.linalg.inv(chain[0]) @ chain[-1], 2.0))
    init = [np.eye(4)]
    for _, _, rel, _ in factors[:-1]:
        init.append(init[-1] @ rel)
    g = pg.from_arrays(np.stack(init), factors, dtype=jnp.float32)
    with jax.default_device(devs[0]):
        dense, dense_chi = pg.optimize(g, iters=6, damping=1e-6)
    dist, dist_chi = schur.optimize_distributed(
        g, make_mesh(4, axes=("graph",)), iters=6, damping=1e-6)
    diff = float(np.abs(np.asarray(dist.poses)[:n_kf]
                        - np.asarray(dense.poses)[:n_kf]).max())
    log(f"  {n_kf} keyframes: max pose difference {diff:.3g}; chi2 dense "
        f"{[round(float(c), 5) for c in np.asarray(dense_chi)]}, "
        f"distributed {[round(float(c), 5) for c in np.asarray(dist_chi)]}")
    check(diff < 1e-3, "distributed Schur == dense (< 1e-3, f32)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card paths and their references")
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(SRC, "tpu_icp_slam")):
        print(f"chip_smoke: no package under {SRC}", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    import jax

    devices = jax.devices()
    require_gpu(devices)
    cards = card_line()
    from tpu_icp_slam.obs.compile_cache import cache_dir, enable

    enable()
    import tpu_icp_slam.core  # noqa: F401  (sets the matmul precision)

    log(f"[device] platform {devices[0].platform}, kind "
        f"{devices[0].device_kind}, count {len(devices)}")
    log(f"[device] matmul precision {jax.config.jax_default_matmul_precision}"
        f"; compile cache {cache_dir()}")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        phases = phases_for(args.four)
        if "flagship" in phases or "nn" in phases:
            scans, gt = flagship_log(FLAGSHIP_FRAMES, SEED, loop=True)
        for phase in phases:
            t0 = time.perf_counter()
            if phase == "nn":
                phase_nn(scans)
            elif phase == "flagship":
                phase_flagship(scans, gt, tmp)
            elif phase == "configs":
                phase_configs(tmp)
            elif phase == "four":
                phase_four()
            log(f"[{phase}] passed in {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(cards)
    print(contract_line(devices), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
