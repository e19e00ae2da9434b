"""Full 3D SLAM: scan-to-map odometry + loop closure + pose-graph optimization.

BASELINE.json config 4 end-to-end: the streaming scan-to-map front-end
(slam/scan_to_map.py) produces keyframes; each keyframe is fingerprinted
(backend/loop_closure.py), candidate loops are verified by ICP, and accepted
closures + odometry factors form a pose graph optimized by damped GN
(backend/pose_graph.py). After optimization every frame pose is corrected
rigidly relative to its anchor keyframe.

Host code here only orchestrates (runs once per keyframe); descriptors,
verification ICP and the GN solve are jitted device work. The reference app
had no backend (SURVEY.md §2a R3) — capability mandated by the driver.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np

from tpu_icp_slam.backend.loop_closure import LoopClosure, LoopDetector
from tpu_icp_slam.backend import pose_graph as pg
from tpu_icp_slam.config import SlamConfig
from tpu_icp_slam.slam.scan_to_map import ScanToMapPipeline


@dataclasses.dataclass
class SlamReport:
    n_frames: int
    n_keyframes: int
    n_loop_candidates: int
    n_loop_closures: int
    chi2: Optional[list] = None
    n_loops_rejected: int = 0  # residual-gated back-end rejections
    # per-ACCEPTED-closure confidence (VERDICT r2 item 9): the consistency
    # filters are blind to aliases the whole graph agrees on (the measured
    # r2 racetrack wall, DESIGN.md §13) — so the surviving closures carry
    # their PCM cycle score and a suspect flag into the report/map instead
    # of being reported as uniformly trustworthy
    closure_table: Optional[list] = None  # [{i, j, rmse, n_inliers,
    # cycle_score_m, suspect}]
    n_suspect_closures: int = 0


class Slam3D:
    """Streaming front-end + backend; `run` maps a padded log to a trajectory."""

    def __init__(self, cfg: SlamConfig, progress: bool = False):
        self.cfg = cfg
        self.pipe = ScanToMapPipeline(cfg)
        self.detector = LoopDetector(cfg.backend)
        self.progress = progress  # per-chunk stderr-visible rate lines

    def run(
        self,
        pts: np.ndarray,
        msk: np.ndarray,
        mode: str = "fused",
        checkpoint_path: Optional[str] = None,
        checkpoint_every: int = 0,
        resume: bool = False,
        chunk_frames: int = 0,
    ):
        """pts (F, C, 3), msk (F, C) -> (poses (F, 4, 4), SlamReport).

        mode="fused": the whole odometry front-end is ONE device dispatch
        (`lax.scan`); keyframe flags come back with the per-frame infos and
        the backend (descriptors, loop verification, pose graph) runs as a
        batch pass after — the offline/bench shape. mode="streaming" steps
        frame by frame with the backend interleaved per keyframe — the
        live-sensor shape. Both produce the same factors.

        chunk_frames > 0 (fused mode): run the fused scan in fixed-length
        chunks with the backend (keyframe descriptors + loop verification)
        and optional checkpointing interleaved BETWEEN chunks — the
        flagship-length shape (VERDICT r2 item 1): bounded per-dispatch
        device arrays, sustained-rate visibility (self.chunk_stats records
        (first_frame, n_frames, wall_s) per chunk with an honest readback
        fence), and mid-log recovery points on multi-thousand-frame logs.

        checkpoint_every > 0 / resume force streaming and save/restore the
        FULL state: front-end pytree + keyframe database (frames, poses,
        descriptors, positions) + accepted closures (SURVEY.md §5;
        VERDICT r1 item 4 — the config-4 recovery story).
        """
        cfg = self.cfg
        if checkpoint_every or resume:
            mode = "streaming"
        start = 1
        state = None
        poses: list = []
        kf_frames: list = []
        kf_poses: list = []
        anchor_kf: list = []
        closures: list[LoopClosure] = []
        n_cands = 0
        self.closures_kept: list = []
        self.closure_scores = np.zeros(0)
        self.closure_suspect = np.zeros(0, bool)
        if resume and checkpoint_path and os.path.exists(checkpoint_path):
            from tpu_icp_slam.slam.checkpoint import restore_slam_session

            ck = restore_slam_session(checkpoint_path, cfg, self.detector)
            state = ck["fe_state"]
            start = ck["next_frame"]
            poses = ck["poses"]
            kf_frames = ck["kf_frames"]
            kf_poses = ck["kf_poses"]
            anchor_kf = ck["anchor_kf"]
            closures = ck["closures"]
            n_cands = ck["n_cands"]
        if state is None:
            state = self.pipe.init_state(pts[0], msk[0])
            poses = [np.eye(4)]
            kf_frames = [0]
            kf_poses = [np.eye(4)]
            anchor_kf = [0]  # per-frame anchoring for post-opt correction
            self.detector.add_keyframe(pts[0], msk[0], position=np.zeros(3))

        self.backend_s = 0.0  # wall time in per-keyframe backend work

        def on_keyframe(f, pose):
            nonlocal n_cands
            import time as _t

            t0 = _t.perf_counter()
            kf_idx = self.detector.add_keyframe(
                pts[f], msk[f], position=pose[:3, 3]
            )
            kf_frames.append(f)
            kf_poses.append(pose)
            if cfg.backend.enabled:
                # all candidates of this keyframe verify in ONE device
                # dispatch (candidates × yaw-hypotheses nested vmap)
                n, lcs = self.detector.verify_keyframe_candidates(
                    kf_idx, pts[f], msk[f], pts, msk,
                    kf_frames, kf_poses, pose, closures,
                )
                n_cands += n
                closures.extend(lcs)
            self.backend_s += _t.perf_counter() - t0

        def save_ck(next_frame):
            from tpu_icp_slam.slam.checkpoint import save_slam_checkpoint

            save_slam_checkpoint(
                checkpoint_path, "scan_to_map", state, next_frame, poses,
                kf_frames, kf_poses, anchor_kf, self.detector._descs,
                self.detector._positions, closures, n_cands,
                strain=strain, cfg=cfg,
            )

        self.final_state = None
        self.chunk_stats: list = []  # (first_frame, n_frames, wall_s)
        # per-frame front-end strain (hit the ICP cap without converging):
        # feeds odometry-factor down-weighting in the pose graph (see
        # BackendConfig.odom_strain_penalty). Restored on resume — strain
        # feeds factor weights, so a zeroed restart would make resume !=
        # uninterrupted (VERDICT r4 weak 2).
        strain = [False] * start
        if start > 1 and ck.get("strain") is not None:
            strain = list(ck["strain"])[:start]
        elif start > 1:
            import logging

            logging.getLogger(__name__).warning(
                "pre-r5 checkpoint has no strain record; odometry-factor "
                "weights for frames < %d resume as unstrained", start,
            )
        if mode == "fused":
            import time as _time

            chunk = chunk_frames if chunk_frames > 0 else len(pts) - start
            f0 = start
            while f0 < len(pts):
                f1 = min(f0 + chunk, len(pts))
                t0 = _time.perf_counter()
                state, infos = self.pipe.run_fused(
                    state, pts[f0:f1], msk[f0:f1]
                )
                all_poses = np.asarray(infos["pose"], np.float64)  # readback
                kf_flags = np.asarray(infos["is_keyframe"])  # = honest fence
                chunk_strain = (
                    (np.asarray(infos["iters"]) >= cfg.icp.max_iters)
                    & ~np.asarray(infos["converged"])
                )
                if cfg.backend.strain_on_clamp and "clamped" in infos:
                    # trust-region-pegged frames (see BackendConfig): the
                    # iteration-strain-silent walk-off class
                    chunk_strain |= np.asarray(infos["clamped"])
                strain.extend(chunk_strain.tolist())
                self.chunk_stats.append(
                    (f0, f1 - f0, _time.perf_counter() - t0)
                )
                if self.progress:
                    dt = self.chunk_stats[-1][2]
                    print(
                        f"[slam3d] chunk {f0}..{f1 - 1}: "
                        f"{(f1 - f0) / dt:.1f} fps, "
                        f"{int(np.sum(kf_flags))} keyframes",
                        flush=True,
                    )
                for f in range(f0, f1):
                    pose = all_poses[f - f0]
                    poses.append(pose)
                    if bool(kf_flags[f - f0]):
                        on_keyframe(f, pose)
                    anchor_kf.append(len(kf_frames) - 1)
                if chunk_frames and checkpoint_path:
                    save_ck(f1)
                f0 = f1
        else:
            for f in range(start, len(pts)):
                # failure detection (SURVEY.md §5): under jit nothing raises
                # — detect a poisoned frame by value and skip it, keeping the
                # previous front-end state (same policy as runner.py's
                # odometry streaming loop)
                prev_state = state
                state, info = self.pipe.step(state, pts[f], msk[f])
                pose = np.asarray(info["pose"], np.float64)
                if not np.isfinite(pose).all():
                    state = prev_state
                    poses.append(poses[-1])
                    anchor_kf.append(len(kf_frames) - 1)
                    strain.append(True)  # poisoned frame = maximal strain
                    continue
                strain.append(bool(
                    int(info["iters"]) >= cfg.icp.max_iters
                    and not bool(info["converged"])
                ) or (cfg.backend.strain_on_clamp
                      and bool(info.get("clamped", False))))
                poses.append(pose)
                if bool(info["is_keyframe"]):
                    on_keyframe(f, pose)
                anchor_kf.append(len(kf_frames) - 1)
                if (
                    checkpoint_every
                    and checkpoint_path
                    and f % checkpoint_every == 0
                ):
                    save_ck(f + 1)

        poses = np.stack(poses)
        self.final_state = state  # exposes the voxel map for artifact renders
        # persistent-map export hook (slam/map_io.py): keyframe scan indices
        # + poses; kf_poses_out is overwritten with the optimized poses below
        # when the backend runs
        self.kf_frames = list(kf_frames)
        self.kf_poses_out = [np.asarray(p) for p in kf_poses]
        self.closures = list(closures)
        report = SlamReport(
            n_frames=len(pts),
            n_keyframes=len(kf_frames),
            n_loop_candidates=n_cands,
            n_loop_closures=len(closures),
        )
        if not (cfg.backend.enabled and closures):
            return poses, report

        # ---- pose graph over keyframes: odometry chain + loop factors ----
        kf_poses = np.stack(kf_poses)
        if cfg.backend.pcm_gamma > 0 and len(closures) > 1:
            # pairwise-consistency maximization: keep the largest mutually
            # consistent closure clique (aliases agree with almost nothing)
            keep = pg.pairwise_consistent_closures(
                kf_poses, [(lc.i, lc.j, lc.T_ij) for lc in closures],
                gamma=cfg.backend.pcm_gamma,
            )
            report.n_loops_rejected += int((~keep).sum())
            closures = [lc for lc, k in zip(closures, keep) if k]
            if not closures:
                return poses, report
        factors = []
        pen = cfg.backend.odom_strain_penalty
        for k in range(1, len(kf_poses)):
            rel = np.linalg.inv(kf_poses[k - 1]) @ kf_poses[k]
            w = 1.0
            if pen > 0:
                n_str = sum(strain[kf_frames[k - 1] + 1: kf_frames[k] + 1])
                w = 1.0 / (1.0 + pen * n_str)
            factors.append((k - 1, k, rel, w))
        for lc in closures:
            factors.append((lc.i, lc.j, lc.T_ij, 2.0))
        import jax.numpy as jnp

        graph = pg.from_arrays(
            kf_poses,
            factors,
            max_keyframes=min(
                max(len(kf_poses), 2), cfg.backend.max_keyframes
            ),
            max_factors=min(max(len(factors), 2), cfg.backend.max_factors),
            dtype=jnp.float64,
        )
        if cfg.backend.reject_residual > 0:
            # back-end defense against aliased closures that slip the
            # front-end gates: residual-gated re-optimization (pose_graph.
            # reject_inconsistent_loops) — runs on the dense oracle, then
            # the chosen solver (dense or distributed Schur) sees the
            # cleaned weights
            import dataclasses as _dc

            n_odo = len(kf_poses) - 1
            loop_mask = np.zeros(graph.factor_capacity, bool)
            loop_mask[n_odo: n_odo + len(closures)] = True
            kept, n_rej = pg.reject_inconsistent_loops(
                graph, loop_mask, cfg.backend.reject_residual,
                iters=cfg.backend.pg_iters,
                damping=cfg.backend.pg_damping,
                huber_delta=cfg.backend.huber_delta,
            )
            if n_rej:
                graph = _dc.replace(graph, weight=kept)
                report.n_loops_rejected += n_rej
                kept_np = np.asarray(kept)
                closures = [
                    lc for k, lc in enumerate(closures)
                    if kept_np[n_odo + k] > 0
                ]
        self.closures_kept = list(closures)  # post-filter factors
        # per-closure confidence for report + saved-map metadata: scored
        # against ODOMETRY poses (pre-optimization — a smooth optimizer
        # smears alias error and would hide it, DESIGN.md §13)
        scores, suspect = pg.closure_confidence(
            kf_poses, [(lc.i, lc.j, lc.T_ij) for lc in closures],
            suspect_cycle=cfg.backend.suspect_cycle,
        )
        self.closure_scores = np.asarray(scores, np.float64)
        self.closure_suspect = np.asarray(suspect, bool)
        report.closure_table = [
            {
                "i": lc.i, "j": lc.j, "rmse": round(lc.rmse, 4),
                "n_inliers": lc.n_inliers,
                "cycle_score_m": (
                    None if np.isnan(scores[k]) else round(float(scores[k]), 3)
                ),
                "suspect": bool(suspect[k]),
            }
            for k, lc in enumerate(closures)
        ]
        report.n_suspect_closures = int(suspect.sum())
        import math

        n_blocks = math.prod(cfg.dist.mesh_shape)
        if n_blocks > 1:
            # config-5 path: keyframe blocks partitioned over the mesh,
            # Schur-reduced separator system (backend/schur.py)
            import jax as _jax

            from tpu_icp_slam.backend import schur
            from tpu_icp_slam.dist import make_mesh

            n_dev = min(n_blocks, len(_jax.devices()))
            mesh = make_mesh(n_dev, axes=("graph",))
            graph_opt, chis = schur.optimize_distributed(
                graph,
                mesh,
                iters=cfg.backend.pg_iters,
                damping=cfg.backend.pg_damping,
                huber_delta=cfg.backend.huber_delta,
            )
        else:
            graph_opt, chis = pg.optimize(
                graph,
                iters=cfg.backend.pg_iters,
                damping=cfg.backend.pg_damping,
                huber_delta=cfg.backend.huber_delta,
            )
        kf_opt = np.asarray(graph_opt.poses)[: len(kf_poses)]
        self.kf_poses_out = [kf_opt[i] for i in range(len(kf_poses))]
        report.chi2 = [float(c) for c in np.asarray(chis)]

        # ---- rigid per-frame correction relative to the anchor keyframe ----
        out = np.empty_like(poses)
        for f in range(len(poses)):
            a = anchor_kf[f]
            rel = np.linalg.inv(kf_poses[a]) @ poses[f]
            out[f] = kf_opt[a] @ rel
        return out, report
