"""Loop-closure detector tests (N13): descriptor invariances + verification."""

import numpy as np
import jax.numpy as jnp

from tpu_icp_slam.backend.loop_closure import (
    LoopDetector,
    scan_context,
    shift_match_scores,
)
from tpu_icp_slam.config import BackendConfig
from tpu_icp_slam.core.pointcloud import voxel_downsample_np
from tpu_icp_slam.datasets import synthetic


def _scan(i, scans):
    s = voxel_downsample_np(scans[i], 0.4)
    return s, np.ones(len(s), bool)


def test_scan_context_yaw_shift():
    scans, _ = synthetic.velodyne_log(n_frames=2, n_rings=12, n_azimuth=256)
    s, m = _scan(0, scans)
    d0 = scan_context(jnp.asarray(s, jnp.float32), jnp.asarray(m), 20, 60)
    yaw = 2 * np.pi * 9 / 60  # exactly 9 sectors
    c, sn = np.cos(yaw), np.sin(yaw)
    R = np.array([[c, -sn, 0], [sn, c, 0], [0, 0, 1]])
    d1 = scan_context(
        jnp.asarray(s @ R.T, jnp.float32), jnp.asarray(m), 20, 60
    )
    scores, shifts = shift_match_scores(d1, d0[None])
    # rotating the query by +9 sectors matches at shift S-9 (candidate is the
    # query rotated by -yaw); exact-integer sector rotation scores ~1
    assert float(scores[0]) > 0.95
    assert int(shifts[0]) == 60 - 9


def test_scan_context_discriminates_locations():
    scans, _ = synthetic.velodyne_log(n_frames=8, n_rings=12, n_azimuth=256)
    s0, m0 = _scan(0, scans)
    s7, m7 = _scan(7, scans)
    d0 = scan_context(jnp.asarray(s0, jnp.float32), jnp.asarray(m0), 20, 60)
    d7 = scan_context(jnp.asarray(s7, jnp.float32), jnp.asarray(m7), 20, 60)
    same, _ = shift_match_scores(d0, d0[None])
    diff, _ = shift_match_scores(d7, d0[None])
    assert float(same[0]) > 0.999
    assert float(diff[0]) < float(same[0]) - 0.2


def test_detector_finds_revisit_and_verifies():
    # loop log at GT poses: the last frames revisit the start region
    scans, gt = synthetic.velodyne_log(
        n_frames=24, n_rings=12, n_azimuth=256, loop=True
    )
    cfg = BackendConfig(
        enabled=True, min_loop_separation=12, candidate_topk=3,
        verify_max_rmse=0.6, gating_radius=15.0,
    )
    det = LoopDetector(cfg)
    cap = 1536
    padded = []
    for i in range(len(scans)):
        s = voxel_downsample_np(scans[i], 0.5)[:cap]
        pts = np.full((cap, 3), 1.0e6, np.float32)
        msk = np.zeros(cap, bool)
        pts[: len(s)] = s
        msk[: len(s)] = True
        padded.append((pts, msk))
        det.add_keyframe(pts, msk, position=gt[i][:3, 3])
    # query the final keyframe (back near the start)
    q = len(scans) - 1
    cands = det.candidates(q)
    assert cands, "no candidates returned"
    best = cands[0]
    assert best.match_idx <= 3, f"revisit not detected: {best}"
    T_pred = np.linalg.inv(gt[best.match_idx]) @ gt[q]  # odometry estimate role
    lc = det.verify(
        best,
        padded[q][0], padded[q][1],
        padded[best.match_idx][0], padded[best.match_idx][1],
        T_pred=T_pred,
    )
    assert lc is not None, "verification rejected a true loop"
    # compare measured relative transform against GT
    T_gt = np.linalg.inv(gt[best.match_idx]) @ gt[q]
    t_err = np.linalg.norm(lc.T_ij[:3, 3] - T_gt[:3, 3])
    assert t_err < 0.5, f"loop transform off by {t_err} m"


def _loop_fixture(cfg):
    scans, gt = synthetic.velodyne_log(
        n_frames=24, n_rings=12, n_azimuth=256, loop=True
    )
    det = LoopDetector(cfg)
    cap = 1536
    pts_all = np.full((len(scans), cap, 3), 1.0e6, np.float32)
    msk_all = np.zeros((len(scans), cap), bool)
    for i in range(len(scans)):
        s = voxel_downsample_np(scans[i], 0.5)[:cap]
        pts_all[i, : len(s)] = s
        msk_all[i, : len(s)] = True
        det.add_keyframe(pts_all[i], msk_all[i], position=gt[i][:3, 3])
    return det, pts_all, msk_all, gt


def test_verify_keyframe_candidates_strided_lean_yaws():
    """The r5 backend cost levers (BASELINE.md r4 backend wall):
    verification at stride 2 with a 4-yaw basket must still
    accept the true revisit with an accurate transform."""
    cfg = BackendConfig(
        enabled=True, min_loop_separation=12, candidate_topk=3,
        verify_max_rmse=0.6, gating_radius=15.0, verify_max_dev=5.0,
        verify_stride=2, verify_yaws=4,
    )
    det, pts_all, msk_all, gt = _loop_fixture(cfg)
    q = len(pts_all) - 1
    kf_frames = list(range(len(pts_all)))
    kf_poses = [gt[i] for i in range(len(pts_all))]
    n, lcs = det.verify_keyframe_candidates(
        q, pts_all[q], msk_all[q], pts_all, msk_all,
        kf_frames, kf_poses, gt[q],
    )
    assert n > 0 and lcs, "strided verification rejected the true loop"
    lc = lcs[0]
    T_gt = np.linalg.inv(gt[lc.i]) @ gt[lc.j]
    t_err = np.linalg.norm(lc.T_ij[:3, 3] - T_gt[:3, 3])
    assert t_err < 0.5, f"strided loop transform off by {t_err} m"


def test_closure_dedup_skips_already_closed_region():
    """closure_dedup_kf: once a closure links a revisit region, nearby
    (query, match) candidates are dropped before the verify dispatch."""
    cfg = BackendConfig(
        enabled=True, min_loop_separation=12, candidate_topk=3,
        verify_max_rmse=0.6, gating_radius=15.0, verify_max_dev=5.0,
        closure_dedup_kf=4,
    )
    det, pts_all, msk_all, gt = _loop_fixture(cfg)
    kf_frames = list(range(len(pts_all)))
    kf_poses = [gt[i] for i in range(len(pts_all))]
    q = len(pts_all) - 2
    n1, lcs1 = det.verify_keyframe_candidates(
        q, pts_all[q], msk_all[q], pts_all, msk_all,
        kf_frames, kf_poses, gt[q],
    )
    assert lcs1, "fixture did not produce a first closure"
    # the next keyframe revisits the SAME region: with the accepted list
    # passed, every candidate falls inside the dedup window — no dispatch
    q2 = q + 1
    n2, lcs2 = det.verify_keyframe_candidates(
        q2, pts_all[q2], msk_all[q2], pts_all, msk_all,
        kf_frames, kf_poses, gt[q2], lcs1,
    )
    assert n2 == 0 and lcs2 == [], (n2, [(lc.i, lc.j) for lc in lcs2])
    # without the accepted list the same call verifies again (control)
    n3, _ = det.verify_keyframe_candidates(
        q2, pts_all[q2], msk_all[q2], pts_all, msk_all,
        kf_frames, kf_poses, gt[q2],
    )
    assert n3 > 0


def test_relocalize_in_keyframe_map():
    """Kidnapped-robot: place a scan in the map with no prior."""
    scans, gt = synthetic.velodyne_log(
        n_frames=20, n_rings=12, n_azimuth=256, path_fraction=0.5
    )
    cfg = BackendConfig(verify_max_rmse=0.6, verify_max_dev=0.0)
    det = LoopDetector(cfg)
    cap = 1536
    store = []
    poses = []
    for i in range(0, 20, 2):  # keyframes: every other frame
        s = voxel_downsample_np(scans[i], 0.5)[:cap]
        pts = np.full((cap, 3), 1.0e6, np.float32)
        msk = np.zeros(cap, bool)
        pts[: len(s)] = s
        msk[: len(s)] = True
        det.add_keyframe(pts, msk, position=gt[i][:3, 3])
        store.append((pts, msk))
        poses.append(gt[i])
    # query: a non-keyframe scan (frame 7), pose unknown to the system
    q = voxel_downsample_np(scans[7], 0.5)[:cap]
    qp = np.full((cap, 3), 1.0e6, np.float32)
    qm = np.zeros(cap, bool)
    qp[: len(q)] = q
    qm[: len(q)] = True
    out = det.relocalize(qp, qm, store, poses)
    assert out is not None, "relocalization failed on an in-map scan"
    pose, match_idx, rmse = out
    t_err = np.linalg.norm(pose[:3, 3] - gt[7][:3, 3])
    assert t_err < 1.0, f"relocalized {t_err} m off"
