import numpy as np

from tpu_icp_slam.datasets import synthetic
from tpu_icp_slam.eval import golden, metrics


def test_umeyama_alignment_recovers_transform():
    rng = np.random.default_rng(0)
    src = rng.standard_normal((200, 3))
    T = synthetic.rigid_transform(3, rng)
    dst = src @ T[:3, :3].T + T[:3, 3]
    R, t, s = metrics.umeyama_alignment(src, dst)
    np.testing.assert_allclose(R, T[:3, :3], atol=1e-10)
    np.testing.assert_allclose(t, T[:3, 3], atol=1e-10)
    assert abs(s - 1.0) < 1e-12


def test_ate_zero_for_identical():
    traj = np.random.default_rng(1).standard_normal((50, 3))
    assert metrics.ate_rmse(traj, traj) < 1e-12


def test_golden_icp_recovers_synthetic_offset_3d():
    src, dst, T_gt = synthetic.two_scan_pair(n=2000, seed=3, rot_scale=0.2, trans_scale=0.3)
    res = golden.icp_point_to_point(src, dst, max_iters=60)
    rot_err, trans_err = metrics.transform_error(res.T, T_gt)
    assert rot_err < 1e-4, rot_err
    assert trans_err < 1e-4, trans_err


def test_golden_icp_2d():
    src, dst, T_gt = synthetic.two_scan_pair(n=1500, seed=4, dim=2, rot_scale=0.15, trans_scale=0.3)
    res = golden.icp_point_to_point(src, dst, max_iters=80)
    rot_err, trans_err = metrics.transform_error(res.T, T_gt)
    assert rot_err < 2e-3, rot_err
    assert trans_err < 2e-3, trans_err


def test_golden_point_to_plane():
    rng = np.random.default_rng(5)
    # planar-ish scene with normals: sample from 3 planes
    n_per = 500
    pts, nrms = [], []
    for n, d in [((0, 0, 1.0), 0.0), ((0, 1.0, 0), 3.0), ((1.0, 0, 0), 2.0)]:
        n = np.asarray(n, dtype=np.float64)
        basis = np.linalg.svd(n[None])[2][1:]
        uv = rng.uniform(-2, 2, size=(n_per, 2))
        pts.append(uv @ basis + d * n)
        nrms.append(np.tile(n, (n_per, 1)))
    dst = np.concatenate(pts)
    dst_n = np.concatenate(nrms)
    T_gt = synthetic.rigid_transform(3, rng, rot_scale=0.05, trans_scale=0.1)
    # src such that T_gt @ src = dst
    Ti = np.linalg.inv(T_gt)
    src = dst @ Ti[:3, :3].T + Ti[:3, 3]
    res = golden.icp_point_to_plane(src, dst, dst_n, max_iters=30)
    rot_err, trans_err = metrics.transform_error(res.T, T_gt)
    assert rot_err < 1e-5
    assert trans_err < 1e-5


def test_golden_odometry_on_sim_2d_log():
    # Scan-to-scan point-to-point odometry drifts ~0.5-1% in a corridor world
    # (longitudinal near-degeneracy); this bounds the drift, while pipeline-vs-golden
    # *agreement* is the tight accuracy check (see pipeline tests).
    log = synthetic.lidar2d_log(n_frames=60, n_beams=360, seed=0, noise=0.002)
    scans = [
        synthetic.scan_to_points(log.ranges[i], log.angles, log.max_range)
        for i in range(len(log.ranges))
    ]
    poses = golden.odometry(scans, max_iters=50, max_corr_dist=0.5)
    est_xy = poses[:, :2, 2]
    gt_xy = log.gt_poses[:, :2, 2]
    ate = metrics.ate_rmse(est_xy, gt_xy)
    assert ate < 0.3, ate


def test_rpe_identity():
    rng = np.random.default_rng(6)
    poses = np.stack([synthetic.rigid_transform(3, rng) for _ in range(10)])
    t_err, r_err = metrics.rpe(poses, poses)
    assert t_err < 1e-12 and r_err < 1e-6
