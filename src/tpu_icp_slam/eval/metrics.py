"""Trajectory / transform accuracy metrics (NumPy, host-side).

ATE RMSE with Umeyama alignment and RPE — the accuracy north star of
BASELINE.json ("ATE RMSE vs reference ICP trajectory"). The reference repo has
no metrics code (validation was visual; SURVEY.md §4a), so these follow the
standard TUM-benchmark definitions.
"""

from __future__ import annotations

import numpy as np


def umeyama_alignment(src: np.ndarray, dst: np.ndarray, with_scale: bool = False):
    """Least-squares similarity transform aligning src -> dst, (N, D) each.

    Returns (R, t, s) with dst ≈ s * R @ src + t.
    """
    src = np.asarray(src, dtype=np.float64)
    dst = np.asarray(dst, dtype=np.float64)
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / src.shape[0]
    U, S, Vt = np.linalg.svd(cov)
    d = src.shape[1]
    sign = np.sign(np.linalg.det(U @ Vt))
    D = np.eye(d)
    D[-1, -1] = sign
    R = U @ D @ Vt
    if with_scale:
        var_s = (xs**2).sum() / src.shape[0]
        s = float(np.trace(np.diag(S) @ D) / var_s)
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return R, t, s


def ate_rmse(est_positions: np.ndarray, gt_positions: np.ndarray, align: bool = True) -> float:
    """Absolute trajectory error RMSE over (N, D) position sequences."""
    est = np.asarray(est_positions, dtype=np.float64)
    gt = np.asarray(gt_positions, dtype=np.float64)
    assert est.shape == gt.shape, (est.shape, gt.shape)
    if align:
        R, t, _ = umeyama_alignment(est, gt)
        est = est @ R.T + t
    err = est - gt
    return float(np.sqrt((err**2).sum(axis=1).mean()))


def rpe(est_poses: np.ndarray, gt_poses: np.ndarray, delta: int = 1):
    """Relative pose error over (N, 4, 4) (or (N, 3, 3) SE(2)) pose sequences.

    Returns (trans_rmse, rot_rmse_rad).
    """
    est = np.asarray(est_poses, dtype=np.float64)
    gt = np.asarray(gt_poses, dtype=np.float64)
    n = est.shape[0]
    d = est.shape[-1] - 1
    terrs, rerrs = [], []
    for i in range(n - delta):
        de = np.linalg.inv(est[i]) @ est[i + delta]
        dg = np.linalg.inv(gt[i]) @ gt[i + delta]
        e = np.linalg.inv(dg) @ de
        terrs.append(np.linalg.norm(e[:d, d]))
        rerrs.append(rotation_angle(e[:d, :d]))
    return float(np.sqrt(np.mean(np.square(terrs)))), float(
        np.sqrt(np.mean(np.square(rerrs)))
    )


def transform_error(T_est: np.ndarray, T_gt: np.ndarray):
    """(rotation geodesic radians, translation L2) between two transforms."""
    T_est = np.asarray(T_est, dtype=np.float64)
    T_gt = np.asarray(T_gt, dtype=np.float64)
    d = T_est.shape[-1] - 1
    E = np.linalg.inv(T_gt) @ T_est
    return rotation_angle(E[:d, :d]), float(np.linalg.norm(E[:d, d]))


def rotation_angle(R: np.ndarray) -> float:
    """Angle (radians) of a 2×2 or 3×3 rotation, as atan2 of its sine and
    cosine parts: arccos of the trace alone turns f32 rounding in the matrix
    (~1e-7) into ~1e-3 rad near zero."""
    d = R.shape[0]
    if d == 2:
        sin = 0.5 * (R[1, 0] - R[0, 1])
    else:
        sin = 0.5 * np.linalg.norm(
            [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    cos = (np.trace(R) - (d - 2)) / 2.0
    return float(abs(np.arctan2(sin, cos)))
