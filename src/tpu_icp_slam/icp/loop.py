"""The ICP iteration driver: a single `lax.while_loop` on device (N9).

The reference's hot loop relaunched CUDA kernels per iteration with
per-iteration device→host copies of the reduced statistics (SURVEY.md §3a;
mount empty, §0). Here the whole iteration — correspondence, gating, solve,
pose update, convergence test — stays inside one compiled while_loop: the
host sees exactly one dispatch per `align` call, which is what the ≥3×
frames/s target rides on (SURVEY.md §3c).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, Optional

import jax
import jax.numpy as jnp
from jax import lax

from tpu_icp_slam.config import ICPConfig
from tpu_icp_slam.core.pointcloud import PointCloud
from tpu_icp_slam.icp.point_to_point import umeyama_masked
from tpu_icp_slam.icp.point_to_plane import gauss_newton_step
from tpu_icp_slam.kernels.nn import nearest_neighbor


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ICPResult:
    T: jnp.ndarray  # (D+1, D+1) transform: dst_frame <- src_frame
    rmse: jnp.ndarray  # inlier RMS correspondence distance at convergence
    iters: jnp.ndarray  # iterations executed
    n_inliers: jnp.ndarray  # gated correspondences in the final iteration
    converged: jnp.ndarray  # bool: tol reached before max_iters


def _nn_correspondence(cfg: ICPConfig, dst: PointCloud):
    """Returns corr(points) -> (q, n, w_gate, d2): NN into dst + distance gate."""
    max_d2 = cfg.max_corr_dist * cfg.max_corr_dist

    grid = None
    if cfg.nn_backend == "voxel":
        # hash-grid bucket NN (N4): exact within one voxel ring, so the search
        # voxel is the correspondence gate itself; built ONCE per align (the
        # target is fixed across ICP iterations), queried inside the loop
        if cfg.max_corr_dist >= 1e6:
            raise ValueError("nn_backend='voxel' needs a finite max_corr_dist")
        from tpu_icp_slam.kernels import voxel_nn

        grid = voxel_nn.build(
            dst.points,
            dst.mask,
            voxel=cfg.max_corr_dist,
            table_size=cfg.voxel_table_size,
            bucket=cfg.voxel_bucket,
        )

    def corr(cur_pts: jnp.ndarray):
        if grid is not None:
            from tpu_icp_slam.kernels import voxel_nn

            idx, _ = voxel_nn.query(grid, cur_pts, voxel=cfg.max_corr_dist)
        else:
            idx, _ = nearest_neighbor(
                cur_pts, dst.points, backend=cfg.nn_backend, chunk=cfg.nn_chunk,
            )
        q = dst.points[idx]
        n = dst.normals[idx] if dst.normals is not None else None
        # recompute distances in difference form: the XLA version's factored
        # ‖a‖²+‖b‖²−2ab suffers f32 cancellation (~1e-3 floor at scene scale),
        # fine for argmin but not for gating thresholds or the reported rmse
        diff = cur_pts - q
        d2 = jnp.sum(diff * diff, axis=-1)
        if cfg.corr_range_rate > 0.0:
            # angular allowance: widen the gate with point range so a
            # prediction-lagged rotation stays visible to the solve
            # (see ICPConfig.corr_range_rate)
            rng_ = jnp.sqrt(jnp.sum(cur_pts * cur_pts, axis=-1))
            gate_p = cfg.max_corr_dist + cfg.corr_range_rate * rng_
            gate = (d2 <= gate_p * gate_p).astype(cur_pts.dtype)
        else:
            gate = (d2 <= max_d2).astype(cur_pts.dtype)
        return q, n, gate, d2

    return corr


@partial(jax.jit, static_argnames=("cfg",))
def align(
    src: PointCloud,
    dst: PointCloud,
    init_T: Optional[jnp.ndarray] = None,
    cfg: ICPConfig = ICPConfig(),
) -> ICPResult:
    """Align src onto dst: returns T such that T @ src ≈ dst (least squares)."""
    corr_fn = _nn_correspondence(cfg, dst)
    return align_with_correspondence(src, corr_fn, init_T, cfg)


def align_with_correspondence(
    src: PointCloud,
    corr_fn: Callable,
    init_T: Optional[jnp.ndarray],
    cfg: ICPConfig,
) -> ICPResult:
    """ICP with a pluggable correspondence function (NN / projective / map).

    corr_fn(cur_pts (M,D)) -> (q (M,D) targets, n (M,D) normals or None,
    gate (M,) 0/1 weights, d2 (M,) squared distances).
    Not jitted itself — call under jit (align above) or inside a pipeline step.
    """
    d = src.dim
    dtype = src.points.dtype
    T0 = jnp.eye(d + 1, dtype=dtype) if init_T is None else init_T.astype(dtype)
    src_mask_f = src.mask.astype(dtype)
    # Huber weights operate on distances; delta<=0 disables
    huber = cfg.huber_delta
    if d == 3:
        from tpu_icp_slam.core import se3 as _lie
    else:
        from tpu_icp_slam.core import se2 as _lie
    k_twist = 6 if d == 3 else 3
    trust_region = cfg.max_total_trans > 0.0 or cfg.max_total_rot > 0.0
    # prior/trust anchor: inverse of the init pose, built once outside the loop
    _T0_inv = jnp.linalg.inv(T0) if (
        cfg.prior_trans_weight > 0.0 or cfg.prior_rot_weight > 0.0
        or trust_region
    ) else None

    def body(state):
        T, prev_rmse, _, it, _, _, f_prev, g_prev = state
        cur = src.points @ T[:d, :d].T + T[:d, d]
        q, n, gate, d2 = corr_fn(cur)
        w = gate * src_mask_f
        if huber > 0.0:
            dist = jnp.sqrt(jnp.maximum(d2, 1e-20))
            w = w * jnp.minimum(1.0, huber / dist)
        n_inl = jnp.sum(w > 0, dtype=jnp.int32)
        if cfg.method == "point_to_plane":
            if n is None:
                raise ValueError("point_to_plane requires target normals")
            prior_w = xi_prior = None
            if cfg.prior_trans_weight > 0.0 or cfg.prior_rot_weight > 0.0:
                # motion-model prior, anchored at the init pose T0 (= the
                # prediction in scan_to_map): cost λ/2‖xi + log(T·T0⁻¹)‖²
                # per axis. First-order BCH linearization of
                # ‖log(exp(xi)·T·T0⁻¹)‖² — exact enough at per-iteration
                # step sizes; holds degenerate directions at the prediction
                # instead of letting them follow correspondence noise.
                # λ = weight_fraction × Σw (RELATIVE to the frame's own
                # point evidence): an absolute λ that is negligible at 10k
                # inliers is pose-freezing at 1k (measured r3 small-scale
                # endurance: λt=30 abs stalled the pipeline dead on a
                # straight leg at 1.5k-point scans).
                wsum_pr = jnp.maximum(jnp.sum(w), 1e-6)
                prior_w = wsum_pr * jnp.asarray(
                    [cfg.prior_trans_weight] * d
                    + [cfg.prior_rot_weight] * (k_twist - d),
                    dtype,
                )
                xi_prior = _lie.log(T @ _T0_inv)
            dT = gauss_newton_step(
                cur, q, n, w,
                damping=cfg.damping,
                max_step_trans=cfg.max_step_trans,
                max_step_rot=cfg.max_step_rot,
                degen_eps=cfg.degen_eps,
                prior_w=prior_w,
                xi_prior=xi_prior,
            )
        else:
            dT = umeyama_masked(cur, q, w)
        if cfg.step_scale != 1.0:
            # over-relaxation: scale the update twist — correspondence-lagged
            # ICP steps undershoot, so β ∈ (1, 2) cuts iteration counts
            dT = _lie.exp(cfg.step_scale * _lie.log(dT))
        # degenerate-correspondence guard: with too few inliers the solve is
        # meaningless — hold the pose (the motion-model init survives)
        min_inl = max(cfg.min_inliers, d + 1)
        dT = jnp.where(n_inl >= min_inl, dT, jnp.eye(d + 1, dtype=dtype))
        T_plain = dT @ T

        if cfg.anderson:
            # AA(1) on the fixed-point map T ↦ dT·T, in twist coordinates:
            #   x = log(T), g = log(dT·T), f = g − x
            #   x⁺ = g − γ (g − g_prev),  γ = fᵀ(f − f_prev)/‖f − f_prev‖²
            # Safeguarded: clamp γ and fall back to the plain step when the
            # residual grew (AA-ICP, Pavlov et al. 2017 — PAPERS.md).
            x = _lie.log(T)
            g = _lie.log(T_plain)
            f = g - x
            df = f - f_prev
            denom = jnp.sum(df * df)
            gamma = jnp.where(
                denom > 1e-20, jnp.sum(f * df) / jnp.maximum(denom, 1e-20), 0.0
            )
            gamma = jnp.clip(gamma, -1.0, 1.0)
            x_aa = g - gamma * (g - g_prev)
            # safeguard: first iteration (f_prev = +big) or growing residual
            use_aa = jnp.logical_and(
                it > 0, jnp.linalg.norm(f) <= jnp.linalg.norm(f_prev)
            )
            T_new = jnp.where(use_aa, _lie.exp(x_aa), T_plain)
            f_next, g_next = f, g
        else:
            T_new = T_plain
            f_next, g_next = f_prev, g_prev

        if trust_region:
            # project the TOTAL correction back onto the trust-region ball
            # around the init pose (see ICPConfig.max_total_trans): the loop
            # keeps refining, but never walks beyond the prediction-error
            # scale — the front-end's defense against aliased-basin capture
            xi_tot = _lie.log(T_new @ _T0_inv)
            s = jnp.asarray(1.0, dtype)
            if cfg.max_total_trans > 0.0:
                tn = jnp.linalg.norm(xi_tot[:d])
                s = jnp.minimum(
                    s, cfg.max_total_trans / jnp.maximum(tn, 1e-12)
                )
            if cfg.max_total_rot > 0.0:
                rn = jnp.linalg.norm(xi_tot[d:])
                s = jnp.minimum(
                    s, cfg.max_total_rot / jnp.maximum(rn, 1e-12)
                )
            T_new = jnp.where(s < 1.0, _lie.exp(s * xi_tot) @ T0, T_new)

        wsum = jnp.maximum(jnp.sum(w), 1e-12)
        rmse = jnp.sqrt(jnp.sum(w * d2) / wsum)
        converged = jnp.abs(prev_rmse - rmse) < cfg.tol
        if cfg.tol_update > 0.0:
            step_mag = jnp.linalg.norm(dT[:d, d]) + jnp.linalg.norm(
                dT[:d, :d] - jnp.eye(d, dtype=dtype)
            )
            converged = jnp.logical_or(converged, step_mag < cfg.tol_update)
        return (T_new, rmse, rmse, it + 1, n_inl, converged, f_next, g_next)

    def cond(state):
        it = state[3]
        converged = state[5]
        return jnp.logical_and(it < cfg.max_iters, jnp.logical_not(converged))

    init = (
        T0,
        jnp.asarray(jnp.inf, dtype),
        jnp.asarray(jnp.inf, dtype),
        jnp.asarray(0, jnp.int32),
        jnp.asarray(0, jnp.int32),
        jnp.asarray(False),
        jnp.full((k_twist,), 1e6, dtype),  # f_prev sentinel (first iter)
        jnp.zeros((k_twist,), dtype),
    )
    if cfg.unroll_iters > 0:
        # trace-time unrolled: straight-line code, no per-iteration loop
        # control on the device. Convergence still honored by freezing the
        # carried state once `converged` goes true, so results match the
        # while_loop whenever unroll_iters >= iterations needed.
        state = init
        for _ in range(cfg.unroll_iters):
            # freeze on convergence OR the max_iters cap — same stopping
            # rule as the while_loop cond (review r2: without the cap check
            # the unrolled path iterated past max_iters)
            done = jnp.logical_or(state[5], state[3] >= cfg.max_iters)
            new_state = body(state)
            state = tuple(
                jnp.where(done, o, n) for n, o in zip(new_state, state)
            )
        T, rmse, _, iters, n_inl, converged, _, _ = state
    else:
        T, rmse, _, iters, n_inl, converged, _, _ = lax.while_loop(
            cond, body, init
        )
    return ICPResult(T=T, rmse=rmse, iters=iters, n_inliers=n_inl, converged=converged)
