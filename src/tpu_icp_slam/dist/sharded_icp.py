"""Distributed ICP: batch over "dp", source points sharded over "sp" (N15).

The SLAM analogue of sharding a big matmul (SURVEY.md §2b "Spatial/tensor
parallel"): the M×N distance matrix of the NN search tiles over devices along
the source axis. Each "sp" shard searches its slice of source points against
the (replicated per-"dp"-row) target cloud, computes *local* solve statistics
— raw Umeyama moments (point-to-point) or the 6×6 normal equations H, g
(point-to-plane) — and a single `lax.psum` over "sp" reduces them; every shard
then solves the same tiny system, keeping the transform replicated without a
broadcast. The whole ICP while_loop stays inside one `shard_map`, so there is
exactly one collective pattern per iteration and zero host round-trips.

The reference has no multi-device path at all (SURVEY.md §2a; mount empty,
§0) — this layer is the driver-mandated extension (BASELINE.json config 5).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P

from tpu_icp_slam.config import ICPConfig
from tpu_icp_slam.core import se2, se3
from tpu_icp_slam.icp.loop import ICPResult
from tpu_icp_slam.icp.point_to_plane import build_normal_equations, solve_increment
from tpu_icp_slam.icp.point_to_point import moments, umeyama_from_moments
from tpu_icp_slam.kernels.nn import nearest_neighbor


def _align_shard(
    src_pts: jnp.ndarray,  # (Ms, D) local source shard
    src_msk: jnp.ndarray,  # (Ms,)
    dst_pts: jnp.ndarray,  # (N, D) full target (replicated over "sp")
    dst_nrm: jnp.ndarray,  # (N, D) target normals (zeros if unused)
    T0: jnp.ndarray,  # (D+1, D+1)
    *,
    cfg: ICPConfig,
    axis_name: str,
) -> ICPResult:
    """Per-shard ICP loop body; statistics psum-reduced over `axis_name`."""
    d = src_pts.shape[-1]
    dtype = src_pts.dtype
    max_d2 = cfg.max_corr_dist * cfg.max_corr_dist
    mskf = src_msk.astype(dtype)
    huber = cfg.huber_delta

    def body(state):
        T, prev_rmse, _, it, _, _ = state
        cur = src_pts @ T[:d, :d].T + T[:d, d]
        idx, _ = nearest_neighbor(
            cur, dst_pts, backend=cfg.nn_backend, chunk=cfg.nn_chunk,
        )
        q = dst_pts[idx]
        diff = cur - q
        d2 = jnp.sum(diff * diff, axis=-1)
        w = (d2 <= max_d2).astype(dtype) * mskf
        if huber > 0.0:
            dist = jnp.sqrt(jnp.maximum(d2, 1e-20))
            w = w * jnp.minimum(1.0, huber / dist)
        if cfg.method == "point_to_plane":
            n = dst_nrm[idx]
            # per-shard normal equations, then the psum reduces the 6×6
            H, g = build_normal_equations(cur, q, n, w)
            H = lax.psum(H, axis_name)
            g = lax.psum(g, axis_name)
            xi = solve_increment(
                H, g, cfg.damping, cfg.max_step_trans, cfg.max_step_rot
            )
            dT = se3.exp(xi) if d == 3 else se2.exp(xi)
        else:
            m = lax.psum(moments(cur, q, w), axis_name)
            dT = umeyama_from_moments(*m)
        stats = lax.psum(
            jnp.stack([jnp.sum(w), jnp.sum(w * d2), jnp.sum(w > 0).astype(dtype)]),
            axis_name,
        )
        min_inl = max(cfg.min_inliers, d + 1)
        dT = jnp.where(stats[2] >= min_inl, dT, jnp.eye(d + 1, dtype=dtype))
        T_new = dT @ T
        rmse = jnp.sqrt(stats[1] / jnp.maximum(stats[0], 1e-12))
        converged = jnp.abs(prev_rmse - rmse) < cfg.tol
        return (T_new, rmse, rmse, it + 1, stats[2].astype(jnp.int32), converged)

    def cond(state):
        _, _, _, it, _, converged = state
        return jnp.logical_and(it < cfg.max_iters, jnp.logical_not(converged))

    init = (
        T0.astype(dtype),
        jnp.asarray(jnp.inf, dtype),
        jnp.asarray(jnp.inf, dtype),
        jnp.asarray(0, jnp.int32),
        jnp.asarray(0, jnp.int32),
        jnp.asarray(False),
    )
    T, rmse, _, iters, n_inl, converged = lax.while_loop(cond, body, init)
    return ICPResult(T=T, rmse=rmse, iters=iters, n_inliers=n_inl, converged=converged)


def make_sharded_align(
    mesh: jax.sharding.Mesh,
    cfg: ICPConfig,
    batch_axis: str = "dp",
    point_axis: str = "sp",
):
    """Compile a batched, point-sharded ICP align over `mesh`.

    Returns fn(src_pts (B, M, D), src_msk (B, M), dst_pts (B, N, D),
    dst_nrm (B, N, D), T0 (B, D+1, D+1)) -> ICPResult with leading (B,).
    B must divide mesh[batch_axis], M must divide mesh[point_axis].
    """
    in_specs = (
        P(batch_axis, point_axis, None),
        P(batch_axis, point_axis),
        P(batch_axis, None, None),
        P(batch_axis, None, None),
        P(batch_axis, None, None),
    )
    out_specs = jax.tree_util.tree_map(
        lambda _: P(batch_axis),
        ICPResult(T=0, rmse=0, iters=0, n_inliers=0, converged=0),
    )
    inner = partial(_align_shard, cfg=cfg, axis_name=point_axis)

    @partial(
        jax.shard_map, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
        check_vma=False,
    )
    def _sharded(src_pts, src_msk, dst_pts, dst_nrm, T0):
        return jax.vmap(inner)(src_pts, src_msk, dst_pts, dst_nrm, T0)

    return jax.jit(_sharded)


@dataclasses.dataclass(frozen=True)
class ShardedAligner:
    """Convenience wrapper caching the compiled sharded align."""

    mesh: jax.sharding.Mesh
    cfg: ICPConfig

    def __post_init__(self):
        object.__setattr__(
            self, "_fn", make_sharded_align(self.mesh, self.cfg)
        )

    def __call__(self, src_pts, src_msk, dst_pts, dst_nrm=None, T0=None) -> ICPResult:
        b, _, d = src_pts.shape
        if dst_nrm is None:
            dst_nrm = jnp.zeros_like(dst_pts)
        if T0 is None:
            T0 = jnp.broadcast_to(
                jnp.eye(d + 1, dtype=src_pts.dtype), (b, d + 1, d + 1)
            )
        # pad the batch to a multiple of the dp mesh axis (repeat row 0 —
        # cheap: padded problems converge identically in parallel)
        dp = self.mesh.shape["dp"]
        bp = -(-b // dp) * dp
        if bp != b:
            tile = lambda x: jnp.pad(
                x, [(0, bp - b)] + [(0, 0)] * (x.ndim - 1), mode="edge"
            )
            src_pts, src_msk, dst_pts, dst_nrm, T0 = map(
                tile, (src_pts, src_msk, dst_pts, dst_nrm, T0)
            )
        res = self._fn(src_pts, src_msk, dst_pts, dst_nrm, T0)
        if bp != b:
            res = jax.tree_util.tree_map(lambda x: x[:b], res)
        return res
