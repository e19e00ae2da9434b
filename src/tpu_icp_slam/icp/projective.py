"""Projective data association for RGB-D ICP (SURVEY.md §2b N7).

KinectFusion-style frame-to-model association: instead of searching neighbors,
transform each source point into the target camera, project it through the
intrinsics, and read the correspondence off the target's vertex/normal maps.
O(M) gathers, no distance matrix at all — the cheapest correspondence there is.

Capability required by BASELINE.json config 3 (TUM fr1/xyz); the reference
had no RGB-D path (SURVEY.md §2a).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp


class CameraIntrinsics(NamedTuple):
    """Static (hashable) pinhole intrinsics for jit closures."""

    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int


def backproject_depth(
    depth: jnp.ndarray, K: CameraIntrinsics
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(H, W) depth -> ((H, W, 3) camera-frame vertex map, (H, W) validity)."""
    h, w = depth.shape
    us = jnp.arange(w, dtype=jnp.float32)[None, :]
    vs = jnp.arange(h, dtype=jnp.float32)[:, None]
    x = (us - K.cx) / K.fx * depth
    y = (vs - K.cy) / K.fy * depth
    valid = depth > 0
    return jnp.stack([x, y, depth], axis=-1), valid


def projective_correspondence(
    K: CameraIntrinsics,
    dst_vertex: jnp.ndarray,  # (H, W, 3) target camera frame
    dst_normal: jnp.ndarray,  # (H, W, 3)
    dst_valid: jnp.ndarray,  # (H, W) bool
    max_corr_dist: float,
    normal_gate_cos: float = -1.0,
    src_normals: jnp.ndarray | None = None,  # (M, 3) in the *current* frame
):
    """Returns corr(cur_pts (M,3)) -> (q, n, gate, d2) for icp.loop.

    cur_pts must already be expressed in the target camera frame (the ICP
    loop applies the running transform before calling corr).
    """
    h, w = dst_valid.shape
    max_d2 = max_corr_dist * max_corr_dist

    def corr(cur_pts: jnp.ndarray):
        z = cur_pts[:, 2]
        safe_z = jnp.where(z > 1e-6, z, 1.0)
        u = cur_pts[:, 0] / safe_z * K.fx + K.cx
        v = cur_pts[:, 1] / safe_z * K.fy + K.cy
        ui = jnp.clip(jnp.round(u).astype(jnp.int32), 0, w - 1)
        vi = jnp.clip(jnp.round(v).astype(jnp.int32), 0, h - 1)
        inb = (
            (z > 1e-6)
            & (u >= -0.5)
            & (u <= w - 0.5)
            & (v >= -0.5)
            & (v <= h - 0.5)
        )
        q = dst_vertex[vi, ui]  # (M, 3)
        n = dst_normal[vi, ui]
        ok = inb & dst_valid[vi, ui]
        diff = cur_pts - q
        d2 = jnp.sum(diff * diff, axis=-1)
        gate = ok & (d2 <= max_d2)
        if src_normals is not None and normal_gate_cos > -1.0:
            cos = jnp.sum(src_normals * n, axis=-1)
            gate = gate & (cos >= normal_gate_cos)
        return q, n, gate.astype(cur_pts.dtype), d2

    return corr
