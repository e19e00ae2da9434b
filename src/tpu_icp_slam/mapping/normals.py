"""Normal estimation (SURVEY.md §2b N8).

Two paths:
- organized depth maps: cross products of central differences of the vertex
  map (used by projective RGB-D ICP, config 3);
- unorganized clouds: k-NN plane fit via the smallest eigenvector of the
  local covariance (reuses the NN kernels; batched eigh of 3x3 is cheap).

No reference equivalent (the CUDA app was point-to-point only; SURVEY.md §2a).
"""

from __future__ import annotations

import jax.numpy as jnp

from tpu_icp_slam.kernels.nn_xla import knn_bruteforce_xla


def normals_from_depth(
    vertex_map: jnp.ndarray, valid: jnp.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(H, W, 3) camera-frame vertex map -> (H, W, 3) unit normals + validity.

    Normals are oriented toward the camera (n_z < 0 for a camera looking
    down +z onto a surface).
    """
    dx = jnp.roll(vertex_map, -1, axis=1) - jnp.roll(vertex_map, 1, axis=1)
    dy = jnp.roll(vertex_map, -1, axis=0) - jnp.roll(vertex_map, 1, axis=0)
    n = jnp.cross(dx, dy)
    norm = jnp.linalg.norm(n, axis=-1, keepdims=True)
    n = n / jnp.maximum(norm, 1e-12)
    # orient toward camera: flip if pointing away from the origin ray
    flip = jnp.sum(n * vertex_map, axis=-1, keepdims=True) > 0
    n = jnp.where(flip, -n, n)
    ok = (
        valid
        & jnp.roll(valid, -1, axis=1)
        & jnp.roll(valid, 1, axis=1)
        & jnp.roll(valid, -1, axis=0)
        & jnp.roll(valid, 1, axis=0)
        & (norm[..., 0] > 1e-12)
    )
    # border rolls wrap around: kill the 1-pixel frame
    ok = ok.at[0, :].set(False).at[-1, :].set(False)
    ok = ok.at[:, 0].set(False).at[:, -1].set(False)
    return jnp.where(ok[..., None], n, 0.0), ok


def smallest_eigvec_sym3(C: jnp.ndarray) -> jnp.ndarray:
    """Batched smallest eigenvector of symmetric 3x3 matrices, closed form.

    (..., 3, 3) -> (..., 3) unit vectors. Trigonometric eigenvalue formula
    (Smith 1961 / Eberly's robust variant) + cross-product eigenvector
    extraction: rows of (C − λ_min I) span the plane orthogonal to the
    eigenvector, so the largest cross product of row pairs IS the
    eigenvector. All elementwise ops — replaces `jnp.linalg.eigh`, whose
    iterative batched path was the dominant cost of keyframe normal
    estimation (r2 op-cost profile, BASELINE.md).
    """
    dt = C.dtype
    tr = jnp.trace(C, axis1=-2, axis2=-1)
    q = tr / 3.0
    c00, c11, c22 = C[..., 0, 0], C[..., 1, 1], C[..., 2, 2]
    c01, c02, c12 = C[..., 0, 1], C[..., 0, 2], C[..., 1, 2]
    p1 = c01 * c01 + c02 * c02 + c12 * c12
    p2 = (c00 - q) ** 2 + (c11 - q) ** 2 + (c22 - q) ** 2 + 2.0 * p1
    p = jnp.sqrt(jnp.maximum(p2 / 6.0, 1e-30))
    eye = jnp.eye(3, dtype=dt)
    B = (C - q[..., None, None] * eye) / p[..., None, None]
    detB = (
        B[..., 0, 0] * (B[..., 1, 1] * B[..., 2, 2] - B[..., 1, 2] * B[..., 2, 1])
        - B[..., 0, 1] * (B[..., 1, 0] * B[..., 2, 2] - B[..., 1, 2] * B[..., 2, 0])
        + B[..., 0, 2] * (B[..., 1, 0] * B[..., 2, 1] - B[..., 1, 1] * B[..., 2, 0])
    )
    r = jnp.clip(detB / 2.0, -1.0, 1.0)
    phi = jnp.arccos(r) / 3.0
    # λ_min = q + 2p cos(φ + 2π/3)
    lam_min = q + 2.0 * p * jnp.cos(phi + 2.0 * jnp.pi / 3.0)
    A = C - lam_min[..., None, None] * eye
    r0, r1, r2 = A[..., 0, :], A[..., 1, :], A[..., 2, :]
    c_01 = jnp.cross(r0, r1)
    c_02 = jnp.cross(r0, r2)
    c_12 = jnp.cross(r1, r2)
    cands = jnp.stack([c_01, c_02, c_12], axis=-2)  # (..., 3, 3)
    norms = jnp.sum(cands * cands, axis=-1)  # (..., 3)
    best = jnp.argmax(norms, axis=-1)
    v = jnp.take_along_axis(cands, best[..., None, None].astype(jnp.int32)
                            .repeat(3, axis=-1), axis=-2)[..., 0, :]
    vn = jnp.sqrt(jnp.sum(v * v, axis=-1, keepdims=True))
    # isotropic/degenerate neighborhoods (p→0 or all cross products ~0):
    # any unit vector is a valid eigenvector — fall back to +z
    fallback = jnp.zeros_like(v).at[..., 2].set(1.0)
    ok = vn[..., 0] > 1e-20
    return jnp.where(ok[..., None], v / jnp.maximum(vn, 1e-30), fallback)


def normals_knn(
    points: jnp.ndarray,
    mask: jnp.ndarray,
    k: int = 16,
    viewpoint: jnp.ndarray | None = None,
    ref_stride: int = 1,
    approx: bool = True,
    oversample: int = 0,
) -> jnp.ndarray:
    """(N, 3) cloud -> (N, 3) unit normals by local plane fit.

    Padded slots (mask False) get zero normals. Normals are oriented toward
    `viewpoint` (default: the origin, i.e. the sensor).

    ref_stride > 1 fits each point's plane against a strided SUBSET of the
    cloud (every ref_stride-th point): the N×N distance matrix — the
    dominant cost of keyframe normal estimation at 16k points — shrinks by
    the stride, while neighbors at ~stride× spacing still span the same
    local plane (street-scene surfaces are locally flat at metre scale).
    """
    ref = points if ref_stride <= 1 else points[::ref_stride]
    # approx=True: lax.approx_min_k (exact on the CPU and the GPU). With
    # oversample > 1 the approximate pass only PREFILTERS k·oversample
    # candidates and the exact top-k is chosen among them (recall → 1 at a
    # fraction of exact top_k's cost; see knn_bruteforce_xla).
    idx, _ = knn_bruteforce_xla(
        points, ref, k=k, approx=approx, oversample=oversample
    )
    nbrs = ref[idx]  # (N, k, 3)
    mu = jnp.mean(nbrs, axis=1, keepdims=True)
    x = nbrs - mu
    cov = jnp.einsum("nki,nkj->nij", x, x) / k  # (N, 3, 3)
    # smallest eigenvector of a symmetric 3x3 = plane normal (closed form,
    # in place of an iterative batched eigh)
    n = smallest_eigvec_sym3(cov)
    vp = jnp.zeros(3, points.dtype) if viewpoint is None else viewpoint
    to_sensor = vp[None, :] - points
    flip = jnp.sum(n * to_sensor, axis=-1, keepdims=True) < 0
    n = jnp.where(flip, -n, n)
    return jnp.where(mask[:, None], n, 0.0)
