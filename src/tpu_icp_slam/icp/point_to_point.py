"""Point-to-point rigid solve: masked/weighted Umeyama via SVD (N5).

The XLA replacement for the reference's reduction kernels + vendored
3x3 SVD device code (SURVEY.md §2a R7/R8; mount empty, §0): centroids and the
DxD cross-covariance are masked matmul reductions that XLA fuses, and the
tiny DxD SVD runs once per ICP iteration in fp32 via jnp.linalg.svd — batched
over leading dims when solving many pairs at once (backend verification uses
this with vmap).

Two entry forms:
- `umeyama_masked(src, dst, w)` — single-device, centered accumulation
  (numerically preferred).
- `moments(src, dst, w)` + `umeyama_from_moments(...)` — raw-moment form whose
  accumulator is a flat sum, so it distributes: each shard computes local
  moments, `lax.psum` reduces them, every shard solves the same tiny SVD
  (dist/sharded_icp.py). This is the SLAM analogue of tensor-parallel matmul
  reduction (SURVEY.md §2b "Parallelism strategies").
"""

from __future__ import annotations

import jax.numpy as jnp


def rigid_from_stats(
    cov: jnp.ndarray, mu_s: jnp.ndarray, mu_d: jnp.ndarray
) -> jnp.ndarray:
    """(..., D, D) cross-covariance + centroids -> (..., D+1, D+1) transform.

    cov = E_w[(dst - mu_d)(src - mu_s)^T]; SVD with reflection correction.
    """
    d = cov.shape[-1]
    U, _, Vt = jnp.linalg.svd(cov)
    # reflection correction: scale the last left-singular column by sign(det)
    sign = jnp.sign(jnp.linalg.det(U @ Vt))
    d_vec = jnp.ones(sign.shape + (d,), dtype=cov.dtype).at[..., -1].multiply(sign)
    R = (U * d_vec[..., None, :]) @ Vt
    t = mu_d - jnp.einsum("...ij,...j->...i", R, mu_s)
    batch = R.shape[:-2]
    T = jnp.zeros(batch + (d + 1, d + 1), dtype=cov.dtype)
    T = T.at[..., :d, :d].set(R)
    T = T.at[..., :d, d].set(t)
    T = T.at[..., d, d].set(1.0)
    return T


def umeyama_masked(
    src: jnp.ndarray,
    dst: jnp.ndarray,
    weights: jnp.ndarray,
) -> jnp.ndarray:
    """Weighted rigid least-squares: returns T (D+1, D+1) with dst ≈ R src + t.

    src, dst: (..., M, D) paired points; weights: (..., M) >= 0 (zeros = padding
    or gated correspondences). Accumulation is fp32; the SVD is DxD (2 or 3).
    """
    w = weights[..., None]  # (..., M, 1)
    wsum = jnp.maximum(jnp.sum(w, axis=-2, keepdims=True), 1e-12)  # (..., 1, 1)
    mu_s = jnp.sum(w * src, axis=-2, keepdims=True) / wsum  # (..., 1, D)
    mu_d = jnp.sum(w * dst, axis=-2, keepdims=True) / wsum
    xs = (src - mu_s) * w
    xd = dst - mu_d
    # cross-covariance (..., D, D) = xdᵀ @ xs — a small matmul reduction
    cov = jnp.swapaxes(xd, -1, -2) @ xs / wsum
    return rigid_from_stats(cov, mu_s[..., 0, :], mu_d[..., 0, :])


def moments(src: jnp.ndarray, dst: jnp.ndarray, weights: jnp.ndarray):
    """Raw weighted moments of a correspondence set; sums, so psum-reducible.

    Returns (wsum (...,), s_src (..., D), s_dst (..., D), s_ds (..., D, D))
    with s_ds = Σ w · dst ⊗ src (dst rows, src cols).
    """
    w = weights[..., None]
    wsum = jnp.sum(weights, axis=-1)
    s_src = jnp.sum(w * src, axis=-2)
    s_dst = jnp.sum(w * dst, axis=-2)
    s_ds = jnp.swapaxes(dst, -1, -2) @ (w * src)
    return wsum, s_src, s_dst, s_ds


def umeyama_from_moments(wsum, s_src, s_dst, s_ds) -> jnp.ndarray:
    """Rigid solve from (possibly collective-reduced) raw moments."""
    ws = jnp.maximum(wsum, 1e-12)[..., None]
    mu_s = s_src / ws  # (..., D)
    mu_d = s_dst / ws
    cov = s_ds / ws[..., None] - mu_d[..., :, None] * mu_s[..., None, :]
    return rigid_from_stats(cov, mu_s, mu_d)
