"""Point-to-plane Gauss-Newton step (N6) — XLA path.

Per-correspondence residual r = nᵀ(p − q) with Jacobian row [nᵀ, (p×n)ᵀ]
(translation first, matching core.se3 tangent order). The 6×6 normal
equations H = Jᵀ diag(w) J are a masked matmul reduction that XLA fuses
with the Jacobian build. The solve is a tiny damped Cholesky.

Capability required by BASELINE.json config 3; the reference had only
point-to-point (SURVEY.md §2a R4/R5).
"""

from __future__ import annotations

import jax.numpy as jnp

from tpu_icp_slam.core import se2, se3


def build_normal_equations(
    p: jnp.ndarray, q: jnp.ndarray, n: jnp.ndarray, w: jnp.ndarray
):
    """H (K, K), g (K,) for K = 6 (3D) or 3 (2D); fp32 matmul reductions."""
    d = p.shape[-1]
    r = jnp.sum(n * (p - q), axis=-1)  # (M,)
    if d == 3:
        J = jnp.concatenate([n, jnp.cross(p, n)], axis=-1)  # (M, 6)
    elif d == 2:
        cross2 = p[..., 0] * n[..., 1] - p[..., 1] * n[..., 0]
        J = jnp.concatenate([n, cross2[..., None]], axis=-1)  # (M, 3)
    else:
        raise ValueError(f"unsupported dim {d}")
    Jw = J * w[..., None]
    H = J.T @ Jw  # (K, K)
    g = Jw.T @ r  # (K,)
    return H, g


def solve_increment(
    H: jnp.ndarray,
    g: jnp.ndarray,
    damping: float,
    max_step_trans: float = 0.0,
    max_step_rot: float = 0.0,
    degen_eps: float = 0.0,
    prior_w=None,
    xi_prior=None,
) -> jnp.ndarray:
    """Damped solve of H xi = -g with optional per-block trust clamps.

    prior_w (k,) + xi_prior (k,) add a Tikhonov motion prior: cost
    λ/2 ||xi + xi_prior||² per axis (xi_prior = current offset from the
    anchor pose in twist coordinates) → H += diag(prior_w),
    g += prior_w * xi_prior. Where the point geometry observes a direction
    the prior is negligible; where it doesn't (H ≈ 0 there) the prior holds
    the anchor. Applied BEFORE the degen_eps analysis so a prior-constrained
    direction counts as observed.

    The clamps bound the translation / rotation magnitude of one GN step —
    the cheap jit-friendly trust region that stops near-degenerate normal
    equations (e.g. a corridor scene unconstrained along the travel axis)
    from launching the pose to infinity.

    degen_eps > 0 enables degeneracy-aware solution remapping (Zhang &
    Singh, "On Degeneracy of Optimization-based State Estimation"): the
    update is solved in H's eigenbasis and ZEROED along eigendirections
    whose eigenvalue is below degen_eps × the largest — directions the scan
    geometry does not observe (corridor travel axis, map-frontier coverage
    amputation). The pose keeps its initialization (= the motion-model
    prediction) along them instead of following noise.

    MEASURED CAVEAT (r3, why this defaults OFF): on the multisession
    corridor routes a RELATIVE threshold (eps 0.02-0.05 × λ_max) froze
    translation entirely — max position error = the full route length,
    identical across seeds. λ_max is rotation-dominated (scales with the
    squared point spread, ~(30 m)², different units from the translation
    block), so 2% of it already dwarfs a legitimately-observable travel
    axis; and since the damped-CV motion model bootstraps from ICP's own
    estimates, zeroing that axis deadlocks the pose at rest. Use only with
    a threshold calibrated to the translation block's scale, or with an
    external odometry source feeding the prediction.
    """
    k = H.shape[0]
    if prior_w is not None:
        H = H + jnp.diag(jnp.asarray(prior_w, H.dtype))
        g = g + jnp.asarray(prior_w, g.dtype) * jnp.asarray(
            xi_prior, g.dtype)
    lam = damping * jnp.maximum(jnp.trace(H) / k, 1.0)
    if degen_eps > 0.0:
        # eigh of the UNdamped H: damping inflates the spectrum floor and
        # would mask true degeneracy. The eigenbasis gives the damped solve
        # for free: xi = -V diag(keep / (e + lam)) Vᵀ g
        evals, V = jnp.linalg.eigh(H)
        keep = (evals > degen_eps * jnp.maximum(evals[-1], 1e-12)).astype(
            H.dtype
        )
        gv = V.T @ g
        xi = -(V @ (keep * gv / (evals + lam)))
    else:
        Hd = H + lam * jnp.eye(k, dtype=H.dtype)
        L = jnp.linalg.cholesky(Hd)
        y = jnp.linalg.solve(L, -g[:, None])
        xi = jnp.linalg.solve(L.T, y)[:, 0]
    # guard against NaNs from a singular system: fall back to zero update
    xi = jnp.where(jnp.all(jnp.isfinite(xi)), xi, jnp.zeros_like(xi))
    d = 3 if k == 6 else 2  # tangent layout: [t (d), w (k-d)]
    if max_step_trans > 0.0:
        tn = jnp.linalg.norm(xi[:d])
        xi = xi * jnp.minimum(1.0, max_step_trans / jnp.maximum(tn, 1e-12))
    if max_step_rot > 0.0:
        wn = jnp.linalg.norm(xi[d:])
        xi = xi * jnp.minimum(1.0, max_step_rot / jnp.maximum(wn, 1e-12))
    return xi


def gauss_newton_step(
    p: jnp.ndarray,
    q: jnp.ndarray,
    n: jnp.ndarray,
    w: jnp.ndarray,
    damping: float = 1e-6,
    max_step_trans: float = 0.0,
    max_step_rot: float = 0.0,
    degen_eps: float = 0.0,
    prior_w=None,
    xi_prior=None,
) -> jnp.ndarray:
    """One damped GN update: returns dT (D+1, D+1) to left-compose onto T."""
    d = p.shape[-1]
    H, g = build_normal_equations(p, q, n, w)
    xi = solve_increment(
        H, g, damping, max_step_trans, max_step_rot, degen_eps=degen_eps,
        prior_w=prior_w, xi_prior=xi_prior,
    )
    return se3.exp(xi) if d == 3 else se2.exp(xi)
