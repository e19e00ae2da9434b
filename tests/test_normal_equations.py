"""XLA point-to-plane normal equations against a float64 NumPy reference."""

import jax.numpy as jnp
import numpy as np
import pytest

from tpu_icp_slam.icp.point_to_plane import build_normal_equations


def _reference(p, q, n, w):
    p, q, n, w = (np.asarray(x, np.float64) for x in (p, q, n, w))
    r = np.sum(n * (p - q), axis=1)
    if p.shape[1] == 3:
        J = np.concatenate([n, np.cross(p, n)], axis=1)
    else:
        J = np.concatenate(
            [n, (p[:, 0] * n[:, 1] - p[:, 1] * n[:, 0])[:, None]], axis=1)
    return J.T @ (J * w[:, None]), J.T @ (w * r)


@pytest.mark.parametrize("d,m", [(3, 4096), (3, 37), (2, 1000)])
def test_normal_equations_match_fp64(d, m):
    rng = np.random.default_rng(d * m)
    p = rng.uniform(-30, 30, (m, d)).astype(np.float32)
    q = (p + rng.normal(scale=0.05, size=(m, d))).astype(np.float32)
    n = rng.normal(size=(m, d))
    n = (n / np.linalg.norm(n, axis=1, keepdims=True)).astype(np.float32)
    w = (rng.uniform(size=m) > 0.2).astype(np.float32)
    H, g = build_normal_equations(*(jnp.asarray(x) for x in (p, q, n, w)))
    H_ref, g_ref = _reference(p, q, n, w)
    scale = np.abs(H_ref).max()
    np.testing.assert_allclose(np.asarray(H), H_ref, atol=1e-5 * scale)
    np.testing.assert_allclose(np.asarray(g), g_ref,
                               atol=1e-5 * np.abs(g_ref).max())
