"""Normal estimation unit tests, incl. the closed-form 3x3 eigensolver that
replaced jnp.linalg.eigh on the hot keyframe path (r2 — the iterative
batched eigh dominated keyframe normals; the closed form is elementwise)."""

import jax.numpy as jnp
import numpy as np

from tpu_icp_slam.mapping.normals import normals_knn, smallest_eigvec_sym3


def _rand_sym3(rng, n, cond=None):
    A = rng.standard_normal((n, 3, 3))
    C = np.einsum("nij,nkj->nik", A, A)  # SPD-ish
    return C


def test_smallest_eigvec_matches_eigh_random():
    rng = np.random.default_rng(0)
    C = _rand_sym3(rng, 500)
    v = np.asarray(smallest_eigvec_sym3(jnp.asarray(C, jnp.float64)))
    w, V = np.linalg.eigh(C)
    v_ref = V[..., 0]
    dots = np.abs(np.sum(v * v_ref, axis=-1))
    assert dots.min() > 1 - 1e-6, dots.min()
    np.testing.assert_allclose(np.linalg.norm(v, axis=-1), 1.0, atol=1e-6)


def test_smallest_eigvec_planar_covariance():
    """Covariance of points on a plane: smallest eigenvector == the plane
    normal, the exact case the plane fit depends on."""
    rng = np.random.default_rng(1)
    for i in range(20):
        n = rng.standard_normal(3)
        n /= np.linalg.norm(n)
        # two in-plane directions
        a = np.cross(n, [1.0, 0.0, 0.0])
        if np.linalg.norm(a) < 1e-3:
            a = np.cross(n, [0.0, 1.0, 0.0])
        a /= np.linalg.norm(a)
        b = np.cross(n, a)
        pts = (
            rng.standard_normal((50, 1)) * a[None, :]
            + 0.5 * rng.standard_normal((50, 1)) * b[None, :]
            + 0.001 * rng.standard_normal((50, 1)) * n[None, :]
        )
        C = pts.T @ pts / len(pts)
        v = np.asarray(smallest_eigvec_sym3(jnp.asarray(C, jnp.float64)))
        assert abs(np.dot(v, n)) > 0.999, (i, abs(np.dot(v, n)))


def test_smallest_eigvec_degenerate_isotropic():
    """Isotropic covariance: any unit vector is valid — must not NaN."""
    C = jnp.stack([jnp.eye(3), 2.0 * jnp.eye(3), jnp.zeros((3, 3))])
    v = np.asarray(smallest_eigvec_sym3(C))
    assert np.isfinite(v).all()
    np.testing.assert_allclose(np.linalg.norm(v, axis=-1), 1.0, atol=1e-5)


def test_normals_knn_on_plane():
    rng = np.random.default_rng(2)
    pts = np.zeros((200, 3), np.float32)
    pts[:, :2] = rng.uniform(-2, 2, (200, 2))
    pts[:, 2] = 5.0 + 0.001 * rng.standard_normal(200)  # plane z=5
    n = np.asarray(normals_knn(jnp.asarray(pts), jnp.ones(200, bool), k=12))
    # oriented toward the origin (sensor below the plane) => n_z < 0
    assert (np.abs(n[:, 2]) > 0.99).all()
    assert (n[:, 2] < 0).all()


def test_knn_oversample_rescore_matches_exact():
    """Oversampled-approx kNN (prefilter + exact top-k rescore) must return
    the exact k nearest — the r5 middle path between exact top_k and plain
    approx_min_k (diverged the lap, BASELINE.md r4)."""
    from tpu_icp_slam.kernels.nn_xla import knn_bruteforce_xla

    rng = np.random.default_rng(4)
    src = rng.uniform(-5, 5, (300, 3)).astype(np.float32)
    dst = rng.uniform(-5, 5, (900, 3)).astype(np.float32)
    ei, ed = knn_bruteforce_xla(
        jnp.asarray(src), jnp.asarray(dst), k=8, approx=False
    )
    oi, od = knn_bruteforce_xla(
        jnp.asarray(src), jnp.asarray(dst), k=8, approx=True, oversample=4
    )
    # compare neighbor SETS by distance (ties can reorder indices)
    np.testing.assert_allclose(
        np.sort(np.asarray(od), 1), np.sort(np.asarray(ed), 1),
        rtol=1e-5, atol=1e-6,
    )


def test_normals_knn_oversample_same_plane():
    rng = np.random.default_rng(5)
    pts = np.zeros((400, 3), np.float32)
    pts[:, :2] = rng.uniform(-4, 4, (400, 2))
    pts[:, 2] = 5.0 + 0.001 * rng.standard_normal(400)
    n = np.asarray(normals_knn(
        jnp.asarray(pts), jnp.ones(400, bool), k=8, approx=True, oversample=4
    ))
    assert (np.abs(n[:, 2]) > 0.99).all()
    assert (n[:, 2] < 0).all()


def test_normals_knn_ref_stride_same_plane():
    """Strided-reference plane fit (the cheap keyframe-normals path) must
    recover the same plane on locally flat geometry."""
    rng = np.random.default_rng(3)
    pts = np.zeros((400, 3), np.float32)
    pts[:, :2] = rng.uniform(-4, 4, (400, 2))
    pts[:, 2] = 5.0 + 0.001 * rng.standard_normal(400)
    n = np.asarray(normals_knn(
        jnp.asarray(pts), jnp.ones(400, bool), k=8, ref_stride=4
    ))
    assert (np.abs(n[:, 2]) > 0.99).all()
    assert (n[:, 2] < 0).all()
