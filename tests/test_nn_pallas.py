"""Kernel-equivalence tests: the Triton-route NN kernel vs the XLA version
vs a NumPy oracle (SURVEY.md §4b "Kernel equivalence"). The kernel runs in
interpret mode on the CPU suite; `python chip_smoke.py` checks the compiled
kernel on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpu_icp_slam.core import pointcloud as pcm
from tpu_icp_slam.kernels import nn as nn_mod
from tpu_icp_slam.kernels import nn_pallas
from tpu_icp_slam.kernels.nn_pallas import nn_bruteforce_pallas
from tpu_icp_slam.kernels.nn_xla import nn_bruteforce_xla


def _oracle(src, dst):
    D = ((src[:, None, :].astype(np.float64)
          - dst[None, :, :].astype(np.float64)) ** 2).sum(-1)
    return D.argmin(1), D.min(1)


@pytest.mark.parametrize(
    "m,n,block_m,block_n",
    [
        (256, 256, 16, 64),  # exact blocks
        (300, 500, 16, 64),  # ragged both axes
        (64, 1000, 128, 256),  # m smaller than the block
        (1024, 96, 32, 128),  # n smaller than the block
    ],
)
def test_pallas_nn_matches_oracle(m, n, block_m, block_n):
    rng = np.random.default_rng(m + n)
    src = rng.uniform(-10, 10, (m, 3)).astype(np.float32)
    dst = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    idx, d2 = nn_bruteforce_pallas(
        jnp.asarray(src), jnp.asarray(dst), block_m=block_m, block_n=block_n,
        interpret=True,
    )
    oidx, od2 = _oracle(src, dst)
    # difference form: exact f32 minimum, not the factored form's ~1e-3
    np.testing.assert_allclose(np.asarray(d2), od2, rtol=1e-6, atol=1e-9)
    picked = ((src - dst[np.asarray(idx)]).astype(np.float64) ** 2).sum(-1)
    np.testing.assert_allclose(picked, od2, rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize(
    "m,n",
    [(128, 256), (200, 333), (5, 7), (70, 1)],
    ids=["aligned", "ragged", "smaller-than-block", "single-target"],
)
def test_pallas_nn_dims_and_shapes(dim, m, n):
    rng = np.random.default_rng(10 * m + n + dim)
    src = rng.uniform(-30, 30, (m, dim)).astype(np.float32)
    dst = rng.uniform(-30, 30, (n, dim)).astype(np.float32)
    idx, d2 = nn_bruteforce_pallas(jnp.asarray(src), jnp.asarray(dst))
    oidx, od2 = _oracle(src, dst)
    assert idx.shape == (m,) and idx.dtype == jnp.int32
    assert d2.shape == (m,) and d2.dtype == jnp.float32
    np.testing.assert_array_equal(np.asarray(idx), oidx)
    np.testing.assert_allclose(np.asarray(d2), od2, rtol=1e-6, atol=1e-9)


def test_pallas_nn_2d_points():
    rng = np.random.default_rng(0)
    src = rng.uniform(-5, 5, (200, 2)).astype(np.float32)
    dst = rng.uniform(-5, 5, (333, 2)).astype(np.float32)
    idx, d2 = nn_bruteforce_pallas(jnp.asarray(src), jnp.asarray(dst), interpret=True)
    oidx, od2 = _oracle(src, dst)
    picked = ((src - dst[np.asarray(idx)]) ** 2).sum(-1)
    np.testing.assert_allclose(picked, od2, rtol=1e-5, atol=1e-6)


def test_pallas_nn_sentinel_padding_never_wins():
    rng = np.random.default_rng(1)
    real = rng.uniform(-5, 5, (100, 3)).astype(np.float32)
    pc = pcm.make(real, capacity=256)  # 156 sentinel rows
    src = rng.uniform(-5, 5, (64, 3)).astype(np.float32)
    idx, _ = nn_bruteforce_pallas(jnp.asarray(src), pc.points, interpret=True)
    assert np.all(np.asarray(idx) < 100)


@pytest.mark.parametrize(
    "dups,want",
    [
        ((3, 5, 40), 3),  # duplicates inside one block: first column wins
        ((70, 7), 7),  # later block, smaller column: lowest INDEX wins
        ((129, 64, 200), 64),  # across three blocks
    ],
)
def test_pallas_nn_ties_take_lowest_index(dups, want):
    """Exact ties resolve to the lowest target index, within a block and
    across blocks (block_n = 64 here)."""
    rng = np.random.default_rng(5)
    dst = rng.uniform(10, 20, (256, 3)).astype(np.float32)  # all far away
    q = np.asarray([[1.0, 2.0, 3.0]], np.float32)
    for j in dups:
        dst[j] = q[0] + np.float32(0.25)  # identical copies: exact tie
    idx, d2 = nn_bruteforce_pallas(jnp.asarray(q), jnp.asarray(dst),
                                   block_n=64)
    assert int(idx[0]) == want
    np.testing.assert_allclose(float(d2[0]), 3 * 0.25 ** 2, rtol=1e-6)


def test_pallas_nn_large_offset_is_exact():
    """Difference form keeps the exact minimum 500 m from the origin, where
    the factored ‖a‖² + ‖b‖² − 2a·b form cancels to ~1e-1 m² in f32."""
    rng = np.random.default_rng(3)
    offset = np.asarray([500.0, -300.0, 40.0], np.float32)
    src = (rng.uniform(-30, 30, (300, 3)) + offset).astype(np.float32)
    dst = (rng.uniform(-30, 30, (900, 3)) + offset).astype(np.float32)
    idx, d2 = nn_bruteforce_pallas(jnp.asarray(src), jnp.asarray(dst))
    oidx, od2 = _oracle(src, dst)
    np.testing.assert_array_equal(np.asarray(idx), oidx)
    np.testing.assert_allclose(np.asarray(d2), od2, rtol=1e-6, atol=1e-7)


def test_pallas_nn_vmap_matches_unbatched():
    rng = np.random.default_rng(8)
    S = jnp.asarray(rng.uniform(-5, 5, (3, 100, 3)), jnp.float32)
    T = jnp.asarray(rng.uniform(-5, 5, (3, 150, 3)), jnp.float32)
    bi, bd = jax.vmap(nn_bruteforce_pallas)(S, T)
    for b in range(3):
        i, d = nn_bruteforce_pallas(S[b], T[b])
        np.testing.assert_array_equal(np.asarray(bi[b]), np.asarray(i))
        np.testing.assert_array_equal(np.asarray(bd[b]), np.asarray(d))


def test_pallas_nn_nested_vmap_loop_verification_shape():
    """candidates × yaw hypotheses, as backend/loop_closure.verify_batch
    calls it: vmap over targets of vmap over rotated sources."""
    rng = np.random.default_rng(9)
    S = jnp.asarray(rng.uniform(-5, 5, (4, 80, 3)), jnp.float32)  # yaws
    T = jnp.asarray(rng.uniform(-5, 5, (2, 120, 3)), jnp.float32)  # cands
    fn = jax.vmap(jax.vmap(nn_bruteforce_pallas, (0, None)), (None, 0))
    bi, _ = fn(S, T)
    assert bi.shape == (2, 4, 80)
    for c in range(2):
        for y in range(4):
            oidx, _ = _oracle(np.asarray(S[y]), np.asarray(T[c]))
            np.testing.assert_array_equal(np.asarray(bi[c, y]), oidx)


@pytest.mark.parametrize("method", ["point_to_point", "point_to_plane"])
def test_pallas_icp_recovers_transform(method):
    """End-to-end: ICP through the kernel converges to the true transform."""
    from tpu_icp_slam.config import ICPConfig
    from tpu_icp_slam.datasets import synthetic
    from tpu_icp_slam.eval import metrics
    from tpu_icp_slam.icp import align
    from tpu_icp_slam.mapping.normals import normals_knn

    s, d, T_gt = synthetic.two_scan_pair(n=512, seed=4, rot_scale=0.2,
                                         trans_scale=0.3)
    dst = pcm.make(d, 512)
    if method == "point_to_plane":
        dst = pcm.PointCloud(points=dst.points, mask=dst.mask,
                             normals=normals_knn(dst.points, dst.mask, k=12))
    res = align(
        pcm.make(s, 512), dst,
        cfg=ICPConfig(method=method, max_iters=30, tol=1e-7,
                      nn_backend="pallas"),
    )
    rot_err, trans_err = metrics.transform_error(
        np.asarray(res.T, np.float64), T_gt
    )
    assert rot_err < 2e-3 and trans_err < 2e-3, (rot_err, trans_err)


def test_pallas_matches_xla_fallback():
    rng = np.random.default_rng(2)
    src = rng.uniform(-20, 20, (777, 3)).astype(np.float32)
    dst = rng.uniform(-20, 20, (555, 3)).astype(np.float32)
    pi, pd = nn_bruteforce_pallas(jnp.asarray(src), jnp.asarray(dst), interpret=True)
    xi, xd = nn_bruteforce_xla(jnp.asarray(src), jnp.asarray(dst), chunk=256)
    picked_p = ((src - dst[np.asarray(pi)]) ** 2).sum(-1)
    picked_x = ((src - dst[np.asarray(xi)]) ** 2).sum(-1)
    np.testing.assert_allclose(picked_p, picked_x, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize(
    "platform,backend,want",
    [
        ("gpu", "auto", "pallas"),
        ("gpu", "pallas", "pallas"),
        ("gpu", "xla", "xla"),
        ("cpu", "auto", "xla"),
        ("cpu", "pallas", "pallas"),
        ("cpu", "xla", "xla"),
    ],
)
def test_resolve_backend(platform, backend, want):
    assert nn_mod.resolve_backend(backend, platform) == want


@pytest.mark.parametrize("platform", ["rocm", "metal", "sycl"])
def test_resolve_backend_unknown_platform_raises(platform):
    with pytest.raises(RuntimeError, match="unsupported platform"):
        nn_mod.resolve_backend("auto", platform)


def test_resolve_backend_unknown_backend_raises():
    with pytest.raises(ValueError, match="unknown NN backend"):
        nn_mod.resolve_backend("bf16", "gpu")


@pytest.mark.parametrize(
    "platform,want", [("cpu", True), ("gpu", False), ("rocm", RuntimeError)]
)
def test_interpret_only_on_cpu(monkeypatch, platform, want):
    """The kernel never runs interpreted on a GPU, and refuses any platform
    it was not built for."""
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    if want is RuntimeError:
        with pytest.raises(RuntimeError, match="no NN kernel"):
            nn_pallas._interpret_for_platform()
    else:
        assert nn_pallas._interpret_for_platform() is want


def test_nearest_neighbor_auto_on_cpu_is_xla(monkeypatch):
    """`auto` on the CPU takes the XLA version, never the kernel."""
    called = []
    monkeypatch.setattr(nn_pallas, "nn_bruteforce_pallas",
                        lambda *a, **k: called.append(1))
    rng = np.random.default_rng(4)
    src = jnp.asarray(rng.uniform(-1, 1, (20, 3)), jnp.float32)
    idx, _ = nn_mod.nearest_neighbor(src, src, backend="auto")
    assert not called
    np.testing.assert_array_equal(np.asarray(idx), np.arange(20))


@pytest.mark.gpu
def test_compiled_kernel_exact_on_gpu(gpu):
    """On the card: the compiled kernel (not interpret mode) is exact."""
    rng = np.random.default_rng(6)
    src = rng.uniform(-40, 40, (4096, 3)).astype(np.float32)
    dst = rng.uniform(-40, 40, (4096, 3)).astype(np.float32)
    text = jax.jit(nn_bruteforce_pallas).lower(
        jnp.asarray(src), jnp.asarray(dst)).compile().as_text()
    assert "xla.gpu.triton" in text or '"__triton"' in text
    idx, d2 = nn_bruteforce_pallas(jnp.asarray(src), jnp.asarray(dst))
    oidx, od2 = _oracle(src, dst)
    np.testing.assert_allclose(np.asarray(d2), od2, rtol=1e-6, atol=1e-9)
