import jax
import jax.numpy as jnp
import numpy as np

from tpu_icp_slam.config import ICPConfig
from tpu_icp_slam.core import pointcloud as pcm
from tpu_icp_slam.datasets import synthetic
from tpu_icp_slam.eval import golden, metrics
from tpu_icp_slam.icp import align, umeyama_masked
from tpu_icp_slam.kernels.nn_xla import knn_bruteforce_xla, nn_bruteforce_xla


def test_umeyama_masked_recovers_rigid():
    rng = np.random.default_rng(0)
    src = rng.standard_normal((300, 3)).astype(np.float32)
    T = synthetic.rigid_transform(3, rng)
    dst = (src @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
    w = np.ones(300, np.float32)
    # poison some pairs, zero their weight — must not affect the solve
    dst2 = dst.copy()
    dst2[:50] += 100.0
    w2 = w.copy()
    w2[:50] = 0.0
    out = umeyama_masked(jnp.asarray(src), jnp.asarray(dst2), jnp.asarray(w2))
    # elementwise: the geodesic-angle metric has a ~5e-4 noise floor for f32
    # matrices (arccos amplifies trace rounding by a square root)
    assert np.abs(np.asarray(out, np.float64) - T).max() < 1e-5


def test_umeyama_batched():
    rng = np.random.default_rng(1)
    src = rng.standard_normal((4, 100, 3)).astype(np.float32)
    Ts = np.stack([synthetic.rigid_transform(3, rng) for _ in range(4)])
    dst = np.einsum("bij,bnj->bni", Ts[:, :3, :3], src) + Ts[:, None, :3, 3]
    w = np.ones((4, 100), np.float32)
    out = np.asarray(
        umeyama_masked(jnp.asarray(src), jnp.asarray(dst.astype(np.float32)), jnp.asarray(w))
    )
    for b in range(4):
        assert np.abs(out[b].astype(np.float64) - Ts[b]).max() < 1e-5


def test_nn_xla_matches_numpy_oracle():
    rng = np.random.default_rng(2)
    src = rng.standard_normal((257, 3)).astype(np.float32)
    dst = rng.standard_normal((123, 3)).astype(np.float32)
    idx, d2 = nn_bruteforce_xla(jnp.asarray(src), jnp.asarray(dst), chunk=64)
    # numpy oracle
    D = ((src[:, None, :] - dst[None, :, :]) ** 2).sum(-1)
    np.testing.assert_array_equal(np.asarray(idx), D.argmin(1))
    np.testing.assert_allclose(np.asarray(d2), D.min(1), rtol=1e-4, atol=1e-5)


def test_nn_ignores_sentinel_padding():
    src = np.zeros((4, 3), np.float32)
    dst = np.concatenate(
        [np.ones((3, 3), np.float32), np.full((5, 3), pcm.PAD_COORD, np.float32)]
    )
    idx, _ = nn_bruteforce_xla(jnp.asarray(src), jnp.asarray(dst))
    assert np.all(np.asarray(idx) < 3)


def test_knn():
    rng = np.random.default_rng(3)
    src = rng.standard_normal((50, 3)).astype(np.float32)
    dst = rng.standard_normal((80, 3)).astype(np.float32)
    idx, d2 = knn_bruteforce_xla(jnp.asarray(src), jnp.asarray(dst), k=5)
    D = ((src[:, None, :] - dst[None, :, :]) ** 2).sum(-1)
    oracle = np.sort(D, axis=1)[:, :5]
    np.testing.assert_allclose(np.sort(np.asarray(d2), axis=1), oracle, rtol=1e-4, atol=1e-5)


def test_align_config1_synthetic_two_scan():
    """BASELINE.json config 1: ~4k points, known SE(3), recovery < 1e-3."""
    src, dst, T_gt = synthetic.two_scan_pair(n=4096, seed=0)
    pc_src = pcm.make(src, capacity=4096)
    pc_dst = pcm.make(dst, capacity=4096)
    cfg = ICPConfig(max_iters=60, tol=1e-6, nn_backend="xla")
    res = align(pc_src, pc_dst, cfg=cfg)
    rot_err, trans_err = metrics.transform_error(
        np.asarray(res.T, np.float64), T_gt
    )
    assert rot_err < 1e-3, rot_err
    assert trans_err < 1e-3, trans_err
    assert bool(res.converged)


def test_align_with_padding_and_gate():
    src, dst, T_gt = synthetic.two_scan_pair(n=1000, seed=5, rot_scale=0.15, trans_scale=0.2)
    pc_src = pcm.make(src, capacity=1536)  # heavy padding
    pc_dst = pcm.make(dst, capacity=2048)
    cfg = ICPConfig(max_iters=60, tol=1e-6, max_corr_dist=2.0, nn_backend="xla")
    res = align(pc_src, pc_dst, cfg=cfg)
    rot_err, trans_err = metrics.transform_error(np.asarray(res.T, np.float64), T_gt)
    assert rot_err < 1e-3 and trans_err < 1e-3
    assert int(res.n_inliers) == 1000


def test_align_agrees_with_golden():
    src, dst, _ = synthetic.two_scan_pair(n=2048, seed=6, noise=0.005)
    gres = golden.icp_point_to_point(src, dst, max_iters=60)
    res = align(
        pcm.make(src, capacity=2048),
        pcm.make(dst, capacity=2048),
        cfg=ICPConfig(max_iters=60, tol=1e-6, nn_backend="xla"),
    )
    rot_err, trans_err = metrics.transform_error(
        np.asarray(res.T, np.float64), gres.T
    )
    assert rot_err < 2e-3, rot_err
    assert trans_err < 2e-3, trans_err


def test_align_self_is_identity():
    """Property: aligning a cloud to itself yields identity (SURVEY §4b)."""
    src, _, _ = synthetic.two_scan_pair(n=512, seed=7)
    pc = pcm.make(src, capacity=512)
    res = align(pc, pc, cfg=ICPConfig(max_iters=10, nn_backend="xla"))
    np.testing.assert_allclose(np.asarray(res.T), np.eye(4), atol=1e-5)
    assert float(res.rmse) < 1e-5


def test_align_rigid_invariance():
    """Applying the same rigid transform to both clouds conjugates the result."""
    rng = np.random.default_rng(8)
    src, dst, _ = synthetic.two_scan_pair(n=512, seed=9, rot_scale=0.1, trans_scale=0.1)
    G = synthetic.rigid_transform(3, rng, rot_scale=0.5, trans_scale=1.0)
    cfg = ICPConfig(max_iters=40, tol=1e-7, nn_backend="xla")
    r1 = align(pcm.make(src, 512), pcm.make(dst, 512), cfg=cfg)
    src_g = src @ G[:3, :3].T + G[:3, 3]
    dst_g = dst @ G[:3, :3].T + G[:3, 3]
    r2 = align(pcm.make(src_g, 512), pcm.make(dst_g, 512), cfg=cfg)
    expected = G @ np.asarray(r1.T, np.float64) @ np.linalg.inv(G)
    rot_err, trans_err = metrics.transform_error(np.asarray(r2.T, np.float64), expected)
    assert rot_err < 1e-3 and trans_err < 1e-3


def test_align_point_to_plane_3d():
    rng = np.random.default_rng(10)
    # planar scene with normals
    n_per = 600
    pts, nrms = [], []
    for nvec, d0 in [((0, 0, 1.0), 0.0), ((0, 1.0, 0), 3.0), ((1.0, 0, 0), 2.0)]:
        nvec = np.asarray(nvec)
        basis = np.linalg.svd(nvec[None])[2][1:]
        uv = rng.uniform(-2, 2, size=(n_per, 2))
        pts.append(uv @ basis + d0 * nvec)
        nrms.append(np.tile(nvec, (n_per, 1)))
    dst = np.concatenate(pts)
    dst_n = np.concatenate(nrms)
    T_gt = synthetic.rigid_transform(3, rng, rot_scale=0.05, trans_scale=0.1)
    Ti = np.linalg.inv(T_gt)
    src = dst @ Ti[:3, :3].T + Ti[:3, 3]
    res = align(
        pcm.make(src, 2048),
        pcm.make(dst, 2048, normals=dst_n),
        cfg=ICPConfig(method="point_to_plane", max_iters=30, tol=1e-12, nn_backend="xla"),
    )
    rot_err, trans_err = metrics.transform_error(np.asarray(res.T, np.float64), T_gt)
    assert rot_err < 1e-3 and trans_err < 1e-3


def test_align_jit_cache_stable():
    """Repeated calls with same shapes/config reuse the compiled executable."""
    src, dst, _ = synthetic.two_scan_pair(n=256, seed=11)
    cfg = ICPConfig(max_iters=5, nn_backend="xla")
    a = pcm.make(src, 256)
    b = pcm.make(dst, 256)
    align(a, b, cfg=cfg)
    n0 = align._cache_size()
    align(b, a, cfg=cfg)
    assert align._cache_size() == n0


def test_align_anderson_acceleration():
    """AA(1) (safeguarded) converges to the same transform as plain ICP."""
    import dataclasses as dc

    from tpu_icp_slam.config import ICPConfig
    from tpu_icp_slam.core import pointcloud as pc
    from tpu_icp_slam.datasets import synthetic
    from tpu_icp_slam.icp import loop as icp_loop

    src, dst, T_gt = synthetic.two_scan_pair(
        n=1000, seed=11, rot_scale=0.15, trans_scale=0.3
    )
    cs = pc.make(src, capacity=1024)
    cd = pc.make(dst, capacity=1024)
    plain = icp_loop.align(cs, cd, cfg=ICPConfig(max_iters=50, nn_backend="xla"))
    aa = icp_loop.align(
        cs, cd, cfg=ICPConfig(max_iters=50, nn_backend="xla", anderson=True)
    )
    err_plain = float(np.abs(np.asarray(plain.T) - T_gt).max())
    err_aa = float(np.abs(np.asarray(aa.T) - T_gt).max())
    assert err_aa < 1e-3, err_aa
    assert int(aa.iters) <= int(plain.iters) + 2


def test_unrolled_matches_while_loop():
    """unroll_iters: trace-time-unrolled ICP must match the while_loop
    driver whenever the unroll budget covers the needed iterations (the
    unrolled form removes per-iteration loop control from the device)."""
    import dataclasses

    from tpu_icp_slam.config import ICPConfig
    from tpu_icp_slam.core import pointcloud as pcm
    from tpu_icp_slam.datasets import synthetic
    from tpu_icp_slam.icp import align

    s, d, T_gt = synthetic.two_scan_pair(n=256, seed=7, rot_scale=0.15,
                                         trans_scale=0.2)
    base = ICPConfig(max_iters=25, tol=1e-6, nn_backend="xla")
    res_w = align(pcm.make(s, 256), pcm.make(d, 256), cfg=base)
    res_u = align(
        pcm.make(s, 256), pcm.make(d, 256),
        cfg=dataclasses.replace(base, unroll_iters=25),
    )
    np.testing.assert_allclose(
        np.asarray(res_u.T), np.asarray(res_w.T), rtol=1e-6, atol=1e-7
    )
    assert int(res_u.iters) == int(res_w.iters)
    assert bool(res_u.converged) == bool(res_w.converged)


def test_unrolled_honors_max_iters():
    """unroll_iters > max_iters must still stop at max_iters (review r2)."""
    import dataclasses

    from tpu_icp_slam.config import ICPConfig
    from tpu_icp_slam.core import pointcloud as pcm
    from tpu_icp_slam.datasets import synthetic
    from tpu_icp_slam.icp import align

    s, d, _ = synthetic.two_scan_pair(n=256, seed=8, rot_scale=0.15,
                                      trans_scale=0.2)
    base = ICPConfig(max_iters=5, tol=0.0, nn_backend="xla")  # never converges
    res_w = align(pcm.make(s, 256), pcm.make(d, 256), cfg=base)
    res_u = align(
        pcm.make(s, 256), pcm.make(d, 256),
        cfg=dataclasses.replace(base, unroll_iters=10),
    )
    assert int(res_u.iters) == int(res_w.iters) == 5
    np.testing.assert_allclose(
        np.asarray(res_u.T), np.asarray(res_w.T), rtol=1e-6, atol=1e-7
    )


def test_degen_remapping_zeroes_unobserved_direction():
    """degen_eps mechanics (opt-in, default OFF — see the measured caveat in
    point_to_plane.solve_increment): with a rank-deficient H the remapped
    solve must zero the update along the null direction and still solve the
    observed block; with degen_eps=0 the damped solve runs unchanged.
    """
    from tpu_icp_slam.icp.point_to_plane import solve_increment

    # H observes everything except translation-x (index 0): a corridor whose
    # walls constrain y, z and all rotations but not travel along x.
    diag = np.array([1e-6, 50.0, 40.0, 900.0, 800.0, 700.0], np.float64)
    rng = np.random.default_rng(3)
    Q, _ = np.linalg.qr(rng.standard_normal((6, 6)))
    H = (Q * diag) @ Q.T
    xi_true = np.array([0.0, 0.2, -0.1, 0.01, -0.02, 0.03])
    g = -(H @ xi_true)
    xi = np.asarray(solve_increment(
        jnp.asarray(H, jnp.float32), jnp.asarray(g, jnp.float32),
        damping=1e-6, degen_eps=1e-3,
    ), np.float64)
    null_dir = Q[:, 0]
    # no component along the unobserved direction...
    assert abs(xi @ null_dir) < 1e-4, xi @ null_dir
    # ...while the observed components are recovered
    proj = np.eye(6) - np.outer(null_dir, null_dir)
    np.testing.assert_allclose(proj @ xi, proj @ xi_true, atol=5e-3)
    # degen_eps=0: plain damped solve follows g into the weak direction
    xi0 = np.asarray(solve_increment(
        jnp.asarray(H, jnp.float32), jnp.asarray(g, jnp.float32),
        damping=1e-6,
    ), np.float64)
    assert np.isfinite(xi0).all()


def test_motion_prior_holds_unobserved_direction():
    """prior_trans_weight: aligning a plane-only problem (z + normals
    observe z/roll/pitch; x, y, yaw are free) must keep the unobserved
    translation at the init pose instead of wandering, while still
    correcting the observed axis.
    """
    import dataclasses

    from tpu_icp_slam.icp import align as _align

    rng = np.random.default_rng(7)
    # a flat ground plane: observes only z translation (+ roll/pitch)
    xy = rng.uniform(-10, 10, (1024, 2))
    dst_np = np.concatenate([xy, np.zeros((1024, 1))], 1).astype(np.float32)
    src_np = dst_np + np.array([0.0, 0.0, 0.3], np.float32)  # offset in z
    nrm = np.tile(np.array([0, 0, 1.0], np.float32), (1024, 1))
    dst = pcm.make(dst_np, 1024, normals=jnp.asarray(nrm))
    src = pcm.make(src_np, 1024)
    cfg = ICPConfig(method="point_to_plane", max_iters=10, nn_backend="xla",
                    max_corr_dist=5.0, damping=1e-6, min_inliers=10,
                    prior_trans_weight=0.05, prior_rot_weight=0.05)
    res = _align(src, dst, cfg=cfg)
    T = np.asarray(res.T, np.float64)
    # observed: z corrected to -0.3; unobserved: x, y stay at the anchor (0)
    assert abs(T[2, 3] + 0.3) < 0.02, T[:3, 3]
    assert abs(T[0, 3]) < 1e-3 and abs(T[1, 3]) < 1e-3, T[:3, 3]
    # without the prior the free directions drift with correspondence noise
    res0 = _align(src, dst, cfg=dataclasses.replace(
        cfg, prior_trans_weight=0.0, prior_rot_weight=0.0))
    assert abs(np.asarray(res0.T)[2, 3] + 0.3) < 0.02
