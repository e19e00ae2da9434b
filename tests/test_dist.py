"""Distributed-layer tests on the 8-virtual-CPU-device mesh (SURVEY.md §4b).

Invariant under test: the point-sharded, psum-reduced ICP (dist/sharded_icp)
matches the single-device align bit-for-bit-ish (fp64 CPU mesh) — the
correctness oracle SURVEY.md §7 demands before chasing scaling.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpu_icp_slam.config import ICPConfig
from tpu_icp_slam.core import pointcloud as pc
from tpu_icp_slam.datasets import synthetic
from tpu_icp_slam.dist import ShardedAligner, make_mesh
from tpu_icp_slam.icp import loop as icp_loop


def _pair_batch(batch, n, dim=3, dtype=jnp.float32):
    """Batch of synthetic correspondence problems padded to capacity n."""
    src_b, dst_b, T_b, msk_b = [], [], [], []
    for i in range(batch):
        src, dst, T = synthetic.two_scan_pair(n=n - 7, seed=10 + i, dim=dim)
        cl_s = pc.make(src, capacity=n, dtype=dtype)
        cl_d = pc.make(dst, capacity=n, dtype=dtype)
        src_b.append(cl_s.points)
        dst_b.append(cl_d.points)
        msk_b.append(cl_s.mask)
        T_b.append(T)
    return (
        jnp.stack(src_b),
        jnp.stack(msk_b),
        jnp.stack(dst_b),
        np.stack(T_b),
    )


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return make_mesh(8, axes=("dp", "sp"))  # (2, 4)


def test_mesh_factoring():
    m = make_mesh(8, axes=("dp", "sp"))
    assert m.devices.shape == (2, 4)
    m1 = make_mesh(8, axes=("hosts",))
    assert m1.devices.shape == (8,)


def test_make_mesh_cpu_fallback_warns(monkeypatch):
    """Default platform too small -> ValueError naming the platform; the
    request is never served on the host CPU instead. Simulate a one-card
    default platform."""
    real_devices = jax.devices
    cpu = real_devices("cpu")

    def fake(platform=None):
        if platform is None:
            return cpu[:1]  # pretend the default backend is one card
        return real_devices(platform)

    monkeypatch.setattr(jax, "devices", fake)
    with pytest.raises(ValueError, match="requested but only 1 on platform"):
        make_mesh(8, axes=("dp",))


def test_make_mesh_raises_when_cpu_also_too_few():
    """More devices than exist -> hard ValueError, never a silently smaller
    mesh."""
    with pytest.raises(ValueError, match="requested but only"):
        make_mesh(1024, axes=("dp",))


def test_sharded_point_to_point_recovers_transform(mesh):
    cfg = ICPConfig(method="point_to_point", max_iters=40, nn_backend="xla")
    src, msk, dst, T_gt = _pair_batch(2, 512, dtype=jnp.float32)
    aligner = ShardedAligner(mesh=mesh, cfg=cfg)
    res = aligner(src, msk, dst)
    T = np.asarray(res.T)
    for b in range(2):
        err = np.abs(T[b] - T_gt[b]).max()
        assert err < 1e-3, f"batch {b}: err {err}"


def test_sharded_matches_single_device(mesh):
    cfg = ICPConfig(method="point_to_point", max_iters=15, nn_backend="xla")
    src, msk, dst, _ = _pair_batch(2, 512, dtype=jnp.float64)
    aligner = ShardedAligner(mesh=mesh, cfg=cfg)
    res = aligner(src, msk, dst)
    for b in range(2):
        ref = icp_loop.align(
            pc.PointCloud(points=src[b], mask=msk[b]),
            pc.PointCloud(points=dst[b], mask=jnp.ones(dst[b].shape[0], bool)),
            cfg=cfg,
        )
        np.testing.assert_allclose(
            np.asarray(res.T)[b], np.asarray(ref.T), rtol=1e-8, atol=1e-9
        )


def test_sharded_pallas_matches_single_and_xla(mesh):
    """Sharded-Pallas == single-device-Pallas == sharded-XLA (f32 tol).

    Pallas inside shard_map is where kernel/SPMD composition can break;
    this certifies the distributed path for the NN kernel, not just the XLA
    version (VERDICT r1 item 1). On the CPU mesh the kernel runs in
    interpret mode — same program structure, same shapes.
    """
    import dataclasses

    cfg_p = ICPConfig(method="point_to_point", max_iters=15, nn_backend="pallas")
    cfg_x = dataclasses.replace(cfg_p, nn_backend="xla")
    src, msk, dst, _ = _pair_batch(2, 512, dtype=jnp.float32)
    res_p = ShardedAligner(mesh=mesh, cfg=cfg_p)(src, msk, dst)
    res_x = ShardedAligner(mesh=mesh, cfg=cfg_x)(src, msk, dst)
    for b in range(2):
        single = icp_loop.align(
            pc.PointCloud(points=src[b], mask=msk[b]),
            pc.PointCloud(points=dst[b], mask=jnp.ones(dst[b].shape[0], bool)),
            cfg=cfg_p,
        )
        np.testing.assert_allclose(
            np.asarray(res_p.T)[b], np.asarray(single.T), rtol=1e-4, atol=1e-5
        )
        np.testing.assert_allclose(
            np.asarray(res_p.T)[b], np.asarray(res_x.T)[b], rtol=1e-4, atol=1e-5
        )


def test_sharded_point_to_plane(mesh):
    # plane-rich scene: point-to-plane should converge on a small offset
    cfg = ICPConfig(
        method="point_to_plane", max_iters=30, nn_backend="xla", damping=1e-9
    )
    rng = np.random.default_rng(3)
    src3 = synthetic.surface_cloud(505, rng)
    T_gt = synthetic.rigid_transform(3, rng, rot_scale=0.05, trans_scale=0.1)
    dst3 = src3 @ T_gt[:3, :3].T + T_gt[:3, 3]
    # normals from the golden plane-fit: use k-NN plane fit on dst
    from tpu_icp_slam.mapping.normals import normals_knn

    cl_d = pc.make(dst3, capacity=512, dtype=jnp.float64)
    nrm = normals_knn(cl_d.points, cl_d.mask, k=12)
    cl_s = pc.make(src3, capacity=512, dtype=jnp.float64)
    aligner = ShardedAligner(mesh=mesh, cfg=cfg)
    res = aligner(
        cl_s.points[None],
        cl_s.mask[None],
        cl_d.points[None],
        jnp.asarray(nrm)[None],
    )
    err = np.abs(np.asarray(res.T)[0] - T_gt).max()
    assert err < 5e-3, err
