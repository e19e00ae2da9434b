"""Communication-volume accounting (dist/comm.py; SURVEY.md §5, config 5)."""

import numpy as np

from tpu_icp_slam.dist import comm

H100 = "NVIDIA H100 80GB HBM3"


def test_ring_allreduce_wire_bytes():
    assert comm.ring_allreduce_wire_bytes(100.0, 1) == 0.0
    # 2 devices: each sends/receives half twice -> 1.0x payload
    assert comm.ring_allreduce_wire_bytes(100.0, 2) == 100.0
    # n -> inf: approaches 2x payload
    assert abs(comm.ring_allreduce_wire_bytes(100.0, 100) - 198.0) < 1e-9


def test_sharded_icp_payloads_exact():
    p2p = comm.sharded_icp_psum_payload("point_to_point", d=3)
    # Σw(1) + Σwp(3) + Σwq(3) + Σw p qᵀ(9) + stats(3) = 19 floats
    assert p2p["floats_per_iteration"] == 19
    assert p2p["payload_bytes_per_iteration"] == 76
    ptp = comm.sharded_icp_psum_payload("point_to_plane", d=3)
    # H(36) + g(6) + stats(3) = 45 floats
    assert ptp["floats_per_iteration"] == 45
    assert ptp["payload_bytes_per_iteration"] == 180


def test_schur_payload_matches_docstring_formula():
    out = comm.schur_psum_payload(n_separator=16)
    assert out["floats_per_iteration"] == (16 * 6) ** 2 + 16 * 6
    assert out["payload_bytes_per_iteration"] == 4 * ((16 * 6) ** 2 + 16 * 6)


def test_kitti_regime_frontend_is_compute_dominated():
    """The DESIGN.md §8 claim in executable form: point-sharded ICP at the
    16k×16k regime is compute-dominated by orders of magnitude."""
    row = comm.sharded_icp_scaling_model(
        m_points=16384, n_points=16384, iters=3.4, n_devices=4,
        device_kind=H100, method="point_to_plane",
    )
    assert row["efficiency_bound"] > 0.999, row
    assert row["compute_s_at_peak"] > 100 * row["comm_s"], row


def test_toy_schur_is_comm_dominated():
    """Distributing a toy graph is a loss — the model must say so (the
    honest shape of the accounting, not a flattering one)."""
    row = comm.schur_scaling_model(
        n_separator=16, n_interior_max=8, n_factors=64, iters=2, n_devices=8,
        device_kind=H100,
    )
    assert row["efficiency_bound"] < 0.5, row


def test_kitti_scale_schur_bound_high():
    """At 512 keyframes / 2 blocks the interior Cholesky dwarfs the
    separator psum over NVLink (DESIGN.md §8 break-even)."""
    row = comm.schur_scaling_model(
        n_separator=24, n_interior_max=244, n_factors=600, iters=10,
        n_devices=2, device_kind=H100,
    )
    assert row["efficiency_bound"] > 0.9, row


def test_separator_count_on_real_graph():
    import jax.numpy as jnp

    from tpu_icp_slam.backend import pose_graph as pg
    from tpu_icp_slam.datasets import synthetic

    rng = np.random.default_rng(0)
    poses = [np.eye(4)]
    factors = []
    for i in range(1, 16):
        rel = synthetic.rigid_transform(3, rng, rot_scale=0.1, trans_scale=1.0)
        poses.append(poses[-1] @ rel)
        factors.append((i - 1, i, rel, 1.0))
    factors.append((0, 15, np.linalg.inv(poses[0]) @ poses[-1], 2.0))
    g = pg.from_arrays(np.stack(poses), factors, dtype=jnp.float32)
    ns = comm.schur_separator_count(g, 4)
    # block boundaries (3 cross-block odometry factors -> 6 endpoints) plus
    # the loop endpoints/anchor; must be small relative to 16 poses
    assert 2 <= ns <= 10, ns
