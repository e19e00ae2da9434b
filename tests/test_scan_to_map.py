"""Config-4a tests: voxel map, KITTI loader round-trip, scan-to-map pipeline."""

import dataclasses

import jax.numpy as jnp
import numpy as np

from tpu_icp_slam.config import ICPConfig, MappingConfig, PipelineConfig, SlamConfig
from tpu_icp_slam.datasets import kitti, synthetic
from tpu_icp_slam.mapping import voxel_map
from tpu_icp_slam.slam.runner import pad_scans


# --------------------------------------------------------------------------
# voxel map
# --------------------------------------------------------------------------

def test_voxel_insert_dedups():
    vm = voxel_map.create(64)
    pts = jnp.asarray(
        [[0.05, 0.05, 0.05], [0.06, 0.06, 0.06], [1.0, 1.0, 1.0]], jnp.float32
    )
    msk = jnp.ones(3, bool)
    nrm = jnp.zeros((3, 3), jnp.float32)
    vm = voxel_map.insert(vm, pts, msk, nrm, voxel=0.4)
    # first two share a voxel -> 2 unique
    assert int(voxel_map.count(vm)) == 2
    # reinsert: no growth, existing points win
    vm2 = voxel_map.insert(vm, pts + 0.01, msk, nrm, voxel=0.4)
    assert int(voxel_map.count(vm2)) == 2
    kept = np.sort(np.asarray(vm2.points[vm2.mask])[:, 0])
    np.testing.assert_allclose(kept, [0.05, 1.0], atol=1e-6)


def test_voxel_insert_respects_capacity_and_mask():
    vm = voxel_map.create(8)
    rng = np.random.default_rng(0)
    pts = jnp.asarray(rng.uniform(-10, 10, (32, 3)), jnp.float32)
    msk = jnp.asarray([True] * 16 + [False] * 16)
    nrm = jnp.zeros((32, 3), jnp.float32)
    vm = voxel_map.insert(vm, pts, msk, nrm, voxel=0.1)
    assert int(voxel_map.count(vm)) == 8  # capped
    # masked-out points never inserted
    vm2 = voxel_map.create(64)
    vm2 = voxel_map.insert(vm2, pts, jnp.zeros(32, bool), nrm, voxel=0.1)
    assert int(voxel_map.count(vm2)) == 0


def test_extract_local_nearest():
    vm = voxel_map.create(32)
    pts = jnp.asarray([[float(i), 0.0, 0.0] for i in range(10)], jnp.float32)
    vm = voxel_map.insert(
        vm, pts, jnp.ones(10, bool), jnp.zeros((10, 3), jnp.float32), voxel=0.4
    )
    loc, _, msk, r_cover = voxel_map.extract_local(
        vm, jnp.asarray([0.0, 0.0, 0.0]), 4
    )
    got = np.sort(np.asarray(loc[msk])[:, 0])
    np.testing.assert_allclose(got, [0, 1, 2, 3], atol=1e-6)
    # map (10 pts) exceeds model size (4): coverage radius = farthest selected
    np.testing.assert_allclose(float(r_cover), 3.0, atol=1e-5)
    # radius gate
    loc, _, msk, r_cover = voxel_map.extract_local(
        vm, jnp.asarray([0.0, 0.0, 0.0]), 8, radius=2.5
    )
    assert int(msk.sum()) == 3
    assert float(r_cover) <= 2.5 + 1e-6


# --------------------------------------------------------------------------
# KITTI loader
# --------------------------------------------------------------------------

def test_kitti_roundtrip(tmp_path):
    scans, poses = synthetic.velodyne_log(n_frames=3, n_rings=4, n_azimuth=64)
    Tr = np.eye(4)
    Tr[:3, :3] = [[0, -1, 0], [0, 0, -1], [1, 0, 0]]  # velo->cam0-style axes
    Tr[:3, 3] = [0.1, -0.05, -0.3]
    kitti.write_sequence(str(tmp_path), scans, poses, Tr=Tr)
    scans2, poses2 = kitti.load_sequence(str(tmp_path))
    assert len(scans2) == 3
    np.testing.assert_allclose(scans2[1], scans[1], atol=1e-6)
    np.testing.assert_allclose(poses2, poses, atol=1e-8)


# --------------------------------------------------------------------------
# scan-to-map pipeline
# --------------------------------------------------------------------------

def _s2m_cfg():
    return SlamConfig(
        icp=ICPConfig(
            method="point_to_plane",
            max_iters=15,
            max_corr_dist=1.5,
            nn_backend="xla",
            damping=1e-3,
            max_step_trans=1.0,
            max_step_rot=0.3,
            min_inliers=50,
            huber_delta=0.3,
        ),
        mapping=MappingConfig(
            map_capacity=32768, local_model_size=4096, map_voxel=0.3
        ),
        pipeline=PipelineConfig(
            mode="scan_to_map",
            scan_capacity=2048,
            keyframe_trans=2.0,
            keyframe_rot=0.2,
        ),
    )


def test_scan_to_map_odometry_tracks_gt():
    from tpu_icp_slam.core.pointcloud import voxel_downsample_np
    from tpu_icp_slam.eval import metrics as em
    from tpu_icp_slam.slam.scan_to_map import ScanToMapPipeline

    # ~1 m/frame (KITTI-like): 25 frames over 30% of the route
    scans, gt = synthetic.velodyne_log(
        n_frames=25, n_rings=16, n_azimuth=320, path_fraction=0.3
    )
    scans = [voxel_downsample_np(s, 0.4) for s in scans]
    cfg = _s2m_cfg()
    pts, msk = pad_scans(scans, cfg.pipeline.scan_capacity)
    pipe = ScanToMapPipeline(cfg)
    state = pipe.init_state(pts[0], msk[0])
    state, infos = pipe.run_fused(state, pts[1:], msk[1:])
    poses = np.concatenate([np.eye(4)[None], np.asarray(infos["pose"])])
    # GT starts at a nonzero pose: compare relative to frame 0
    gt_rel = np.einsum("ij,fjk->fik", np.linalg.inv(gt[0]), gt)
    ate = em.ate_rmse(poses[:, :3, 3], gt_rel[: len(poses), :3, 3])
    assert ate < 0.15, f"scan-to-map ATE {ate}"
    assert int(infos["is_keyframe"].sum()) >= 1
    assert int(np.asarray(infos["map_points"])[-1]) > int(
        np.asarray(infos["map_points"])[0]
    )


def test_extract_hysteresis_tracks_gt():
    """Local-model reuse (mapping.extract_hysteresis) must not degrade
    tracking: same log as test_scan_to_map_odometry_tracks_gt, model
    re-extracted only after >3 m of motion or a keyframe insert (r3 SOL
    decomposition: the every-frame top_k was ~12% of the frame budget)."""
    from tpu_icp_slam.core.pointcloud import voxel_downsample_np
    from tpu_icp_slam.eval import metrics as em
    from tpu_icp_slam.slam.scan_to_map import ScanToMapPipeline

    scans, gt = synthetic.velodyne_log(
        n_frames=25, n_rings=16, n_azimuth=320, path_fraction=0.3
    )
    scans = [voxel_downsample_np(s, 0.4) for s in scans]
    cfg = _s2m_cfg()
    cfg = dataclasses.replace(
        cfg, mapping=dataclasses.replace(cfg.mapping, extract_hysteresis=3.0)
    )
    pts, msk = pad_scans(scans, cfg.pipeline.scan_capacity)
    pipe = ScanToMapPipeline(cfg)
    state = pipe.init_state(pts[0], msk[0])
    state, infos = pipe.run_fused(state, pts[1:], msk[1:])
    poses = np.concatenate([np.eye(4)[None], np.asarray(infos["pose"])])
    gt_rel = np.einsum("ij,fjk->fik", np.linalg.inv(gt[0]), gt)
    ate = em.ate_rmse(poses[:, :3, 3], gt_rel[: len(poses), :3, 3])
    assert ate < 0.15, f"hysteresis scan-to-map ATE {ate}"


def test_scan_to_map_streaming_matches_fused():
    from tpu_icp_slam.core.pointcloud import voxel_downsample_np
    from tpu_icp_slam.slam.scan_to_map import ScanToMapPipeline

    scans, _ = synthetic.velodyne_log(
        n_frames=4, n_rings=8, n_azimuth=128, path_fraction=0.2
    )
    scans = [voxel_downsample_np(s, 0.6) for s in scans]
    cfg = _s2m_cfg()
    cfg = dataclasses.replace(
        cfg, pipeline=dataclasses.replace(cfg.pipeline, scan_capacity=512)
    )
    pts, msk = pad_scans(scans, cfg.pipeline.scan_capacity)
    pipe = ScanToMapPipeline(cfg)
    s_f = pipe.init_state(pts[0], msk[0])
    s_f, infos = pipe.run_fused(s_f, pts[1:], msk[1:])
    s_s = pipe.init_state(pts[0], msk[0])
    stream_poses = []
    for i in range(1, len(pts)):
        s_s, info = pipe.step(s_s, pts[i], msk[i])
        stream_poses.append(np.asarray(info["pose"]))
    np.testing.assert_allclose(
        np.asarray(infos["pose"]), np.stack(stream_poses), rtol=1e-5, atol=1e-5
    )


def test_run_kitti_dir_end_to_end(tmp_path):
    """Drop-in format check: write a KITTI-layout dir, run SLAM via the runner."""
    from tpu_icp_slam.core.pointcloud import voxel_downsample_np
    from tpu_icp_slam.slam.runner import load_dataset, run_slam

    scans, poses = synthetic.velodyne_log(
        n_frames=4, n_rings=6, n_azimuth=96, path_fraction=0.15
    )
    kitti.write_sequence(str(tmp_path / "seq"), scans, poses)
    (tmp_path / "seq" / "velodyne").exists()
    data = load_dataset(str(tmp_path / "seq"), frames=4)
    assert data.dim == 3 and len(data.scans) == 4
    cfg = SlamConfig(
        icp=ICPConfig(method="point_to_point", max_iters=8, max_corr_dist=2.0,
                      nn_backend="xla"),
        mapping=MappingConfig(map_capacity=4096, local_model_size=512,
                              map_voxel=0.5),
        pipeline=PipelineConfig(mode="scan_to_map", scan_capacity=512,
                                downsample_voxel=0.8),
    )
    out, report = run_slam(cfg, data, out_dir=str(tmp_path / "out"))
    assert np.isfinite(out).all()
    assert "ate_rmse" in report
    assert (tmp_path / "out" / "map.png").exists()


def test_insert_hash_matches_sort_voxel_set():
    """Hash-probe insert must produce the same SURVIVING VOXEL SET as the
    lexsort insert when nothing evicts (the dedup contract); slot order may
    differ (hash keeps existing slots put — that's the point)."""
    import jax.numpy as jnp

    from tpu_icp_slam.mapping import voxel_map

    rng = np.random.default_rng(0)
    vox = 0.5
    a = rng.uniform(-8, 8, (300, 3)).astype(np.float32)
    b = rng.uniform(-8, 8, (300, 3)).astype(np.float32)
    b[:60] = a[:60] + 0.01  # overlapping voxels: existing must win

    def build(ins):
        vm = voxel_map.create(2048)
        vm = ins(vm, jnp.asarray(a), jnp.ones(300, bool),
                 jnp.zeros((300, 3), jnp.float32), voxel=vox)
        vm = ins(vm, jnp.asarray(b), jnp.ones(300, bool),
                 jnp.zeros((300, 3), jnp.float32), voxel=vox)
        return vm

    vm_s = build(voxel_map.insert)
    vm_h = build(voxel_map.insert_hash)

    def voxels(vm):
        p = np.asarray(vm.points)[np.asarray(vm.mask)]
        return set(map(tuple, np.floor(p / vox).astype(np.int64)))

    vs, vh = voxels(vm_s), voxels(vm_h)
    # hash-probe overflow may rarely admit a duplicate voxel (wastes a
    # slot, loses nothing) — require equality of the voxel set
    assert vs == vh, (len(vs), len(vh), vs ^ vh)
    # existing-point-wins tie policy: the overlapping voxels hold the
    # FIRST-inserted coordinates in both
    pa = np.asarray(vm_h.points)[np.asarray(vm_h.mask)]
    for i in range(20):
        d = np.linalg.norm(pa - a[i], axis=1).min()
        assert d < 1e-5, f"existing point {i} displaced (nearest {d})"


def test_insert_hash_capacity_and_eviction():
    import jax.numpy as jnp

    from tpu_icp_slam.mapping import voxel_map

    rng = np.random.default_rng(1)
    vox = 0.4
    cap = 256
    vm = voxel_map.create(cap)
    # fill beyond capacity from a ring far from the origin
    far = rng.uniform(6, 10, (400, 3)).astype(np.float32)
    vm = voxel_map.insert_hash(vm, jnp.asarray(far), jnp.ones(400, bool),
                               jnp.zeros((400, 3), jnp.float32), voxel=vox,
                               center=jnp.zeros(3))
    assert int(voxel_map.count(vm)) <= cap
    # now insert near points with spatial eviction around the origin:
    # near points must displace far ones
    near = rng.uniform(-1, 1, (200, 3)).astype(np.float32)
    vm = voxel_map.insert_hash(vm, jnp.asarray(near), jnp.ones(200, bool),
                               jnp.zeros((200, 3), jnp.float32), voxel=vox,
                               center=jnp.zeros(3))
    pts = np.asarray(vm.points)[np.asarray(vm.mask)]
    n_near = (np.linalg.norm(pts, axis=1) < 2.0).sum()
    assert n_near >= 100, f"only {n_near} near points survived eviction"
    assert int(voxel_map.count(vm)) <= cap


def test_voxel_insert_spatial_eviction():
    """With a center, the nearest points survive overflow — not the oldest."""
    vm = voxel_map.create(8)
    far = jnp.asarray([[50.0 + i, 0.0, 0.0] for i in range(8)], jnp.float32)
    near = jnp.asarray([[float(i), 0.0, 0.0] for i in range(8)], jnp.float32)
    ones = jnp.ones(8, bool)
    zn = jnp.zeros((8, 3), jnp.float32)
    vm = voxel_map.insert(vm, far, ones, zn, voxel=0.4)  # fills capacity
    center = jnp.asarray([0.0, 0.0, 0.0])
    vm = voxel_map.insert(vm, near, ones, zn, voxel=0.4, center=center)
    kept_x = np.sort(np.asarray(vm.points[vm.mask])[:, 0])
    # all 8 near points (x 0..7) must have displaced the far ones (x 50..57)
    np.testing.assert_allclose(kept_x, np.arange(8), atol=1e-6)


def test_clamped_flag_signals_trust_region_binding():
    """infos["clamped"] (r5b): a frame whose motion outruns the total-
    correction trust-region ball must be flagged (the solver's correction
    sits ON the ball); ordinary tracking frames must not. This is the
    iteration-strain-silent walk-off signal (BASELINE.md r5b endurance
    forensics) that BackendConfig.strain_on_clamp feeds into pose-graph
    odometry weights."""
    import dataclasses

    from tpu_icp_slam.core.pointcloud import voxel_downsample_np
    from tpu_icp_slam.slam.scan_to_map import ScanToMapPipeline

    scans, gt = synthetic.velodyne_log(
        n_frames=8, n_rings=16, n_azimuth=320, path_fraction=0.1
    )
    scans = [voxel_downsample_np(s, 0.4) for s in scans]
    base = _s2m_cfg()
    cfg = dataclasses.replace(
        base, icp=dataclasses.replace(
            base.icp, max_total_trans=1.0, max_total_rot=0.5
        )
    )
    pts, msk = pad_scans(scans, cfg.pipeline.scan_capacity)
    pipe = ScanToMapPipeline(cfg)

    # normal tracking (~1.5 m/frame): frame 0's correction pegs (the CV
    # model starts at zero velocity) but once the prediction warms up the
    # corrections drop well inside the 1.0 m ball — steady frames must
    # not all flag
    state = pipe.init_state(pts[0], msk[0])
    state, infos = pipe.run_fused(state, pts[1:], msk[1:])
    clamped = np.asarray(infos["clamped"])
    assert clamped.shape == (len(scans) - 1,)
    assert not clamped[1:].all(), "steady tracking flagged every frame"

    # teleport: frame 5's scan jumped ~3 m beyond any prediction — the
    # correction must peg the 1.0 m ball and flag
    jump = scans[5] + np.asarray([3.0, 0.0, 0.0], np.float32)
    pts_j, msk_j = pad_scans([jump], cfg.pipeline.scan_capacity)
    _, info_j = pipe.step(state, pts_j[0], msk_j[0])
    assert bool(info_j["clamped"]), "3 m teleport did not peg the 1.0 m ball"
