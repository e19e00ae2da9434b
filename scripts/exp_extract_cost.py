"""Does extract_local's top_k over the map dominate at KITTI scale?"""
import sys, os, time
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))
import numpy as np, jax
from tpu_icp_slam.obs import realize  # host readback: the run has completed
from tpu_icp_slam.config import SlamConfig, ICPConfig, MappingConfig, PipelineConfig
from tpu_icp_slam.datasets import synthetic
from tpu_icp_slam.core.pointcloud import voxel_downsample_np
from tpu_icp_slam.slam.runner import pad_scans
from tpu_icp_slam.slam.scan_to_map import ScanToMapPipeline

scans, _ = synthetic.velodyne_log(n_frames=30, n_rings=48, n_azimuth=1024)
scans = [voxel_downsample_np(s, 0.15) for s in scans]

def run(tag, mapcap):
    cfg = SlamConfig(
        icp=ICPConfig(method='point_to_plane', max_iters=20, max_corr_dist=1.0,
                      damping=1e-3, max_step_trans=1.0, max_step_rot=0.3,
                      min_inliers=100, huber_delta=0.3, tol=1e-5,
                      step_scale=1.4, tol_update=0.01),
        mapping=MappingConfig(map_capacity=mapcap, local_model_size=16384, map_voxel=0.2),
        pipeline=PipelineConfig(mode='scan_to_map', scan_capacity=16384,
                                keyframe_trans=1.5, keyframe_rot=0.2),
    )
    pts, msk = pad_scans(scans, cfg.pipeline.scan_capacity)
    pipe = ScanToMapPipeline(cfg)
    st0 = pipe.init_state(pts[0], msk[0])
    st, infos = pipe.run_fused(st0, pts[1:], msk[1:])
    realize(infos['pose'])
    best = 1e9
    for _ in range(3):
        t0 = time.time()
        st, infos = pipe.run_fused(st0, pts[1:], msk[1:])
        realize(infos['pose'])
        best = min(best, time.time()-t0)
    print(f'{tag}: {29/best:.0f} fps us/frame={best/29*1e6:.0f} iters={float(np.asarray(infos["iters"]).mean()):.1f}', flush=True)

run('map32k', 32768)
run('map131k', 131072)
