"""Is the voxel insert sort the soak's bottleneck? A/B keyframe rate."""
import sys, os, time
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))
import numpy as np, jax
from tpu_icp_slam.obs import realize  # host readback: the run has completed
from tpu_icp_slam.obs.compile_cache import enable
enable()
from tpu_icp_slam.config import SlamConfig, ICPConfig, MappingConfig, PipelineConfig
from tpu_icp_slam.datasets import synthetic
from tpu_icp_slam.core.pointcloud import voxel_downsample_np
from tpu_icp_slam.slam.runner import pad_scans
from tpu_icp_slam.slam.scan_to_map import ScanToMapPipeline

def _semi(cx, cy, r, sign):
    return [(cx + sign*r*np.cos(a), cy + r*np.sin(a)) for a in np.linspace(-np.pi/2, np.pi/2, 7)]
def _lap():
    return ([(-36,-4),(20,-4)] + _semi(20,0,4,+1) + [(20,4),(-36,4)] + _semi(-36,0,4,-1)[::-1])
scans, gt = synthetic.velodyne_log(n_frames=300, n_rings=16, n_azimuth=384, waypoints=_lap()+_lap())
scans = [voxel_downsample_np(s, 0.4) for s in scans]

def run(tag, kft):
    cfg = SlamConfig(
        icp=ICPConfig(method='point_to_plane', max_iters=20, max_corr_dist=1.5,
                      damping=1e-3, max_step_trans=1.0, max_step_rot=0.3, min_inliers=50,
                      huber_delta=0.3, tol=1e-5, step_scale=1.4, tol_update=0.005),
        mapping=MappingConfig(map_capacity=32768, local_model_size=8192, map_voxel=0.3),
        pipeline=PipelineConfig(mode='scan_to_map', scan_capacity=2048,
                                keyframe_trans=kft, keyframe_rot=0.15 if kft < 1e8 else 1e9),
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
    kfs = int(np.asarray(infos['is_keyframe']).sum())
    print(f"{tag}: {299/best:.0f} fps us/frame={best/299*1e6:.0f} kfs={kfs}", flush=True)

run('kf-every-1.5m', 1.5)
run('no-inserts', 1e9)
run('kf-every-4m', 4.0)
