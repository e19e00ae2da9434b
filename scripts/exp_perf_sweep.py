"""Which op dominates the scan-to-map step? Sweep structural sizes on the GPU."""
import sys, os, time
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))
import numpy as np, jax
from tpu_icp_slam.obs import realize  # host readback: the run has completed
from tpu_icp_slam.config import SlamConfig, ICPConfig, MappingConfig, PipelineConfig
from tpu_icp_slam.datasets import synthetic
from tpu_icp_slam.core.pointcloud import voxel_downsample_np
from tpu_icp_slam.slam.runner import pad_scans
from tpu_icp_slam.slam.scan_to_map import ScanToMapPipeline

scans, _ = synthetic.velodyne_log(n_frames=40, n_rings=16, n_azimuth=512)
scans = [voxel_downsample_np(s, 0.3) for s in scans]

def run(tag, **kw):
    cfg = SlamConfig(
        icp=ICPConfig(method=kw.get('method','point_to_plane'), max_iters=kw.get('iters',20),
                      max_corr_dist=1.5, damping=1e-3, max_step_trans=1.0, max_step_rot=0.3,
                      min_inliers=50, huber_delta=0.3, tol=1e-5,
                      nn_backend=kw.get('nn','auto')),
        mapping=MappingConfig(map_capacity=kw.get('mapcap',65536),
                              local_model_size=kw.get('lms',8192), map_voxel=0.3),
        pipeline=PipelineConfig(mode='scan_to_map', scan_capacity=4096,
                                keyframe_trans=kw.get('kft',2.0), keyframe_rot=0.2),
    )
    pts, msk = pad_scans(scans, 4096)
    pipe = ScanToMapPipeline(cfg)
    st0 = pipe.init_state(pts[0], msk[0])
    t0 = time.perf_counter()
    st, infos = pipe.run_fused(st0, pts[1:], msk[1:])
    realize(infos['pose'])
    comp = time.perf_counter()-t0
    best = 1e9
    for _ in range(3):
        t0 = time.perf_counter()
        st, infos = pipe.run_fused(st0, pts[1:], msk[1:])
        realize(infos['pose'])
        best = min(best, time.perf_counter()-t0)
    it = float(np.asarray(infos['iters']).mean())
    print(f"{tag}: {39/best:.0f} fps  us/frame={best/39*1e6:.0f}  iters={it:.1f} compile={comp:.0f}s", flush=True)

for spec in sys.argv[1:]:
    name, _, kvs = spec.partition(':')
    kw = {}
    for kv in kvs.split(',') if kvs else []:
        k, v = kv.split('=')
        kw[k] = v if k in ('nn','method') else (float(v) if '.' in v or 'e' in v else int(v))
    run(name, **kw)
