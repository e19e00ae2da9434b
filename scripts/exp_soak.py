"""Soak: 300-frame log (~300 m zigzag), map capacity saturates + evicts."""
import sys, os, time
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))
import numpy as np, numpy.linalg as la, jax
from tpu_icp_slam.obs import realize  # host readback: the run has completed
from tpu_icp_slam.obs.compile_cache import enable
enable()
from tpu_icp_slam.config import SlamConfig, ICPConfig, MappingConfig, PipelineConfig
from tpu_icp_slam.datasets import synthetic
from tpu_icp_slam.core.pointcloud import voxel_downsample_np
from tpu_icp_slam.slam.runner import pad_scans
from tpu_icp_slam.slam.scan_to_map import ScanToMapPipeline
from tpu_icp_slam.eval import metrics as em

# two 8 m-spaced lanes driven out-and-back twice (~340 m): U-turns need
# >= 2x the turn radius of lane gap — tighter reversals are physically
# unsmoothable (and no real vehicle performs them)
def _semi(cx, cy, r, sign):
    # semicircular U-turn waypoints, 30-degree spacing
    return [(cx + sign * r * np.cos(a), cy + r * np.sin(a))
            for a in np.linspace(-np.pi / 2, np.pi / 2, 7)]
def _lap():
    return ([(-36, -4), (20, -4)] + _semi(20, 0, 4, +1)
            + [(20, 4), (-36, 4)] + _semi(-36, 0, 4, -1)[::-1])
wps = _lap() + _lap()
F = 300
scans, gt = synthetic.velodyne_log(n_frames=F, n_rings=16, n_azimuth=384, waypoints=wps)
scans = [voxel_downsample_np(s, 0.4) for s in scans]
gt_rel = np.einsum('ij,fjk->fik', la.inv(gt[0]), gt)
cfg = SlamConfig(
    icp=ICPConfig(method='point_to_plane', max_iters=20, max_corr_dist=1.5,
                  damping=1e-3, max_step_trans=1.0, max_step_rot=0.3, min_inliers=50,
                  huber_delta=0.3, tol=1e-5, step_scale=1.4, tol_update=0.005),
    mapping=MappingConfig(map_capacity=32768, local_model_size=8192, map_voxel=0.3),
    pipeline=PipelineConfig(mode='scan_to_map', scan_capacity=2048,
                            keyframe_trans=1.5, keyframe_rot=0.15),
)
pts, msk = pad_scans(scans, cfg.pipeline.scan_capacity)
pipe = ScanToMapPipeline(cfg)
t0 = time.time()
st = pipe.init_state(pts[0], msk[0])
st, infos = pipe.run_fused(st, pts[1:], msk[1:])
realize(infos['pose'])
print('compile+run', round(time.time()-t0,1), 's', flush=True)
poses = np.concatenate([np.eye(4)[None], np.asarray(infos['pose'])])
err = la.norm(poses[:,:3,3]-gt_rel[:len(poses),:3,3],axis=1)
mapn = np.asarray(infos['map_points'])
print('map fill:', mapn[::60], 'cap', cfg.mapping.map_capacity, flush=True)
print('err@every50', err[::50].round(3), 'final', err[-1].round(3), flush=True)
print('ATE', round(em.ate_rmse(poses[:,:3,3], gt_rel[:len(poses),:3,3]),4),
      'kfs', int(np.asarray(infos['is_keyframe']).sum()), flush=True)
t0=time.time()
st2 = pipe.init_state(pts[0], msk[0])
st2, infos2 = pipe.run_fused(st2, pts[1:], msk[1:])
realize(infos2['pose'])
print(f'steady: {299/(time.time()-t0):.0f} frames/s', flush=True)
