"""tpu_icp_slam — an ICP-SLAM engine built from scratch in JAX/XLA/Pallas for
NVIDIA GPUs (one H100, or four joined by NVLink).

Capability parity target: michaelwillett/GPU-ICP-SLAM (CUDA; see SURVEY.md — the
reference mount is empty, so parity is defined against SURVEY.md §2's inventory,
not against file:line citations).

Layer map (SURVEY.md §1b):
  core/     — SE(2)/SE(3) algebra, padded point clouds       (L0)
  kernels/  — Triton-route Pallas NN kernel + XLA versions    (L1)
  icp/      — point-to-point / point-to-plane / projective    (L2)
  mapping/  — occupancy grid, voxel map, normals              (L3)
  slam/     — per-frame pipeline, keyframes, odometry         (L4)
  backend/  — loop closure, pose-graph optimization           (L5)
  datasets/ — CARMEN / TUM / KITTI loaders + synthetic        (L6)
  dist/     — mesh, shardings, collectives                    (L7)
  obs/      — metrics, timers, profiling                      (L8)
  config/   — frozen dataclass config tree                    (L9)
  cli.py    — run / align / bench / eval                      (L10)
  eval/     — ATE/RPE metrics, golden fp64 CPU ICP oracle
"""

__version__ = "0.1.0"
