import jax

# Geometry matmuls (3x3/4x4 composes, point transforms, the normal
# equations, the XLA NN version's cross term) must stay in full float32. On
# the GPU a float32 matmul may otherwise run in TF32, which keeps about three
# decimal digits — far too few for poses and distances at tens of metres.
# chip_smoke.py prints the effective setting.
jax.config.update("jax_default_matmul_precision", "highest")

from tpu_icp_slam.core import se2, se3, pointcloud  # noqa: E402,F401
