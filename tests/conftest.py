"""Test harness configuration.

The unit suite runs on CPU with 8 virtual devices (SURVEY.md §4b: distributed
logic is tested on a forced-host-platform mesh; the Pallas NN kernel runs in
interpret mode on CPU). Tests that need the card carry the `gpu` marker and
skip on the CPU; on a machine with a GPU they run with

    ICP_SLAM_TESTS_ON_GPU=1 python -m pytest -m gpu tests/

Must run before jax is imported anywhere — pytest loads conftest first.
"""

import os
import sys

ON_GPU = os.environ.get("ICP_SLAM_TESTS_ON_GPU") == "1"
if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import jax  # noqa: E402

import pytest  # noqa: E402

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")
# persistent compilation cache: the CPU-mesh shard_map/Schur tests compile
# 10-60s programs — cache them across suite runs at a fixed path OUTSIDE the
# checkout, so CPU artifacts never ride along in a tree copied to the card
from tpu_icp_slam.obs.compile_cache import enable as _enable_cache  # noqa: E402

_enable_cache(os.path.join(os.path.expanduser("~"), ".cache",
                           "tpu_icp_slam_cpu_tests"))
# x64 for the whole suite: fp64 oracles need it, and enabling it per-module
# leaks into other modules anyway (global config). Library code pins explicit
# f32 dtypes, so it must stay correct under x64 — which is itself a property
# worth testing.
jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu():
    """Skip unless JAX's default platform is a GPU. Decided here, when the
    test runs, never while a module is imported."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (ICP_SLAM_TESTS_ON_GPU=1 on the card)")
    return jax.devices()[0]
