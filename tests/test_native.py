"""Native C preprocessing tier vs the NumPy reference implementations."""

import os

import numpy as np
import pytest

from tpu_icp_slam import native


def _numpy_downsample(points, voxel):
    keys = np.floor(points / voxel).astype(np.int64)
    _, idx = np.unique(keys, axis=0, return_index=True)
    return points[np.sort(idx)]


@pytest.mark.skipif(not native.available(), reason="no C toolchain")
def test_native_voxel_downsample_matches_numpy():
    rng = np.random.default_rng(0)
    for n, dim, voxel in [(5000, 3, 0.3), (2000, 2, 0.1), (100, 3, 5.0)]:
        pts = rng.uniform(-40, 40, (n, dim))
        got = native.voxel_downsample(pts, voxel)
        want = _numpy_downsample(pts, voxel)
        np.testing.assert_allclose(got, want)


@pytest.mark.skipif(not native.available(), reason="no C toolchain")
def test_native_polar_to_cartesian():
    rng = np.random.default_rng(1)
    n = 720
    ranges = rng.uniform(0.1, 12.0, n)
    ranges[::7] = 12.0  # misses
    angles = np.linspace(-np.pi, np.pi, n, endpoint=False)
    got = native.polar_to_cartesian(ranges, angles, 12.0)
    hit = ranges < 12.0 * 0.999
    want = np.stack(
        [ranges[hit] * np.cos(angles[hit]), ranges[hit] * np.sin(angles[hit])],
        axis=1,
    )
    np.testing.assert_allclose(got, want, atol=1e-12)


def test_downsample_fallback_consistency():
    # the public entry must give identical results whether or not the native
    # path is active
    import os

    from tpu_icp_slam.core.pointcloud import voxel_downsample_np

    rng = np.random.default_rng(2)
    pts = rng.uniform(-20, 20, (3000, 3))
    a = voxel_downsample_np(pts, 0.4)
    b = _numpy_downsample(pts, 0.4)
    np.testing.assert_allclose(a, b)
    _ = os


def test_library_path_tracks_source_and_platform(tmp_path, monkeypatch):
    """The binary's name carries a hash of voxel.c and the platform, so a
    binary built from other source (or copied from elsewhere) is never
    loaded in its place."""
    a = native.library_path()
    assert os.path.basename(a).startswith("_voxel_native-")
    fake = tmp_path / "voxel.c"
    fake.write_text("/* other source */\n")
    monkeypatch.setattr(native, "_SRC", str(fake))
    assert native.library_path() != a
