"""Native host-side preprocessing tier (C, ctypes-bound).

The reference's native split: CUDA for device compute, C++ for the host
runtime (parsing, preprocessing, the frame loop) — SURVEY.md §1a. Here:
Pallas/XLA for device compute, and this small C library for the genuinely
hot host-side ops (per-scan voxel downsampling, polar→Cartesian
conversion). Built on first use with the system compiler into the package
directory, under a name that carries a hash of `voxel.c` and the platform,
so a binary built from other source or on another kind of machine is never
loaded. Every entry point falls back to the NumPy implementation when the
toolchain or the .so is unavailable, so the package stays
pure-Python-functional.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sysconfig
import threading
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "voxel.c")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> str:
    """Where the library built from the current voxel.c lives."""
    with open(_SRC, "rb") as fh:
        h = hashlib.sha256(fh.read() + sysconfig.get_platform().encode())
    return os.path.join(_HERE, f"_voxel_native-{h.hexdigest()[:16]}.so")


def _build(path: str) -> Optional[str]:
    cc = os.environ.get("CC", "cc")
    tmp = f"{path}.{os.getpid()}.tmp"  # concurrent builders never collide
    cmd = [cc, "-O3", "-shared", "-fPIC", "-o", tmp, _SRC, "-lm"]
    try:
        subprocess.run(
            cmd, check=True, capture_output=True, timeout=120, cwd=_HERE
        )
        os.replace(tmp, path)
        return path
    except Exception:
        return None


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("TPU_ICP_SLAM_NO_NATIVE") == "1":
            return None
        path = library_path()
        if not os.path.exists(path):
            path = _build(path)
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
        lib.voxel_downsample_f64.restype = ctypes.c_long
        lib.voxel_downsample_f64.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_long, ctypes.c_int,
            ctypes.c_double, ctypes.POINTER(ctypes.c_long),
        ]
        lib.polar_to_cartesian_f64.restype = ctypes.c_long
        lib.polar_to_cartesian_f64.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.c_long, ctypes.c_double, ctypes.POINTER(ctypes.c_double),
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def voxel_downsample(points: np.ndarray, voxel: float) -> Optional[np.ndarray]:
    """First point per voxel, scan order. None if the native lib is absent."""
    lib = _load()
    if lib is None:
        return None
    pts = np.ascontiguousarray(points, dtype=np.float64)
    n, dim = pts.shape
    out = np.empty(n, dtype=np.int64)
    kept = lib.voxel_downsample_f64(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.c_long(n),
        ctypes.c_int(dim),
        ctypes.c_double(float(voxel)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
    )
    if kept < 0:
        return None
    return points[out[:kept]]


def polar_to_cartesian(
    ranges: np.ndarray, angles: np.ndarray, max_range: float
) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    r = np.ascontiguousarray(ranges, dtype=np.float64)
    a = np.ascontiguousarray(angles, dtype=np.float64)
    out = np.empty((len(r), 2), dtype=np.float64)
    k = lib.polar_to_cartesian_f64(
        r.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        a.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.c_long(len(r)),
        ctypes.c_double(float(max_range)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    return out[:k]
