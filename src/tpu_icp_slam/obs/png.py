"""Minimal PNG writer and top-down raster helpers (numpy + zlib only).

The map renders are artifacts of `cli run`; they need no plotting library,
so the main path imports nothing beyond numpy.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def write_png(path: str, rgb: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 image, row 0 at the top."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w, _ = rgb.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, -1)],
                         axis=1).tobytes()  # filter byte 0 per row

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n")
        fh.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        fh.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        fh.write(chunk(b"IEND", b""))


def plot(img: np.ndarray, xy: np.ndarray, lo, res: float, color) -> None:
    """Set the pixels under world points (K, 2), y up, to `color` (one RGB
    triple or (K, 3)); points off the image are dropped."""
    h, w = img.shape[:2]
    col = np.floor((xy[:, 0] - lo[0]) / res).astype(np.int64)
    row = h - 1 - np.floor((xy[:, 1] - lo[1]) / res).astype(np.int64)
    ok = (col >= 0) & (col < w) & (row >= 0) & (row < h)
    color = np.asarray(color, np.uint8)
    img[row[ok], col[ok]] = color[ok] if color.ndim == 2 else color


def draw_path(img: np.ndarray, xy: np.ndarray, lo, res: float,
              color=(220, 30, 30)) -> None:
    """Polyline through (K, 2) world points, densified to pixel spacing."""
    if len(xy) < 2:
        return
    seg = np.linalg.norm(np.diff(xy, axis=0), axis=1)
    s = np.concatenate([[0.0], np.cumsum(seg)])
    t = np.linspace(0.0, s[-1], max(2, int(s[-1] / (0.5 * res)) + 1))
    dense = np.stack([np.interp(t, s, xy[:, i]) for i in range(2)], axis=1)
    plot(img, dense, lo, res, color)
