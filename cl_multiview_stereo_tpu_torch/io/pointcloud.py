"""Fused point-cloud export (a copy of
``cl_multiview_stereo_tpu/io/pointcloud.py``, numpy only, kept here so that
the port imports nothing of the JAX package).

The reference stops at per-view disparity PNGs (``results/8- Fusion``,
written by ``plot_full_image``, depth_refinement.cpp:1466-1495); a point
cloud is the natural final artifact of an MVS pipeline and SURVEY.md
section 7.2 step 6 adds it.  The reference's camera model is an implicit
rectified regular grid — projection is a pure disparity shift scaled by
``bl_ratio`` (clcode.cl:1033-1034) with no metric calibration — so the
export lives in that model's natural coordinates: world
``X = x - d*cam_x``, ``Y = y - bl_ratio*d*cam_y``, ``Z = f*B/d`` with unit
focal-times-baseline (inverse-disparity depth), colored from the source
image.  Output is standard binary little-endian PLY.
"""

from __future__ import annotations

import struct

import numpy as np


def disparity_to_points(
    disp: np.ndarray,  # (V, H, W) fused per-view disparity
    rgb: np.ndarray,  # (V, H, W, 3) uint8
    array_width: int,
    bl_ratio: float,
    *,
    min_disp: float = 1e-3,
    stride: int = 1,
) -> tuple[np.ndarray, np.ndarray]:
    """Back-project every valid pixel of every view into the common grid
    frame.  Pixels with ``disp <= min_disp`` (the fusion vote's rejected
    zeros) are dropped.

    Returns (points (N, 3) float32, colors (N, 3) uint8).
    """
    disp = np.asarray(disp)
    rgb = np.asarray(rgb)
    v, h, w = disp.shape
    xs = np.arange(0, w, stride, dtype=np.float32)
    ys = np.arange(0, h, stride, dtype=np.float32)
    gx, gy = np.meshgrid(xs, ys, indexing="xy")
    pts, cols = [], []
    for z in range(v):
        cam_x = float(z % array_width)
        cam_y = float(z // array_width)
        d = disp[z, ::stride, ::stride]
        keep = d > min_disp
        if not keep.any():
            continue
        dk = d[keep]
        # shift the view's pixels to view 0's frame: a pixel at (x, y) with
        # disparity d in view (cam_x, cam_y) sees the same surface point as
        # (x - d*dcam_x, y - bl*d*dcam_y) in the neighbor (clcode.cl:1033)
        px = gx[keep] - dk * cam_x
        py = gy[keep] - bl_ratio * dk * cam_y
        pz = 1.0 / dk
        pts.append(np.stack([px, py, pz], axis=-1))
        cols.append(rgb[z, ::stride, ::stride][keep])
    if not pts:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.uint8)
    return (
        np.concatenate(pts).astype(np.float32),
        np.concatenate(cols).astype(np.uint8),
    )


def save_ply(path: str, points: np.ndarray, colors: np.ndarray | None = None) -> None:
    """Write a binary little-endian PLY file."""
    points = np.asarray(points, np.float32)
    n = points.shape[0]
    has_color = colors is not None
    if has_color:
        colors = np.asarray(colors, np.uint8)
        assert colors.shape == (n, 3)
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    header += [f"property float {a}" for a in "xyz"]
    if has_color:
        header += [f"property uchar {c}" for c in ("red", "green", "blue")]
    header += ["end_header", ""]
    with open(path, "wb") as f:
        f.write("\n".join(header).encode("ascii"))
        if has_color:
            rec = np.zeros(
                n,
                dtype=[("xyz", np.float32, 3), ("rgb", np.uint8, 3)],
            )
            rec["xyz"] = points
            rec["rgb"] = colors
            f.write(rec.tobytes())
        else:
            f.write(points.tobytes())


def load_ply(path: str) -> tuple[np.ndarray, np.ndarray | None]:
    """Minimal reader for the files ``save_ply`` writes (round-trip tests)."""
    with open(path, "rb") as f:
        data = f.read()
    head_end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:head_end].decode("ascii").splitlines()
    n = int(next(l.split()[-1] for l in header if l.startswith("element vertex")))
    has_color = any("uchar" in l for l in header)
    if has_color:
        rec = np.frombuffer(
            data[head_end:],
            dtype=[("xyz", np.float32, 3), ("rgb", np.uint8, 3)],
            count=n,
        )
        return rec["xyz"].copy(), rec["rgb"].copy()
    pts = np.frombuffer(data[head_end:], dtype=np.float32, count=n * 3)
    return pts.reshape(n, 3).copy(), None
