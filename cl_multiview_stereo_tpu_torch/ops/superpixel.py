"""Superpixel extent (port of ``cl_multiview_stereo_tpu/ops/superpixel.py``).

The extent is the 8-ray walk of ``find_super_pixel_boundary``
(``clcode.cl:791-855``): from each clamped centre, walk the 8 compass rays
up to ``spixl_size - 1`` steps and keep ``i - 1`` for the last radius ``i``
whose pixel still carries the superpixel's label.  The JAX module's
windowed form exists only to avoid narrow TPU gathers and is bitwise equal
to this walk.
"""

from __future__ import annotations

import torch

from cl_multiview_stereo_tpu.config import DerivedGeometry

# Compass slot order nw, w, sw, n, s, ne, e, se as (dx, dy) (clcode.cl:826-851).
_DIRS = ((-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0), (1, 1))


def clamp_center(cx: torch.Tensor, cy: torch.Tensor, w: int, h: int, s: int):
    """Centre clamp of clcode.cl:809-819 (keeps the walk in the view)."""
    cx = torch.where(cx < s, s, cx)
    cx = torch.where(cx + s > w, cx - s, cx)
    cy = torch.where(cy < s, s, cy)
    cy = torch.where(cy + s > h, cy - s, cy)
    return cx, cy


def superpixel_extent(
    labels: torch.Tensor, centers: torch.Tensor, geom: DerivedGeometry
) -> torch.Tensor:
    """``labels`` (V, H, W) int32, ``centers`` (V, Mh, Mw, 2) float32 (x, y).
    Returns (V, Mh, Mw, 8) int32."""
    v, h, w = labels.shape
    s = geom.spixl_size
    mw, mh = geom.map_w, geom.map_h
    dev = labels.device

    # .to(int) truncates toward zero, as the C cast does
    cx = centers[..., 0].to(torch.int64)
    cy = centers[..., 1].to(torch.int64)
    cx, cy = clamp_center(cx, cy, w, h, s)

    own_id = torch.arange(mh * mw, dtype=torch.int32, device=dev).reshape(1, mh, mw)
    flat = labels.reshape(v, h * w)
    ext = torch.zeros((v, mh, mw, 8), dtype=torch.int32, device=dev)
    for i in range(1, s):
        for k, (dx, dy) in enumerate(_DIRS):
            px = cx + i * dx
            py = cy + i * dy
            inb = (px >= 0) & (py >= 0) & (px < w) & (py < h)
            idx = (py.clamp(0, h - 1) * w + px.clamp(0, w - 1)).reshape(v, -1)
            lab_at = torch.gather(flat, 1, idx).reshape(v, mh, mw)
            match = inb & (lab_at == own_id)
            ext[..., k] = torch.where(match, i - 1, ext[..., k])
    return ext


def extent_step(ext: torch.Tensor) -> torch.Tensor:
    """Adaptive sample pitch from the extent bounding box (clcode.cl:997-1007):
    ``max(1, 0.25 * (near + far))`` per axis.  ``ext`` (..., 8) int32 ->
    (..., 2) float32 (step_x, step_y)."""
    e = ext.to(torch.float32)
    bb_l = torch.maximum(e[..., 0], torch.maximum(e[..., 1], e[..., 2]))
    bb_r = torch.maximum(e[..., 5], torch.maximum(e[..., 6], e[..., 7]))
    bb_t = torch.maximum(e[..., 0], torch.maximum(e[..., 3], e[..., 5]))
    bb_b = torch.maximum(e[..., 2], torch.maximum(e[..., 4], e[..., 7]))
    sx = torch.clamp(0.25 * (bb_l + bb_r), min=1.0)
    sy = torch.clamp(0.25 * (bb_t + bb_b), min=1.0)
    return torch.stack([sx, sy], dim=-1)


def consistency_samples(ext: torch.Tensor) -> torch.Tensor:
    """9-point sample offsets of the consistency terms (clcode.cl:1271-1305):
    grid position (i, j), i outer, reads extent slot radius r and sits at
    ``centre + (r*i, r*j)``.  Returns (..., 9, 2) int32."""
    zeros = torch.zeros_like(ext[..., 0])
    radii = torch.stack(
        [ext[..., 0], ext[..., 1], ext[..., 2], ext[..., 3], zeros,
         ext[..., 4], ext[..., 5], ext[..., 6], ext[..., 7]],
        dim=-1,
    )
    ii = torch.tensor([-1, -1, -1, 0, 0, 0, 1, 1, 1], dtype=torch.int32, device=ext.device)
    jj = torch.tensor([-1, 0, 1, -1, 0, 1, -1, 0, 1], dtype=torch.int32, device=ext.device)
    return torch.stack([radii * ii, radii * jj], dim=-1)
