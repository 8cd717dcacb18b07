"""Synthetic camera-array scenes with analytic disparity (a copy of
``cl_multiview_stereo_tpu/testing/synthetic.py``, numpy only, kept here so
that the port imports nothing of the JAX package).

The reference's camera model is an implicit rectified regular grid: a point
with disparity d seen at (x, y) in view (cx, cy) appears at
``(x - d*(cx'-cx), y - bl_ratio*d*(cy'-cy))`` in view (cx', cy')
(clcode.cl:1033-1034).  These generators render textured scenes under
exactly that model so tests have ground truth.
"""

from __future__ import annotations

import numpy as np


def texture(h: int, w: int, seed: int = 0, scale: int = 4) -> np.ndarray:
    """Smooth-ish random RGB texture (uint8) with enough local variation for
    block matching."""
    rng = np.random.default_rng(seed)
    small = rng.uniform(0, 255, size=(h // scale + 2, w // scale + 2, 3))
    # Bilinear upsample for spatial coherence.
    ys = np.linspace(0, small.shape[0] - 1.001, h)
    xs = np.linspace(0, small.shape[1] - 1.001, w)
    y0 = ys.astype(int)
    x0 = xs.astype(int)
    fy = (ys - y0)[:, None, None]
    fx = (xs - x0)[None, :, None]
    up = (
        small[y0][:, x0] * (1 - fy) * (1 - fx)
        + small[y0 + 1][:, x0] * fy * (1 - fx)
        + small[y0][:, x0 + 1] * (1 - fy) * fx
        + small[y0 + 1][:, x0 + 1] * fy * fx
    )
    noise = rng.uniform(-12, 12, size=(h, w, 3))
    return np.clip(up + noise, 0, 255).astype(np.uint8)


def fronto_parallel_scene(
    h: int,
    w: int,
    array_width: int = 3,
    array_height: int = 3,
    disp: float = 40.0,
    bl_ratio: float = 1.0359,
    seed: int = 0,
) -> tuple[np.ndarray, float]:
    """A single fronto-parallel textured plane at constant disparity.

    Renders view (cx, cy) by sampling the canonical texture at
    ``(x + d*cx, y + bl_ratio*d*cy)`` so that the reference's projection
    identity holds exactly between any two views (up to the integer
    rounding the pipeline itself applies).

    Returns ((V, H, W, 3) uint8 views, disparity).
    """
    v = array_width * array_height
    pad_x = int(np.ceil(disp * (array_width - 1))) + 2
    pad_y = int(np.ceil(bl_ratio * disp * (array_height - 1))) + 2
    canvas = texture(h + pad_y, w + pad_x, seed=seed)
    views = np.zeros((v, h, w, 3), dtype=np.uint8)
    yy = np.arange(h)
    xx = np.arange(w)
    for z in range(v):
        cx, cy = z % array_width, z // array_width
        sx = np.round(xx + disp * cx).astype(int)
        sy = np.round(yy + bl_ratio * disp * cy).astype(int)
        views[z] = canvas[np.clip(sy, 0, canvas.shape[0] - 1)][
            :, np.clip(sx, 0, canvas.shape[1] - 1)
        ]
    return views, disp


def two_plane_scene(
    h: int,
    w: int,
    array_width: int = 3,
    array_height: int = 3,
    disp_bg: float = 32.0,
    disp_fg: float = 52.0,
    bl_ratio: float = 1.0359,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Background plane + a foreground rectangle at higher disparity.

    Returns ((V, H, W, 3) uint8 views, (H, W) float32 reference-view (view 0)
    disparity map).
    """
    v = array_width * array_height
    pad_x = int(np.ceil(max(disp_bg, disp_fg) * (array_width - 1))) + 2
    pad_y = int(np.ceil(bl_ratio * max(disp_bg, disp_fg) * (array_height - 1))) + 2
    bg = texture(h + pad_y, w + pad_x, seed=seed)
    fg = texture(h + pad_y, w + pad_x, seed=seed + 1)

    # Foreground rectangle in view-0 coordinates.
    fy0, fy1 = h // 4, 3 * h // 4
    fx0, fx1 = w // 3, 5 * w // 6

    views = np.zeros((v, h, w, 3), dtype=np.uint8)
    gt = np.full((h, w), disp_bg, dtype=np.float32)
    gt[fy0:fy1, fx0:fx1] = disp_fg
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    for z in range(v):
        cx, cy = z % array_width, z // array_width
        # background sample
        bx = np.clip(np.round(xx + disp_bg * cx).astype(int), 0, bg.shape[1] - 1)
        by = np.clip(np.round(yy + bl_ratio * disp_bg * cy).astype(int), 0, bg.shape[0] - 1)
        img = bg[by, bx]
        # foreground: its support shifts with the view
        fxs = np.clip(np.round(xx + disp_fg * cx).astype(int), 0, fg.shape[1] - 1)
        fys = np.clip(np.round(yy + bl_ratio * disp_fg * cy).astype(int), 0, fg.shape[0] - 1)
        # The rectangle occupies fixed *world* texture coords; a pixel shows
        # foreground when its fg-plane sample falls inside the rectangle's
        # texture footprint (defined in view-0 sample space).
        in_rect = (
            (fys >= fy0) & (fys < fy1) & (fxs >= fx0 + int(disp_fg * 0)) & (fxs < fx1)
        )
        img = np.where(in_rect[..., None], fg[fys, fxs], img)
        views[z] = img
    return views, gt
