"""Seeded captures of a camera rig, rendered on the device in plain torch.

The rig model is the reference's rectified grid: a point at disparity d
seen at (x, y) in view (cx, cy) of the grid lies at canonical texture
coordinates (x + d·cx, y + bl·d·cy), so between two views it shifts by
(d·Δcol, bl·d·Δrow).  A scene is a slanted background plane and a few
fronto-parallel foreground rectangles in front of it, each with its own
texture, painted far to near so that the nearer occludes
(after ``testing/synthetic.two_plane_scene`` of the port and the JAX
package).  Everything is drawn from one ``torch.Generator`` on the device
in a few large calls, so the same seed gives the same bytes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _texture(gen: torch.Generator, h: int, w: int, scale: int, noise: float, device) -> torch.Tensor:
    """(h, w, 3) float texture in [0, 255]: uniform noise on a grid of
    ``scale`` pixels, bilinearly upsampled, plus ±``noise`` per pixel."""
    small = torch.rand((1, 3, h // scale + 2, w // scale + 2), generator=gen, device=device) * 255.0
    up = F.interpolate(small, size=(h, w), mode="bilinear", align_corners=True)[0].permute(1, 2, 0)
    jitter = (torch.rand((h, w, 3), generator=gen, device=device) * 2.0 - 1.0) * noise
    return (up + jitter).clamp(0.0, 255.0)


def _sample(tex: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    """``tex`` at the rounded, clamped coordinates ``xs``, ``ys``."""
    hc, wc = tex.shape[:2]
    xi = torch.round(xs).to(torch.int64).clamp(0, wc - 1)
    yi = torch.round(ys).to(torch.int64).clamp(0, hc - 1)
    return tex[yi, xi]


def layout(seed: int, index: int, h: int, w: int, scene: dict, lo: float, hi: float) -> dict:
    """The geometry of scene ``index`` of seed ``seed``: the background
    plane d = a + bx·(x - W/2) + by·(y - H/2) in canonical coordinates, and
    the rectangles (x0, y0, x1, y1, d), far to near.  Scene ``index`` has
    ``rects_min + index % (rects_max - rects_min + 1)`` rectangles, so every
    seed's pool holds the same counts."""
    gen = torch.Generator(device="cpu").manual_seed((seed * 1_000_003 + index) % 2**63)
    u = lambda *shape: torch.rand(shape, generator=gen, dtype=torch.float64)  # noqa: E731
    span = hi - lo
    slope = scene["bg_slope"] * span
    a = lo + u(1).item() * 0.2 * span + 0.5 * slope
    bx, by = ((u(2) * 2.0 - 1.0) * 0.5 * slope / torch.tensor([w, h], dtype=torch.float64)).tolist()
    n = scene["rects_min"] + index % (scene["rects_max"] - scene["rects_min"] + 1)
    fmin, fmax = scene["rect_frac"]
    sizes = fmin + u(n, 2) * (fmax - fmin)
    corners = u(n, 2) * (1.0 - sizes)
    disps = lo + (scene["fg_from"] + u(n) * (1.0 - scene["fg_from"])) * span
    rects = sorted(
        ((float(corners[k, 0] * w), float(corners[k, 1] * h), float((corners[k, 0] + sizes[k, 0]) * w),
          float((corners[k, 1] + sizes[k, 1]) * h), float(disps[k])) for k in range(n)),
        key=lambda r: r[4],
    )
    return {"a": a, "bx": bx, "by": by, "rects": rects}


def render(seed: int, index: int, rig: tuple[int, int], h: int, w: int, bl_ratio: float, scene: dict,
           lo: float, hi: float, device) -> torch.Tensor:
    """Capture ``index`` of seed ``seed`` for a ``rig`` = (columns, rows)
    grid: (V, H, W, 3) uint8 on ``device``, every disparity in [lo, hi]."""
    aw, ah = rig
    geo = layout(seed, index, h, w, scene, lo, hi)
    gen = torch.Generator(device=device).manual_seed((seed * 1_000_003 + index) % 2**63)
    pad_x = int(hi * (aw - 1)) + 2
    pad_y = int(bl_ratio * hi * (ah - 1)) + 2
    hc, wc = h + pad_y, w + pad_x
    scale, noise = scene["texture_scale"], scene["noise"]
    bg = _texture(gen, hc, wc, scale, noise, device)
    fg = [_texture(gen, hc, wc, scale, noise, device) for _ in geo["rects"]]
    yy = torch.arange(h, dtype=torch.float32, device=device)[:, None].expand(h, w)
    xx = torch.arange(w, dtype=torch.float32, device=device)[None, :].expand(h, w)
    views = []
    for z in range(aw * ah):
        cx, cy = float(z % aw), float(z // aw)
        # the background point seen at (x, y): d = a + bx (x + d cx - W/2) + by (y + bl d cy - H/2)
        d = (geo["a"] + geo["bx"] * (xx - w / 2) + geo["by"] * (yy - h / 2)) / (
            1.0 - geo["bx"] * cx - geo["by"] * bl_ratio * cy)
        img = _sample(bg, xx + d * cx, yy + bl_ratio * d * cy)
        for tex, (x0, y0, x1, y1, dk) in zip(fg, geo["rects"]):
            xs, ys = xx + dk * cx, yy + bl_ratio * dk * cy
            inside = ((xs >= x0) & (xs < x1) & (ys >= y0) & (ys < y1))[..., None]
            img = torch.where(inside, _sample(tex, xs, ys), img)
        views.append(img)
    return torch.stack(views).round().to(torch.uint8)
