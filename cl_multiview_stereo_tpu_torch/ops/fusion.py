"""Fusion (port of ``cl_multiview_stereo_tpu/ops/fusion.py``).

``spixl_to_image`` (``clcode.cl:1906-1931``): each pixel takes the refined
plane of the superpixel that owns it.  The owner is read with a direct
label gather; the JAX module's ``select_cell_lookup`` avoids that gather
on the TPU and is bitwise equal to it.  Only ``cross_check=False``, what
the shipping reference produces, is ported.
"""

from __future__ import annotations

import torch


def gather_cells(labels: torch.Tensor, fields: torch.Tensor) -> torch.Tensor:
    """Per-pixel copy of the owning superpixel's fields.

    ``labels`` (V, H, W) int per-view ``row * Mw + col``; ``fields``
    (V, Mh, Mw, C).  Returns (V, H, W, C)."""
    v, h, w = labels.shape
    c = fields.shape[-1]
    idx = labels.reshape(v, h * w, 1).to(torch.int64).expand(v, h * w, c)
    return torch.gather(fields.reshape(v, -1, c), 1, idx).reshape(v, h, w, c)


def plane_disparity(g: torch.Tensor) -> torch.Tensor:
    """``d(p) = (n . (c - p) + nz * d) / nz`` (cl:1928) from per-pixel
    ``g = [cx, cy, d, nx, ny, nz]`` (V, H, W, 6)."""
    h, w = g.shape[1:3]
    px = torch.arange(w, dtype=torch.float32, device=g.device)[None, None, :]
    py = torch.arange(h, dtype=torch.float32, device=g.device)[None, :, None]
    return (
        g[..., 3] * (g[..., 0] - px) + g[..., 4] * (g[..., 1] - py) + g[..., 5] * g[..., 2]
    ) / g[..., 5]


def rasterize_planes(
    labels: torch.Tensor,  # (V, H, W) int32
    centers: torch.Tensor,  # (V, Mh, Mw, 2)
    state_d: torch.Tensor,  # (V, Mh, Mw)
    state_n: torch.Tensor,  # (V, Mh, Mw, 3)
) -> torch.Tensor:
    """Per-pixel disparity (V, H, W) from the owning superpixel's plane."""
    pack = torch.cat([centers, state_d[..., None], state_n], dim=-1)
    return plane_disparity(gather_cells(labels, pack))


def fuse_views(
    labels, centers, state_d, state_n, *, cross_check: bool = False
) -> torch.Tensor:
    """Fusion stage: plane rasterization.  ``cross_check=True`` (the warp +
    stability vote) is not ported yet."""
    if cross_check:
        raise NotImplementedError("fusion cross_check=True is not ported yet")
    return rasterize_planes(labels, centers, state_d, state_n)
