"""Fusion (port of ``cl_multiview_stereo_tpu/ops/fusion.py``).

* ``spixl_to_image`` (``clcode.cl:1906-1931``): each pixel takes the
  refined plane of the superpixel that owns it.  The owner is read with a
  direct label gather; the JAX module's ``select_cell_lookup`` avoids that
  gather on the TPU and is bitwise equal to it.  On a card
  :func:`rasterize_planes` launches ``csrc/raster.cu`` (``ops/raster``).
* ``project_to_reference_inv`` (cl:1995-2034): occlusion-aware inverse warp,
  the largest disparity over the other views, probed with the evolving
  maximum in view-index order.
* ``remove_view_inconsistency`` (cl:2037-2101): the stability vote; the
  largest stable candidate disparity wins.

On a card the warp and the vote launch ``csrc/crosscheck.cu``
(``ops/crosscheck``); their plain forms are the ``*_reference`` functions.

``cross_check=False`` reproduces what the shipping reference produces;
``True`` adds the intended warp + vote, as in the JAX module.
"""

from __future__ import annotations

import numpy as np
import torch


def cl_round(x: torch.Tensor) -> torch.Tensor:
    """OpenCL round(): half away from zero (torch.round rounds half to even)."""
    return torch.where(x >= 0, torch.floor(x + 0.5), torch.ceil(x - 0.5))


def gather_cells(labels: torch.Tensor, fields: torch.Tensor) -> torch.Tensor:
    """Per-pixel copy of the owning superpixel's fields.

    ``labels`` (V, H, W) int per-view ``row * Mw + col``; ``fields``
    (V, Mh, Mw, C).  Returns (V, H, W, C)."""
    v, h, w = labels.shape
    c = fields.shape[-1]
    idx = labels.reshape(v, h * w, 1).to(torch.int64).expand(v, h * w, c)
    return torch.gather(fields.reshape(v, -1, c), 1, idx).reshape(v, h, w, c)


def plane_disparity(g: torch.Tensor, row0: int = 0) -> torch.Tensor:
    """``d(p) = (n . (c - p) + nz * d) / nz`` (cl:1928) from per-pixel
    ``g = [cx, cy, d, nx, ny, nz]`` (V, H, W, 6) whose first row is the
    image's row ``row0``."""
    h, w = g.shape[1:3]
    px = torch.arange(w, dtype=torch.float32, device=g.device)[None, None, :]
    py = torch.arange(row0, row0 + h, dtype=torch.float32, device=g.device)[None, :, None]
    return (
        g[..., 3] * (g[..., 0] - px) + g[..., 4] * (g[..., 1] - py) + g[..., 5] * g[..., 2]
    ) / g[..., 5]


def rasterize_planes_reference(
    labels: torch.Tensor,  # (V, H, W) int32
    centers: torch.Tensor,  # (V, Mh, Mw, 2)
    state_d: torch.Tensor,  # (V, Mh, Mw)
    state_n: torch.Tensor,  # (V, Mh, Mw, 3)
) -> torch.Tensor:
    """Per-pixel disparity (V, H, W) from the owning superpixel's plane:
    the plain form of ``ops/raster.planes``, on any device."""
    pack = torch.cat([centers, state_d[..., None], state_n], dim=-1)
    return plane_disparity(gather_cells(labels, pack))


def rasterize_planes(labels, centers, state_d, state_n) -> torch.Tensor:
    """Per-pixel disparity (V, H, W) from the owning superpixel's plane:
    one launch of ``csrc/raster.cu`` on a card, the plain form on the CPU
    (``ops/raster.planes``)."""
    from cl_multiview_stereo_tpu_torch.ops import raster

    return raster.planes(labels, centers, state_d, state_n)


def _probe(
    img: torch.Tensor, xf: torch.Tensor, yf: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Read ``img`` (H, W) at integer-valued float coordinates: (values,
    in-image mask).  JAX casts the coordinates to int32 first, which on XLA
    maps NaN to 0 and saturates +-inf; NaN becomes 0 here and the bounds
    test is made on the float, so no undefined cast is reached and the
    CPU and the card agree."""
    h, w = img.shape
    xf = torch.where(torch.isnan(xf), 0.0, xf)
    yf = torch.where(torch.isnan(yf), 0.0, yf)
    inb = (xf >= 0) & (yf >= 0) & (xf < w) & (yf < h)
    idx = yf.clamp(0, h - 1).to(torch.int64) * w + xf.clamp(0, w - 1).to(torch.int64)
    return img.reshape(-1)[idx], inb


def _f32(x: float) -> float:
    """A Python float rounded to float32, as JAX rounds a weak-typed scalar."""
    return float(np.float32(x))


def view_bounds(view_range: tuple[int, int] | None, v: int) -> tuple[int, int]:
    """(first view, count) of a ``view_range`` over ``v`` views (all of them
    for ``None``): the reference views a per-view step computes."""
    v0, nv = (0, v) if view_range is None else (int(x) for x in view_range)
    if not (0 <= v0 and 0 <= nv and v0 + nv <= v):
        raise ValueError(f"view range ({v0}, {nv}) outside the {v} views")
    return v0, nv


def project_to_reference_inv_reference(
    disp_full: torch.Tensor,  # (V, H, W)
    array_width: int,
    bl_ratio: float,
    view_range: tuple[int, int] | None = None,
) -> torch.Tensor:
    """Plain form of :func:`project_to_reference_inv`, on any device."""
    v, h, w = disp_full.shape
    v0, nv = view_bounds(view_range, v)
    dev = disp_full.device
    bl = _f32(bl_ratio)
    px = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    py = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
    ref = torch.arange(v0, v0 + nv, device=dev)[:, None, None]
    min_disp = disp_full[v0:v0 + nv]
    for i in range(v):
        dx = (ref % array_width - i % array_width).to(torch.float32)
        dy = (ref // array_width - i // array_width).to(torch.float32)
        xp = px - cl_round(min_disp * dx)
        yp = py - cl_round((bl * min_disp) * dy)
        probe, inb = _probe(disp_full[i], xp, yp)
        better = inb & (min_disp < probe) & (ref != i)
        min_disp = torch.where(better, probe, min_disp)
    return min_disp


def vote_stabilities(
    disp_proj: torch.Tensor,  # (V, H, W) warped-to-reference maps
    disp_full: torch.Tensor,  # (V, H, W) unwarped per-view maps
    array_width: int,
    bl_ratio: float,
    fuse: float,
    view_range: tuple[int, int] | None = None,
):
    """The vote's candidates in view order: for each view i, (its candidate
    ``disp_proj[i]`` broadcast to (nv, H, W), vote 1's stability (H, W),
    an iterator of vote 2's terms, one (nv, H, W) tensor a view j, made as
    it is read), as the plain vote computes them; the stability is vote
    1's plus vote 2's terms in view order.  Read each candidate's terms
    before the next candidate."""
    v, h, w = disp_proj.shape
    v0, nv = view_bounds(view_range, v)
    dev = disp_proj.device
    bl = _f32(bl_ratio)
    fuse = _f32(fuse)
    px = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    py = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
    ref = torch.arange(v0, v0 + nv, device=dev)[:, None, None]
    cam_ref_x = (ref % array_width).to(torch.float32)
    cam_ref_y = (ref // array_width).to(torch.float32)
    for i in range(v):
        d = disp_proj[i]  # candidate from view i, the same for every ref
        # vote 1: agreement among the warped maps at the same pixel (the
        # votes are small integers, so their order of addition is exact)
        stab1 = torch.zeros((h, w), dtype=torch.float32, device=dev)
        for j in range(v):
            d_check = disp_proj[j]
            vote = torch.where(torch.abs(d_check - d) > fuse, -1.0, 1.0)
            stab1 = stab1 + torch.where(d_check != 0, vote, 0.0)
        d = d.expand(nv, h, w)

        def lookups(d=d):
            # vote 2: cross-view lookups in the unwarped maps
            for j in range(v):
                xj = px - cl_round(d * (float(j % array_width) - cam_ref_x))
                yj = py - cl_round((bl * d) * (float(j // array_width) - cam_ref_y))
                d_check, inb = _probe(disp_full[j], xj, yj)
                diff = torch.abs(d_check - d)
                vote = torch.where(diff > fuse, -1.0, 0.0) + torch.where(diff < fuse, 1.0, 0.0)
                yield torch.where(inb, vote, 0.0)
        yield d, stab1, lookups()


def remove_view_inconsistency_reference(
    disp_proj: torch.Tensor,
    disp_full: torch.Tensor,
    array_width: int,
    bl_ratio: float,
    fuse: float,
    view_range: tuple[int, int] | None = None,
) -> torch.Tensor:
    """Plain form of :func:`remove_view_inconsistency`, on any device."""
    v, h, w = disp_proj.shape
    nv = view_bounds(view_range, v)[1]
    d_est = torch.zeros((nv, h, w), dtype=torch.float32, device=disp_proj.device)
    for d, stab1, votes in vote_stabilities(disp_proj, disp_full, array_width, bl_ratio, fuse, view_range):
        stability = stab1.expand(nv, h, w)
        for vote in votes:
            stability = stability + vote
        take = (d != 0) & (stability >= 0) & ((d_est == 0) | (d_est < d))
        d_est = torch.where(take, d, d_est)
    return d_est


def project_to_reference_inv(
    disp_full: torch.Tensor,  # (V, H, W)
    array_width: int,
    bl_ratio: float,
    view_range: tuple[int, int] | None = None,
) -> torch.Tensor:
    """Occlusion-aware inverse warp for every reference view at once
    (cl:1995-2034): the probe chain runs over the source views in index
    order and shifts by the evolving maximum.  ``view_range`` (v0, nv):
    warp only those reference views, (nv, H, W) (default: all V).  One
    launch of ``fuse_warp`` on a card, the plain form on the CPU
    (``ops/crosscheck.warp``)."""
    from cl_multiview_stereo_tpu_torch.ops import crosscheck

    return crosscheck.warp(disp_full, array_width, bl_ratio, view_range)


def remove_view_inconsistency(
    disp_proj: torch.Tensor,  # (V, H, W) warped-to-reference maps
    disp_full: torch.Tensor,  # (V, H, W) unwarped per-view maps
    array_width: int,
    bl_ratio: float,
    fuse: float,
    view_range: tuple[int, int] | None = None,
) -> torch.Tensor:
    """Stability vote (cl:2037-2101) for every reference view.  Warped maps
    vote ``> fuse -> -1`` / ``<= fuse -> +1``; cross-view lookups vote
    ``> fuse -> -1`` / ``< fuse -> +1`` and abstain on equality.  Candidates
    run in view order; the winner is the largest d with stability >= 0.
    ``view_range`` (v0, nv): vote only for those reference views, (nv, H,
    W); both inputs still hold all V views.  One launch of ``fuse_vote`` on
    a card, the plain form on the CPU (``ops/crosscheck.vote``)."""
    from cl_multiview_stereo_tpu_torch.ops import crosscheck

    return crosscheck.vote(disp_proj, disp_full, array_width, bl_ratio, fuse, view_range)


def fuse_views(
    labels,
    centers,
    state_d,
    state_n,
    *,
    array_width: int | None = None,
    bl_ratio: float | None = None,
    fuse: float | None = None,
    cross_check: bool = False,
) -> torch.Tensor:
    """Fusion stage: plane rasterization, then, with ``cross_check=True``,
    the warp + stability vote, which needs ``array_width``, ``bl_ratio``
    and ``fuse``."""
    disp_full = rasterize_planes(labels, centers, state_d, state_n)
    if not cross_check:
        return disp_full
    if array_width is None or bl_ratio is None or fuse is None:
        raise ValueError("cross_check=True needs array_width, bl_ratio and fuse")
    disp_proj = project_to_reference_inv(disp_full, array_width, bl_ratio)
    return remove_view_inconsistency(disp_proj, disp_full, array_width, bl_ratio, fuse)
