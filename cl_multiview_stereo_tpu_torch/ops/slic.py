"""SLIC superpixel segmentation (port of ``cl_multiview_stereo_tpu/ops/slic.py``).

Same sequence and quirks as the JAX module (``clcode.cl:259-773``):

* the candidate-window parity swap: the column-derived half-cell parity
  offsets the candidate's cluster *row* and vice versa (``clcode.cl:461-479``);
* candidates are scanned in the reference's loop order and a strict ``<``
  keeps the first minimum;
* the update counts only members inside the cluster's 3S x 3S window and
  zeroes clusters that lost every member.

The candidate clusters are read with a direct gather instead of the JAX
module's upsampled cell maps, which existed only to avoid TPU gathers.  The
cluster sums are dense block sums over the nine window classes in a fixed
order: no ``index_add_``/``scatter_add_``, whose float atomics on CUDA would
make the centres, and so the next labels, vary from run to run.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from cl_multiview_stereo_tpu.config import DerivedGeometry, SlicParams


class SuperpixelMap(NamedTuple):
    """Per-superpixel state, all leading ``(V, Mh, Mw)``."""

    center: torch.Tensor  # (V, Mh, Mw, 2) float32, (x, y)
    color: torch.Tensor  # (V, Mh, Mw, 3) float32 Lab
    count: torch.Tensor  # (V, Mh, Mw) float32
    disp: torch.Tensor  # (V, Mh, Mw) float32


def init_cluster_centers(lab: torch.Tensor, geom: DerivedGeometry) -> SuperpixelMap:
    """Seed centres on the regular grid (clcode.cl:259-294); ``lab`` (V, H, W, 3)."""
    v, h, w = lab.shape[:3]
    s = geom.spixl_size
    dev = lab.device
    col = torch.arange(geom.map_w, dtype=torch.int64, device=dev)
    row = torch.arange(geom.map_h, dtype=torch.int64, device=dev)
    cx = col * s + s // 2
    cy = row * s + s // 2
    # border pull-in with the reference's `>` comparison (clcode.cl:273-277)
    cx = torch.where(cx > w, (col * s + w) // 2, cx)
    cy = torch.where(cy > h, (row * s + h) // 2, cy)
    cyg, cxg = torch.meshgrid(cy, cx, indexing="ij")  # (Mh, Mw)
    center = torch.stack([cxg, cyg], dim=-1).to(torch.float32)
    color = lab[:, cyg.clamp(0, h - 1), cxg.clamp(0, w - 1), :]
    center = center[None].expand(v, geom.map_h, geom.map_w, 2).contiguous()
    zeros = torch.zeros((v, geom.map_h, geom.map_w), dtype=torch.float32, device=dev)
    return SuperpixelMap(center=center, color=color, count=zeros, disp=zeros.clone())


def find_center_association(
    lab: torch.Tensor, spmap: SuperpixelMap, geom: DerivedGeometry, p: SlicParams
) -> torch.Tensor:
    """Assignment step (clcode.cl:447-520): each pixel takes the nearest of
    four candidate clusters.  Returns (V, H, W) int32 per-view labels
    ``row * Mw + col``."""
    v, h, w = lab.shape[:3]
    s = geom.spixl_size
    mw, mh = geom.map_w, geom.map_h
    dev = lab.device

    col = torch.arange(w, dtype=torch.int64, device=dev)[None, :]  # (1, W)
    row = torch.arange(h, dtype=torch.int64, device=dev)[:, None]  # (H, 1)
    cx = col // s
    cy = row // s
    dxp = ((col % s) + s // 2) // s  # half-cell parity from the column
    dyp = ((row % s) + s // 2) // s  # ... and from the row
    colf = col.to(torch.float32)
    rowf = row.to(torch.float32)

    packed = torch.cat([spmap.center, spmap.color], dim=-1).reshape(v, mh * mw, 5)
    mcd = float(p.max_color_dist)
    mxy = float(p.max_xy_dist)
    cw = float(p.color_weight)

    best = torch.full((v, h, w), float("inf"), dtype=torch.float32, device=dev)
    best_id = torch.full((v, h, w), -1, dtype=torch.int64, device=dev)
    # loop order of clcode.cl:475-479 with the parity swap: the column
    # parity moves the candidate row, the row parity the candidate column
    for i_off in (-1, 0):
        for j_off in (-1, 0):
            qy = cy + dxp + i_off  # (H, W)
            qx = cx + dyp + j_off
            ok = (qy >= 0) & (qy < mh) & (qx >= 0) & (qx < mw)
            cid = qy.clamp(0, mh - 1) * mw + qx.clamp(0, mw - 1)
            fld = packed[:, cid]  # (V, H, W, 5)
            color_d = (
                (lab[..., 0] - fld[..., 2]) ** 2
                + (lab[..., 1] - fld[..., 3]) ** 2
                + (lab[..., 2] - fld[..., 4]) ** 2
            )
            space_d = (colf - fld[..., 0]) ** 2 + (rowf - fld[..., 1]) ** 2
            dist = torch.sqrt(color_d * mcd + cw * space_d * mxy)
            dist = torch.where(ok, dist, float("inf"))
            take = dist < best
            best = torch.where(take, dist, best)
            best_id = torch.where(take, cid, best_id)
    return best_id.to(torch.int32)


def update_cluster_centers(
    lab: torch.Tensor, labels: torch.Tensor, spmap: SuperpixelMap, geom: DerivedGeometry
) -> SuperpixelMap:
    """Cluster statistics update (clcode.cl:533-773).

    A pixel inside its cluster's 3S x 3S window carries a label at most one
    cell from its home cell, so each of the nine (dy, dx) classes is a
    masked per-cell block sum shifted onto the cluster's cell.  Members
    outside the window fall in no class and are dropped, as on the device.
    """
    v, h, w = lab.shape[:3]
    s = geom.spixl_size
    mw, mh = geom.map_w, geom.map_h
    dev = lab.device

    col = torch.arange(w, dtype=torch.int64, device=dev)[None, None, :]
    row = torch.arange(h, dtype=torch.int64, device=dev)[None, :, None]
    lab_l = labels.to(torch.int64)
    rel_x = lab_l % mw - col // s  # (V, H, W)
    rel_y = lab_l // mw - row // s

    planes = torch.stack(
        [
            lab[..., 0],
            lab[..., 1],
            lab[..., 2],
            col.to(torch.float32).expand(v, h, w),
            row.to(torch.float32).expand(v, h, w),
            torch.ones((v, h, w), dtype=torch.float32, device=dev),
        ]
    )  # (6, V, H, W): Lab, x, y, count

    colm = torch.arange(mw, device=dev)[None, :]
    rowm = torch.arange(mh, device=dev)[:, None]
    sums = torch.zeros((6, v, mh, mw), dtype=torch.float32, device=dev)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            sel = (rel_x == dx) & (rel_y == dy)
            contrib = F.pad(
                torch.where(sel, planes, 0.0), (0, mw * s - w, 0, mh * s - h)
            )
            # rows of a cell first, then its columns: one fixed order
            rows_s = contrib.reshape(6, v, mh, s, mw * s).sum(dim=3)
            block = rows_s.reshape(6, v, mh, mw, s).sum(dim=4)
            # members with home cell (cy, cx) belong to cluster (cy+dy, cx+dx)
            shifted = torch.roll(block, shifts=(dy, dx), dims=(2, 3))
            okm = (colm - dx >= 0) & (colm - dx < mw) & (rowm - dy >= 0) & (rowm - dy < mh)
            sums = sums + torch.where(okm, shifted, 0.0)
    n = sums[5]
    nz = n > 0
    denom = torch.where(nz, n, 1.0)
    color = torch.where(nz[..., None], torch.stack(list(sums[0:3]), dim=-1) / denom[..., None], 0.0)
    center = torch.where(nz[..., None], torch.stack(list(sums[3:5]), dim=-1) / denom[..., None], 0.0)
    count = torch.where(nz, n, 0.0)
    return SuperpixelMap(center=center, color=color, count=count, disp=spmap.disp)


def segment(
    lab: torch.Tensor, geom: DerivedGeometry, p: SlicParams
) -> tuple[torch.Tensor, SuperpixelMap]:
    """Full SLIC sequence for all views (clSLIC.cpp:84-104).

    Returns (labels (V, H, W) int32, SuperpixelMap).
    """
    if p.edge_enable:
        raise NotImplementedError("SLIC edge_enable is not ported yet")
    if p.enforce_connectivity:
        raise NotImplementedError("SLIC enforce_connectivity is not ported yet")
    spmap = init_cluster_centers(lab, geom)
    labels = find_center_association(lab, spmap, geom, p)
    for _ in range(p.no_iter):
        spmap = update_cluster_centers(lab, labels, spmap, geom)
        labels = find_center_association(lab, spmap, geom, p)
    return labels, spmap
