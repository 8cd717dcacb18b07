"""SLIC superpixel segmentation (port of ``cl_multiview_stereo_tpu/ops/slic.py``).

Same sequence and quirks as the JAX module (``clcode.cl:259-773``):

* the candidate-window parity swap: the column-derived half-cell parity
  offsets the candidate's cluster *row* and vice versa (``clcode.cl:461-479``);
* candidates are scanned in the reference's loop order and a strict ``<``
  keeps the first minimum;
* the update counts only members inside the cluster's 3S x 3S window and
  zeroes clusters that lost every member;
* the optional edge snap of the seeds (``edge_enable``) and the twice
  applied connectivity vote (``enforce_connectivity``).

The assignment, the update, the vote and the edge snap route by the
device of their input (:func:`route`): on CUDA tensors each launches its
kernel of ``csrc/slic.cu`` (or raises), on CPU tensors it runs its plain
form, the ``*_reference`` function beside it (for the snap
``apply_edge_snap`` on ``compute_edges``); any other device raises.
Nothing falls back from one to the other.  The seeds stay plain PyTorch on
both devices.

In the plain forms the candidate clusters are read with a direct gather
instead of the JAX module's upsampled cell maps, which existed only to
avoid TPU gathers.  The cluster sums, there and in the kernel, are block
sums over the nine window classes in a fixed order: no
``index_add_``/``scatter_add_``, whose float atomics on CUDA would make the
centres, and so the next labels, vary from run to run.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from cl_multiview_stereo_tpu_torch.config import DerivedGeometry, SlicParams
from cl_multiview_stereo_tpu_torch.kernels import build

# Each kernel's launches since import (or since the caller reset them):
# chip_smoke.py reads them to show that the main path went through the
# kernels.  An update is one launch of its C entry (two kernels).
LAUNCHES = {"slic_assign": 0, "slic_update": 0, "slic_vote": 0, "edge_snap": 0}
# pointer and int arguments of each C entry, in order, before its floats
# and the stream (kernels/build.py's library "slic")
_ENTRIES = {
    "slic_assign": (4, 6, 3),
    "slic_update": (6, 6, 0),
    "slic_vote": (2, 3, 0),
    "edge_snap": (5, 4, 0),
}


class SuperpixelMap(NamedTuple):
    """Per-superpixel state, all leading ``(V, Mh, Mw)``."""

    center: torch.Tensor  # (V, Mh, Mw, 2) float32, (x, y)
    color: torch.Tensor  # (V, Mh, Mw, 3) float32 Lab
    count: torch.Tensor  # (V, Mh, Mw) float32
    disp: torch.Tensor  # (V, Mh, Mw) float32


def route(device) -> str:
    """Where a tensor on ``device`` is segmented: ``"plain"`` (the plain
    forms) on the CPU, ``"kernel"`` on a CUDA device; any other device
    raises."""
    kind = torch.device(device).type
    if kind == "cpu":
        return "plain"
    if kind == "cuda":
        return "kernel"
    raise ValueError(f"no SLIC kernel for device {device}")


@functools.cache
def _entry(name: str):
    """The C entry ``<name>_launch`` of ``csrc/slic.cu``, built at first use."""
    fn = getattr(build.load("slic"), f"{name}_launch")
    ptrs, ints, floats = _ENTRIES[name]
    fn.argtypes = [ctypes.c_void_p] * ptrs + [ctypes.c_int] * ints + [ctypes.c_float] * floats + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(name: str, dev: torch.device, *args) -> None:
    """Calls kernel ``name``'s entry with ``args`` and the current stream of
    ``dev``; raises on a CUDA error and counts the launch."""
    fn = _entry(name)
    with torch.cuda.device(dev):
        rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {rc}")
    LAUNCHES[name] += 1


def _check_lab(lab: torch.Tensor, geom: DerivedGeometry) -> None:
    """``lab`` (V, H, W, 3) contiguous float32, and cells that cover it."""
    if lab.ndim != 4:
        raise ValueError(f"lab has shape {tuple(lab.shape)}, expected (V, H, W, 3)")
    v, h, w = lab.shape[:3]
    s, mh, mw = geom.spixl_size, geom.map_h, geom.map_w
    if mh * s < h or mw * s < w:
        raise ValueError(f"a {mh}x{mw} map of {s}-pixel cells does not cover a {h}x{w} image")
    build.check_input("lab", lab, torch.float32, (v, h, w, 3), lab.device)


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


def find_center_association_reference(
    lab: torch.Tensor, spmap: SuperpixelMap, geom: DerivedGeometry, p: SlicParams
) -> torch.Tensor:
    """Plain form of :func:`find_center_association`."""
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


def find_center_association(
    lab: torch.Tensor, spmap: SuperpixelMap, geom: DerivedGeometry, p: SlicParams
) -> torch.Tensor:
    """Assignment step (clcode.cl:447-520): each pixel takes the nearest of
    four candidate clusters.  Returns (V, H, W) int32 per-view labels
    ``row * Mw + col``.  ``slic_assign`` on a CUDA ``lab`` (every input
    contiguous float32 on that device), the plain form on a CPU one."""
    if route(lab.device) == "plain":
        return find_center_association_reference(lab, spmap, geom, p)
    _check_lab(lab, geom)
    v, h, w = lab.shape[:3]
    for name, t, c in (("spmap.center", spmap.center, 2), ("spmap.color", spmap.color, 3)):
        build.check_input(name, t, torch.float32, (v, geom.map_h, geom.map_w, c), lab.device)
    labels = torch.empty((v, h, w), dtype=torch.int32, device=lab.device)
    _launch("slic_assign", lab.device, lab.data_ptr(), spmap.center.data_ptr(), spmap.color.data_ptr(),
            labels.data_ptr(), v, h, w, geom.spixl_size, geom.map_h, geom.map_w,
            float(p.max_color_dist), float(p.max_xy_dist), float(p.color_weight))
    return labels


def update_cluster_centers_reference(
    lab: torch.Tensor, labels: torch.Tensor, spmap: SuperpixelMap, geom: DerivedGeometry
) -> SuperpixelMap:
    """Plain form of :func:`update_cluster_centers`.

    A pixel inside its cluster's 3S x 3S window carries a label at most one
    cell from its home cell, so each of the nine (dy, dx) classes is a
    masked per-cell block sum shifted onto the cluster's cell.  Members
    outside the window fall in no class and are dropped, as on the device;
    so are labels outside [0, Mh*Mw), whose cell lies off the map.
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
            ).reshape(6, v, mh, s, mw, s)
            # a column's rows first, then the cell's columns, each ascending
            # and added one at a time: the order of csrc/slic.cu's sums and
            # of the JAX module's, which a reduction of torch's may not keep
            rows_s = torch.zeros_like(contrib[:, :, :, 0])
            for r in range(s):
                rows_s = rows_s + contrib[:, :, :, r]
            block = torch.zeros_like(rows_s[..., 0])
            for c in range(s):
                block = block + rows_s[..., c]
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


def update_cluster_centers(
    lab: torch.Tensor, labels: torch.Tensor, spmap: SuperpixelMap, geom: DerivedGeometry
) -> SuperpixelMap:
    """Cluster statistics update (clcode.cl:533-773): each cluster's mean
    Lab colour and centre over the pixels that carry its label within one
    cell of it (its 3S x 3S window), and their count; a cluster with no
    member is zeroed, ``disp`` passes through.  ``slic_update`` on a CUDA
    ``lab`` (int32 labels, every input contiguous on that device), the
    plain form on a CPU one."""
    if route(lab.device) == "plain":
        return update_cluster_centers_reference(lab, labels, spmap, geom)
    _check_lab(lab, geom)
    v, h, w = lab.shape[:3]
    dev, mh, mw = lab.device, geom.map_h, geom.map_w
    build.check_input("labels", labels, torch.int32, (v, h, w), dev)
    f32 = torch.float32
    partial = torch.empty((v, 9, 6, mh * mw), dtype=f32, device=dev)
    center = torch.empty((v, mh, mw, 2), dtype=f32, device=dev)
    color = torch.empty((v, mh, mw, 3), dtype=f32, device=dev)
    count = torch.empty((v, mh, mw), dtype=f32, device=dev)
    _launch("slic_update", dev, lab.data_ptr(), labels.data_ptr(), partial.data_ptr(), center.data_ptr(),
            color.data_ptr(), count.data_ptr(), v, h, w, geom.spixl_size, mh, mw)
    return SuperpixelMap(center=center, color=color, count=count, disp=spmap.disp)


def _shifted(a: torch.Tensor, dx: int, dy: int) -> torch.Tensor:
    """out[v, y, x] = a[v, clamp(y + dy), clamp(x + dx)]: border-replicate
    reads of a (V, H, W, ...) tensor."""
    h, w = a.shape[1:3]
    rows = (torch.arange(h, device=a.device) + dy).clamp(0, h - 1)
    cols = (torch.arange(w, device=a.device) + dx).clamp(0, w - 1)
    return a[:, rows][:, :, cols]


def compute_edges(lab: torch.Tensor) -> torch.Tensor:
    """Edge magnitude of the edge-snap path (``edge_compute_alternative``,
    clcode.cl:161-195, with the JAX module's two intended-semantics fixes:
    the classic skip-centre Sobel, and a separate edge image): 3x3 Sobel on
    Lab with border-replicate reads, ``sqrt(sum_ch(DX^2 + DY^2))``.

    The taps are added in the JAX module's order and the three channels
    one after another, so the order of every sum is fixed.  ``lab``
    (V, H, W, 3) -> (V, H, W) float32."""
    def at(dx: int, dy: int) -> torch.Tensor:
        return _shifted(lab, dx, dy)

    dxc = (
        -at(-1, -1) + at(1, -1) - 2.0 * at(-1, 0) + 2.0 * at(1, 0)
        - at(-1, 1) + at(1, 1)
    )
    dyc = (
        -at(-1, -1) - 2.0 * at(0, -1) - at(1, -1)
        + at(-1, 1) + 2.0 * at(0, 1) + at(1, 1)
    )
    sq = dxc * dxc + dyc * dyc
    return torch.sqrt(sq[..., 0] + sq[..., 1] + sq[..., 2])


# Ring scan order of ``apply_edge_alternative`` (clcode.cl:215), (dx, dy).
_EDGE_RING = ((-1, 0), (-1, -1), (0, -1), (1, -1), (1, 0), (1, 1), (0, 1), (-1, 1))


def apply_edge_snap(lab: torch.Tensor, edges: torch.Tensor, spmap: SuperpixelMap) -> SuperpixelMap:
    """Edge snap (``apply_edge_alternative``, clcode.cl:204-248): each
    centre moves to the lowest-edge pixel among its 8 neighbours (a running
    strict ``<`` in ring order, so the first minimum wins) and takes that
    pixel's Lab colour.  ``edges`` (V, H, W)."""
    v, h, w = edges.shape
    flat_e = edges.reshape(v, h * w)
    cx = spmap.center[..., 0].to(torch.int64)  # C truncation
    cy = spmap.center[..., 1].to(torch.int64)

    def read(x, y):
        idx = (y.clamp(0, h - 1) * w + x.clamp(0, w - 1)).reshape(v, -1)
        return torch.gather(flat_e, 1, idx).reshape(x.shape)

    best_edge = read(cx, cy)
    best_x, best_y = cx, cy
    changed = torch.zeros(cx.shape, dtype=torch.bool, device=cx.device)
    for dx, dy in _EDGE_RING:
        nx, ny = cx + dx, cy + dy
        inb = (nx >= 0) & (ny >= 0) & (nx < w) & (ny < h)
        ne = read(nx, ny)
        take = inb & (ne < best_edge)
        best_edge = torch.where(take, ne, best_edge)
        best_x = torch.where(take, nx, best_x)
        best_y = torch.where(take, ny, best_y)
        changed = changed | take
    vid = torch.arange(v, device=cx.device)[:, None, None]
    new_color = lab[vid, best_y.clamp(0, h - 1), best_x.clamp(0, w - 1)]
    center = torch.where(
        changed[..., None], torch.stack([best_x, best_y], dim=-1).to(torch.float32), spmap.center
    )
    color = torch.where(changed[..., None], new_color, spmap.color)
    return SuperpixelMap(center=center, color=color, count=spmap.count, disp=spmap.disp)


def edge_snap_reference(lab: torch.Tensor, spmap: SuperpixelMap) -> SuperpixelMap:
    """Plain form of :func:`edge_snap`: :func:`apply_edge_snap` on the
    whole image's :func:`compute_edges`."""
    return apply_edge_snap(lab, compute_edges(lab), spmap)


def edge_snap(lab: torch.Tensor, spmap: SuperpixelMap) -> SuperpixelMap:
    """The seeds' edge snap (clcode.cl:161-248): each centre moves to the
    lowest Sobel magnitude of ``lab`` (V, H, W, 3) among itself and its 8
    neighbours and takes that pixel's colour; count and disp pass through.
    ``edge_snap`` on a CUDA ``lab`` (the map's centre and colour contiguous
    float32 on that device), computing the magnitude at those 9 pixels
    only; the plain form on a CPU one."""
    if route(lab.device) == "plain":
        return edge_snap_reference(lab, spmap)
    if lab.ndim != 4:
        raise ValueError(f"lab has shape {tuple(lab.shape)}, expected (V, H, W, 3)")
    v, h, w = lab.shape[:3]
    build.check_input("lab", lab, torch.float32, (v, h, w, 3), lab.device)
    cells = spmap.center.shape[1:3]
    for name, t, c in (("spmap.center", spmap.center, 2), ("spmap.color", spmap.color, 3)):
        build.check_input(name, t, torch.float32, (v, *cells, c), lab.device)
    center, color = torch.empty_like(spmap.center), torch.empty_like(spmap.color)
    if center.numel():
        _launch("edge_snap", lab.device, lab.data_ptr(), spmap.center.data_ptr(), spmap.color.data_ptr(),
                center.data_ptr(), color.data_ptr(), v, h, w, cells[0] * cells[1])
    return spmap._replace(center=center, color=color)


def suppress_local_labels_reference(labels: torch.Tensor) -> torch.Tensor:
    """Plain form of :func:`suppress_local_labels`."""
    v, h, w = labels.shape
    diff_count = torch.zeros((v, h, w), dtype=torch.int32, device=labels.device)
    diff_label = torch.full((v, h, w), -1, dtype=labels.dtype, device=labels.device)
    for j in range(-2, 3):
        for i in range(-2, 3):
            # wraps only at the border, which passes through
            nl = torch.roll(labels, shifts=(-j, -i), dims=(1, 2))
            ne = nl != labels
            diff_count = diff_count + ne.to(torch.int32)
            diff_label = torch.where(ne, nl, diff_label)
    col = torch.arange(w, device=labels.device)[None, None, :]
    row = torch.arange(h, device=labels.device)[None, :, None]
    interior = (col > 1) & (row > 1) & (col < w - 2) & (row < h - 2)
    return torch.where(interior & (diff_count >= 16), diff_label, labels)


def suppress_local_labels(labels: torch.Tensor) -> torch.Tensor:
    """Connectivity vote (clcode.cl:676-711): a pixel whose 5x5
    neighbourhood holds >= 16 labels other than its own adopts the last
    such label of the scan (rows j outer, columns i inner).  The 2-px
    border passes through.  ``segment`` applies it twice, the reference's
    ping-pong (clSLIC.cpp:390-410).  ``slic_vote`` on contiguous int32
    CUDA labels, the plain form on CPU ones."""
    if route(labels.device) == "plain":
        return suppress_local_labels_reference(labels)
    if labels.ndim != 3:
        raise ValueError(f"labels has shape {tuple(labels.shape)}, expected (V, H, W)")
    build.check_input("labels", labels, torch.int32, tuple(labels.shape), labels.device)
    out = torch.empty_like(labels)
    _launch("slic_vote", labels.device, labels.data_ptr(), out.data_ptr(), *labels.shape)
    return out


def _segment(lab, geom, p, assign, update, vote, snap) -> tuple[torch.Tensor, SuperpixelMap]:
    spmap = init_cluster_centers(lab, geom)
    if p.edge_enable:
        spmap = snap(lab, spmap)
    labels = assign(lab, spmap, geom, p)
    for _ in range(p.no_iter):
        spmap = update(lab, labels, spmap, geom)
        labels = assign(lab, spmap, geom, p)
    if p.enforce_connectivity:
        labels = vote(vote(labels))
    return labels, spmap


def segment(
    lab: torch.Tensor, geom: DerivedGeometry, p: SlicParams
) -> tuple[torch.Tensor, SuperpixelMap]:
    """Full SLIC sequence for all views (clSLIC.cpp:84-104).

    Returns (labels (V, H, W) int32, SuperpixelMap).
    """
    return _segment(lab, geom, p, find_center_association, update_cluster_centers, suppress_local_labels,
                    edge_snap)


def segment_reference(
    lab: torch.Tensor, geom: DerivedGeometry, p: SlicParams
) -> tuple[torch.Tensor, SuperpixelMap]:
    """:func:`segment` through the plain forms on any device: what the
    kernels are held to on the card."""
    return _segment(lab, geom, p, find_center_association_reference, update_cluster_centers_reference,
                    suppress_local_labels_reference, edge_snap_reference)
