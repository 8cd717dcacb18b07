"""Plane-sweep depth initialization (port of
``cl_multiview_stereo_tpu/ops/cost_volume.py``).

Per superpixel, a 5x5 adaptive sample grid is swept over the disparity
ladder (``initial_depth_estimation_v2``, ``clcode.cl:972-1069``).  The cost
of hypothesis d against the neighbour at camera-grid delta g is the SAD of
Lab colours between each reference sample and its projection, 30 for a
sample whose projection leaves the image; the per-hypothesis cost is the
min over valid deltas and the disparity is the first minimum over d.

:func:`superpixel_cost_volume` is the kernel's wrapper: on a CUDA tensor it
launches ``csrc/cost_volume.cu`` (or raises), on a CPU tensor it runs
:func:`cost_volume_reference`, the same function in plain PyTorch.  The
JAX module's "strips" and "dense" forms compute this one function (they
differ only in TPU staging), so both methods go to the kernel.

:func:`cost_volume_gather` is the JAX module's direct per-sample gather
form (``method="gather"``), plain PyTorch on every device.  It is another
function: it truncates ``float(x) - shift`` where the kernel takes
``x - ceil(shift)``, tests validity on the truncated integers, and walks
the -1 padded neighbour table; JAX's own suite bounds its WTA agreement
with the dense form at 0.999.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np
import torch

from cl_multiview_stereo_tpu_torch.device import device_table
from cl_multiview_stereo_tpu_torch.ops.fusion import view_bounds
from cl_multiview_stereo_tpu_torch.ops.superpixel import extent_step

_OOB_PENALTY = 30.0
_BIG = 1.0e6

# Kernel launches since import (or since the caller reset it): chip_smoke.py
# reads it to show that the main path went through the kernel.
LAUNCHES = 0


def _deltas(neib_hor: int, neib_ver: int) -> list[tuple[int, int]]:
    return [
        (gx, gy)
        for gx in range(-neib_hor, neib_hor + 1)
        for gy in range(-neib_ver, neib_ver + 1)
        if not (gx == 0 and gy == 0)
    ]


def cost_volume_reference(
    lab: torch.Tensor,  # (V, H, W, 3)
    centers: torch.Tensor,  # (V, Mh, Mw, 2)
    step: torch.Tensor,  # (V, Mh, Mw, 2)
    disp_levels: Sequence[float] | np.ndarray | torch.Tensor,
    array_width: int,
    bl_ratio: float,
    neib_hor: int = 1,
    neib_ver: int = 1,
    view_range: tuple[int, int] | None = None,
) -> torch.Tensor:
    """Plain PyTorch cost volume, (nv, D, Mh, Mw) float32.

    The same f32 arithmetic as the kernel and the JAX dense/strips forms:
    truncated sample positions, shifts ``ceil(d*gx)``/``ceil((bl*d)*gy)``,
    clamped projected reads, the exact ``-1 < x - c < size`` validity test,
    samples summed one at a time from 0.  ``view_range`` ``(v0, nv)``
    computes the reference views ``v0 .. v0 + nv - 1`` only (default: all
    V views); every view's image stays readable as a neighbour.
    """
    v, h, w = lab.shape[:3]
    v0, nv_ref = view_bounds(view_range, v)
    mh, mw = centers.shape[1:3]
    dev = lab.device
    dl = torch.as_tensor(disp_levels, dtype=torch.float32, device=dev)
    n_d = dl.shape[0]
    array_height = v // array_width
    flat = lab.reshape(v * h * w, 3)
    vid = torch.arange(v0, v0 + nv_ref, dtype=torch.int64, device=dev)

    cx, cy = centers[v0:v0 + nv_ref, ..., 0], centers[v0:v0 + nv_ref, ..., 1]
    sx, sy = step[v0:v0 + nv_ref, ..., 0], step[v0:v0 + nv_ref, ..., 1]
    samples = []  # (xr, yr, ref_ok, ref colour), i outer, j inner
    for i in range(-2, 3):
        xr = (cx + float(i) * sx).to(torch.int64)  # C truncation
        for j in range(-2, 3):
            yr = (cy + float(j) * sy).to(torch.int64)
            ref_ok = (xr >= 0) & (yr >= 0) & (xr < w) & (yr < h)
            ref_idx = (vid[:, None, None] * h + yr.clamp(0, h - 1)) * w + xr.clamp(0, w - 1)
            samples.append((xr, yr, ref_ok, flat[ref_idx]))

    vol = torch.full((nv_ref, n_d, mh, mw), _BIG, dtype=torch.float32, device=dev)
    bl_d = dl * float(np.float32(bl_ratio))
    for gx, gy in _deltas(neib_hor, neib_ver):
        valid_np = np.array(
            [0 <= z % array_width + gx < array_width and 0 <= z // array_width + gy < array_height
             for z in range(v0, v0 + nv_ref)]
        )
        if not valid_np.any():
            continue
        valid = torch.as_tensor(valid_np, device=dev)[:, None, None, None]
        nv = (vid + gy * array_width + gx) % v
        cxs = (dl * float(gx))[None, :, None, None]  # (1, D, 1, 1)
        cys = (bl_d * float(gy))[None, :, None, None]
        shx = torch.ceil(cxs).to(torch.int64)
        shy = torch.ceil(cys).to(torch.int64)
        acc = torch.zeros((nv_ref, n_d, mh, mw), dtype=torch.float32, device=dev)
        for xr, yr, ref_ok, ref in samples:
            xr4, yr4 = xr[:, None], yr[:, None]  # (nv, 1, Mh, Mw)
            px = xr4.to(torch.float32) - cxs
            py = yr4.to(torch.float32) - cys
            ok = ref_ok[:, None] & (px > -1.0) & (px < w) & (py > -1.0) & (py < h)
            xp = (xr4 - shx).clamp(0, w - 1)
            yp = (yr4 - shy).clamp(0, h - 1)
            q = flat[(nv[:, None, None, None] * h + yp) * w + xp]  # (V, D, Mh, Mw, 3)
            r = ref[:, None]
            sad = (
                torch.abs(r[..., 0] - q[..., 0])
                + torch.abs(r[..., 1] - q[..., 1])
                + torch.abs(r[..., 2] - q[..., 2])
            )
            acc = acc + torch.where(ok, sad, _OOB_PENALTY)
        vol = torch.where(valid, torch.minimum(vol, acc), vol)
    return vol


def _check_input(name: str, t: torch.Tensor, shape: tuple, device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(lab, centers, step, dl, array_width, bl_ratio, neib_hor, neib_ver, view_range):
    global LAUNCHES
    from cl_multiview_stereo_tpu_torch.kernels.build import load

    v, h, w = lab.shape[:3]
    mh, mw = centers.shape[1:3]
    dev = lab.device
    _check_input("lab", lab, (v, h, w, 3), dev)
    _check_input("centers", centers, (v, mh, mw, 2), dev)
    _check_input("step", step, (v, mh, mw, 2), dev)
    _check_input("disp_levels", dl, (dl.shape[0],), dev)
    if v % array_width:
        raise ValueError(f"{v} views do not fill rows of array_width {array_width}")
    v0, nv = view_bounds(view_range, v)

    lib = load("cost_volume")
    fn = lib.cost_volume_launch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_float]
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    out = torch.empty((nv, dl.shape[0], mh, mw), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(
            lab.data_ptr(), centers.data_ptr(), step.data_ptr(), dl.data_ptr(),
            out.data_ptr(), v, h, w, mh, mw, dl.shape[0], array_width,
            neib_hor, neib_ver, float(bl_ratio), v0, nv, stream,
        )
    if rc != 0:
        raise RuntimeError(f"cost_volume kernel launch failed with CUDA error {rc}")
    LAUNCHES += 1
    return out


def superpixel_cost_volume(
    lab: torch.Tensor,
    centers: torch.Tensor,
    step: torch.Tensor,
    disp_levels: Sequence[float] | np.ndarray | torch.Tensor,
    array_width: int,
    bl_ratio: float,
    neib_hor: int = 1,
    neib_ver: int = 1,
    view_range: tuple[int, int] | None = None,
) -> torch.Tensor:
    """(nv, D, Mh, Mw) float32 cost volume of the reference views
    ``view_range`` = (v0, nv) (default: all V); 1e6 for views with no valid
    delta.  ``lab``, ``centers`` and ``step`` hold all V views.

    A CUDA ``lab`` launches the kernel; a CPU ``lab`` runs the plain twin.
    Nothing falls back from one to the other."""
    if lab.device.type == "cpu":
        return cost_volume_reference(
            lab, centers, step, disp_levels, array_width, bl_ratio, neib_hor, neib_ver, view_range
        )
    if lab.device.type != "cuda":
        raise ValueError(f"no cost-volume kernel for device {lab.device}")
    dl = device_table(disp_levels, torch.float32, lab.device)
    return _launch(lab, centers, step, dl, array_width, bl_ratio, neib_hor, neib_ver, view_range)


def cost_volume_gather(
    lab: torch.Tensor,  # (V, H, W, 3)
    centers: torch.Tensor,  # (V, Mh, Mw, 2)
    step: torch.Tensor,  # (V, Mh, Mw, 2)
    disp_levels: Sequence[float] | np.ndarray | torch.Tensor,
    view_subset: np.ndarray | torch.Tensor,  # (V, max_n) int, -1 padded
    array_width: int,
    bl_ratio: float,
    view_range: tuple[int, int] | None = None,
) -> torch.Tensor:
    """The gather form of the cost volume (JAX ``superpixel_cost_volume``),
    (nv, D, Mh, Mw) float32 for the reference views ``view_range`` (as
    :func:`superpixel_cost_volume`); ``_BIG`` for views with no neighbour.

    Per neighbour slot and hypothesis the shifts are f32 products
    ``d * dvx`` and ``(bl * d) * dvy``; each sample's projected position is
    ``trunc(float(x) - shift)``, valid when the truncated integers lie in
    the image; samples add in (i outer, j inner) order from 0 and slots
    reduce by ``min``."""
    v, h, w = lab.shape[:3]
    v0, nv_ref = view_bounds(view_range, v)
    mh, mw = centers.shape[1:3]
    dev = lab.device
    dl = device_table(disp_levels, torch.float32, dev)
    n_d = dl.shape[0]
    subset = device_table(view_subset, torch.int64, dev)[v0:v0 + nv_ref]
    flat = lab.reshape(v * h * w, 3)
    vid = torch.arange(v0, v0 + nv_ref, dtype=torch.int64, device=dev)
    views = subset.clamp(0, v - 1)  # (nv, max_n)
    dvx = (views % array_width - (vid % array_width)[:, None]).to(torch.float32)
    dvy = (views // array_width - (vid // array_width)[:, None]).to(torch.float32)
    bl_d = float(np.float32(bl_ratio)) * dl  # (D,)

    cx, cy = centers[v0:v0 + nv_ref, ..., 0], centers[v0:v0 + nv_ref, ..., 1]
    sx, sy = step[v0:v0 + nv_ref, ..., 0], step[v0:v0 + nv_ref, ..., 1]
    samples = []  # (xr, yr, ref_ok, ref colour), i outer, j inner
    for i in range(-2, 3):
        xr = (cx + float(i) * sx).to(torch.int64)  # C truncation
        for j in range(-2, 3):
            yr = (cy + float(j) * sy).to(torch.int64)
            ref_ok = (xr >= 0) & (yr >= 0) & (xr < w) & (yr < h)
            ref_idx = (vid[:, None, None] * h + yr.clamp(0, h - 1)) * w + xr.clamp(0, w - 1)
            samples.append((xr[:, None], yr[:, None], ref_ok[:, None], flat[ref_idx][:, None]))

    vol = torch.full((nv_ref, n_d, mh, mw), _BIG, dtype=torch.float32, device=dev)
    for k in range(subset.shape[1]):
        shift_x = (dl[None, :] * dvx[:, k, None])[:, :, None, None]  # (V, D, 1, 1)
        shift_y = (bl_d[None, :] * dvy[:, k, None])[:, :, None, None]
        nbr = views[:, k, None, None, None]
        acc = torch.zeros((nv_ref, n_d, mh, mw), dtype=torch.float32, device=dev)
        for xr, yr, ref_ok, ref in samples:
            xp = (xr.to(torch.float32) - shift_x).to(torch.int64)  # C truncation
            yp = (yr.to(torch.float32) - shift_y).to(torch.int64)
            ok = ref_ok & (xp >= 0) & (yp >= 0) & (xp < w) & (yp < h)
            q = flat[(nbr * h + yp.clamp(0, h - 1)) * w + xp.clamp(0, w - 1)]
            sad = (
                torch.abs(ref[..., 0] - q[..., 0])
                + torch.abs(ref[..., 1] - q[..., 1])
                + torch.abs(ref[..., 2] - q[..., 2])
            )
            acc = acc + torch.where(ok, sad, _OOB_PENALTY)
        slot_ok = (subset[:, k] >= 0)[:, None, None, None]
        vol = torch.minimum(vol, torch.where(slot_ok, acc, _BIG))
    return vol


def wta_disparity(
    vol: torch.Tensor,
    disp_levels: Sequence[float] | np.ndarray | torch.Tensor,
    subset_num: torch.Tensor,
) -> torch.Tensor:
    """Winner-take-all over the hypothesis axis (clcode.cl:1059-1067):
    ``argmin`` returns the first minimum, the reference's strict ``<``
    ascending scan.  Views with no neighbours keep 0.0."""
    dl = device_table(disp_levels, torch.float32, vol.device)
    disp = dl[torch.argmin(vol, dim=1)]
    has_views = device_table(subset_num, torch.int32, vol.device) > 0
    return torch.where(has_views[:, None, None], disp, 0.0)


DEPTH_METHODS = ("dense", "strips", "gather")


def check_method(method: str) -> None:
    if method not in DEPTH_METHODS:
        raise ValueError(f"unknown depth method {method!r}; expected one of {DEPTH_METHODS}")


def initial_depth_estimation(
    lab: torch.Tensor,
    centers: torch.Tensor,
    extent: torch.Tensor,
    disp_levels,
    view_subset,
    subset_num: torch.Tensor,
    array_width: int,
    bl_ratio: float,
    method: str = "strips",
    neib_hor: int = 1,
    neib_ver: int = 1,
    view_range: tuple[int, int] | None = None,
) -> torch.Tensor:
    """Extent -> adaptive step -> cost volume -> WTA; (nv, Mh, Mw) float32.

    ``method``: ``"strips"`` and ``"dense"`` are one function here and run
    the kernel, with the neighbour views of the camera-grid deltas within
    ``neib_hor``/``neib_ver``; ``"gather"`` runs :func:`cost_volume_gather`
    over the -1 padded ``view_subset`` table (V, max_n), as in JAX.
    ``view_range`` (v0, nv): the reference views to estimate (default all
    V); every input holds all V views.
    """
    check_method(method)
    step = extent_step(extent).contiguous()
    if method == "gather":
        vol = cost_volume_gather(
            lab, centers, step, disp_levels, view_subset, array_width, bl_ratio, view_range
        )
    else:
        vol = superpixel_cost_volume(
            lab.contiguous(), centers.contiguous(), step, disp_levels,
            array_width, bl_ratio, neib_hor, neib_ver, view_range,
        )
    v0, nv = view_bounds(view_range, lab.shape[0])
    counts = device_table(subset_num, torch.int32, lab.device)[v0:v0 + nv]
    return wta_disparity(vol, disp_levels, counts)
