"""Plane rasterization on the card: each pixel's disparity from the plane
of the superpixel that owns it (``spixl_to_image``, ``clcode.cl:1906-1931``;
``csrc/raster.cu``).

The JAX package computes it with XLA (``ops/refine.py`` ``_rasterize_flat``,
``ops/fusion.py`` ``rasterize_planes``).  The port's plain forms are
``refine.rasterize_table_reference`` (the sweep's (V*rows*W, 4) table
``[disp, L, a, b]``) and ``fusion.rasterize_planes_reference`` (fusion's
(V, H, W) map): a gathered (V, rows, W, 6) pixel copy of the cell pack and
five elementwise passes.  The kernel reads each pixel's label and its
cell's plane and is bitwise the plain forms on the card.

:func:`table` and :func:`planes` launch ``raster_planes`` on CUDA tensors
(or raise) and run the plain forms on CPU tensors (:func:`route`); nothing
falls back from one to the other.  ``refine.rasterize_table`` and
``fusion.rasterize_planes`` call them, so every caller takes the kernel on
the card: ``refine.build_cache`` at the init and each sweep, the
row-sharded ``spatial.block_table`` with its ``row0``, the view-sharded
``cache_for``, ``fusion.fuse_views`` and the sharded fusion.  The wrappers
make the inputs contiguous (a copy only where they are not) and the labels
int32, launch on the current stream (so ``MVSPipeline.jitted()``'s graph
captures them), and launch nothing for an empty output.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from cl_multiview_stereo_tpu_torch.kernels import build
from cl_multiview_stereo_tpu_torch.kernels.build import check_input
from cl_multiview_stereo_tpu_torch.ops.fusion import rasterize_planes_reference
from cl_multiview_stereo_tpu_torch.ops.refine import rasterize_table_reference

# The kernel's launches since import (or since the caller reset them):
# chip_smoke.py reads them to show that the main path went through it.
LAUNCHES = {"raster_planes": 0}
# pointer and int arguments of the C entry, in order, before the stream
# (kernels/build.py's library "raster")
_ENTRIES = {"raster_planes": (6, 5, 0)}


def route(device) -> str:
    """Where a tensor on ``device`` is rasterized: ``"plain"`` (the plain
    forms) on the CPU, ``"kernel"`` on a CUDA device; any other device
    raises."""
    kind = torch.device(device).type
    if kind == "cpu":
        return "plain"
    if kind == "cuda":
        return "kernel"
    raise ValueError(f"no raster kernel for device {device}")


@functools.cache
def _entry(name: str):
    """The C entry ``<name>_launch`` of ``csrc/raster.cu``, built at first use."""
    fn = getattr(build.load("raster"), f"{name}_launch")
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


def _raster(labels, center, state_d, state_n, ras_color, row0: int) -> torch.Tensor:
    """One ``raster_planes`` launch: the (V*rows*W, 4) table with
    ``ras_color``, else the (V, rows, W) disparity."""
    dev = state_d.device
    if labels.ndim != 3 or state_d.ndim != 3:
        raise ValueError(f"labels {tuple(labels.shape)} and state_d {tuple(state_d.shape)} must be 3-D")
    if row0 < 0:
        raise ValueError(f"row0 must be >= 0, got {row0}")
    v, rows, w = labels.shape
    mh, mw = state_d.shape[1:]
    f32 = torch.float32
    labels = labels.to(torch.int32).contiguous()
    center, state_d, state_n = (a.contiguous() for a in (center, state_d, state_n))
    check_input("labels", labels, torch.int32, (v, rows, w), dev)
    check_input("center", center, f32, (v, mh, mw, 2), dev)
    check_input("state_d", state_d, f32, (v, mh, mw), dev)
    check_input("state_n", state_n, f32, (v, mh, mw, 3), dev)
    if ras_color is None:
        out, color_ptr = torch.empty((v, rows, w), dtype=f32, device=dev), None
    else:
        ras_color = ras_color.contiguous()
        check_input("ras_color", ras_color, f32, (v * rows * w, 3), dev)
        out, color_ptr = torch.empty((v * rows * w, 4), dtype=f32, device=dev), ras_color.data_ptr()
    if out.numel():
        _launch("raster_planes", dev, labels.data_ptr(), center.data_ptr(), state_d.data_ptr(),
                state_n.data_ptr(), color_ptr, out.data_ptr(), v, mh * mw, rows, w, row0)
    return out


def table(labels, center, ras_color, state_d, state_n, row0: int = 0) -> torch.Tensor:
    """The input state rasterized for the pixel rows ``labels`` (V, rows,
    W) holds (the image's rows from ``row0``), packed with each pixel's
    superpixel colour ``ras_color`` (V*rows*W, 3): (V*rows*W, 4).

    A CUDA ``state_d`` launches ``raster_planes`` once; a CPU one runs
    ``refine.rasterize_table_reference``; another device raises."""
    if route(state_d.device) == "plain":
        return rasterize_table_reference(labels, center, ras_color, state_d, state_n, row0)
    return _raster(labels, center, state_d, state_n, ras_color, row0)


def planes(labels, centers, state_d, state_n) -> torch.Tensor:
    """Per-pixel disparity (V, H, W) from the owning superpixel's plane.

    A CUDA ``state_d`` launches ``raster_planes`` once; a CPU one runs
    ``fusion.rasterize_planes_reference``; another device raises."""
    if route(state_d.device) == "plain":
        return rasterize_planes_reference(labels, centers, state_d, state_n)
    return _raster(labels, centers, state_d, state_n, None, 0)
