"""Fusion's cross-check on the card: the occlusion-aware inverse warp and
the stability vote (``clcode.cl:1995-2101``; ``csrc/crosscheck.cu``).

The JAX package computes them with XLA (``ops/fusion.py``
``project_to_reference_inv``, ``remove_view_inconsistency``).  The port's
plain forms are ``fusion.project_to_reference_inv_reference`` and
``fusion.remove_view_inconsistency_reference``: Python loops over the views,
each probe a dozen passes over a (V, H, W) tensor.  ``fuse_warp`` and
``fuse_vote`` take a thread a pixel for all the launch's reference views
and are bitwise the plain forms on the card, NaN in the same places: the
warp runs a thread's probe chains side by side (those of all reference
views, or of a group of them, and for one or two views those of several
rows); the vote loads a pixel's candidates once and walks their distinct
values in descending order, vote 1 once a value for every reference view,
each view taking the first value whose stability is >= 0 (a pixel with a
NaN candidate walks in view order, as the plain form does).

:func:`warp` and :func:`vote` launch them on CUDA tensors (or raise) and
run the plain forms on CPU tensors (:func:`route`); nothing falls back from
one to the other.  ``fusion.project_to_reference_inv`` and
``fusion.remove_view_inconsistency`` call them, so ``fusion.fuse_views``
with ``cross_check`` and the view-sharded pipeline's fusion (each rank its
``view_range``, the warped maps all-gathered between the two) take the
kernels on the card.  The wrappers take float32 maps, make them contiguous
(a copy only where they are not), launch on the current stream (so
``MVSPipeline.jitted()``'s graph captures them), and launch nothing for an
empty output.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from cl_multiview_stereo_tpu_torch.kernels import build
from cl_multiview_stereo_tpu_torch.kernels.build import check_input
from cl_multiview_stereo_tpu_torch.ops.fusion import (
    _f32,
    project_to_reference_inv_reference,
    remove_view_inconsistency_reference,
    view_bounds,
)

# Each kernel's launches since import (or since the caller reset them):
# chip_smoke.py reads them to show that the main path went through them.
LAUNCHES = {"fuse_warp": 0, "fuse_vote": 0}
# pointer and int arguments of each C entry, then its floats, before the
# stream (kernels/build.py's library "crosscheck")
_ENTRIES = {"fuse_warp": (2, 6, 1), "fuse_vote": (3, 6, 2)}


def route(device) -> str:
    """Where a tensor on ``device`` is cross-checked: ``"plain"`` (the plain
    forms) on the CPU, ``"kernel"`` on a CUDA device; any other device
    raises."""
    kind = torch.device(device).type
    if kind == "cpu":
        return "plain"
    if kind == "cuda":
        return "kernel"
    raise ValueError(f"no cross-check kernel for device {device}")


@functools.cache
def _entry(name: str):
    """The C entry ``<name>_launch`` of ``csrc/crosscheck.cu``, built at first use."""
    fn = getattr(build.load("crosscheck"), f"{name}_launch")
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


def _maps(*maps: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """The float32 (V, H, W) maps, contiguous, each of the first's shape
    and device; raises on any other."""
    if maps[0].ndim != 3:
        raise ValueError(f"disparity maps have shape {tuple(maps[0].shape)}, expected (V, H, W)")
    out = tuple(m.contiguous() for m in maps)
    for i, m in enumerate(out):
        check_input(f"map {i}", m, torch.float32, tuple(maps[0].shape), maps[0].device)
    return out


def warp(disp_full: torch.Tensor, array_width: int, bl_ratio: float,
         view_range: tuple[int, int] | None = None) -> torch.Tensor:
    """The occlusion-aware inverse warp of ``disp_full`` (V, H, W) for the
    reference views of ``view_range`` (v0, nv) (all V for None): (nv, H, W).

    A CUDA map launches ``fuse_warp`` once; a CPU one runs
    ``fusion.project_to_reference_inv_reference``; another device raises."""
    if route(disp_full.device) == "plain":
        return project_to_reference_inv_reference(disp_full, array_width, bl_ratio, view_range)
    disp, = _maps(disp_full)
    v, h, w = disp.shape
    v0, nv = view_bounds(view_range, v)
    out = torch.empty((nv, h, w), dtype=torch.float32, device=disp.device)
    if out.numel():
        _launch("fuse_warp", disp.device, disp.data_ptr(), out.data_ptr(), v, h, w, v0, nv, int(array_width),
                _f32(bl_ratio))
    return out


def vote(disp_proj: torch.Tensor, disp_full: torch.Tensor, array_width: int, bl_ratio: float, fuse: float,
         view_range: tuple[int, int] | None = None) -> torch.Tensor:
    """The stability vote over the warped maps ``disp_proj`` and the
    unwarped ``disp_full`` (both (V, H, W)) for the reference views of
    ``view_range`` (v0, nv): (nv, H, W).

    A CUDA ``disp_proj`` launches ``fuse_vote`` once; a CPU one runs
    ``fusion.remove_view_inconsistency_reference``; another device raises."""
    if route(disp_proj.device) == "plain":
        return remove_view_inconsistency_reference(disp_proj, disp_full, array_width, bl_ratio, fuse, view_range)
    proj, disp = _maps(disp_proj, disp_full)
    v, h, w = proj.shape
    v0, nv = view_bounds(view_range, v)
    out = torch.empty((nv, h, w), dtype=torch.float32, device=proj.device)
    if out.numel():
        _launch("fuse_vote", proj.device, proj.data_ptr(), disp.data_ptr(), out.data_ptr(), v, h, w, v0, nv,
                int(array_width), _f32(bl_ratio), _f32(fuse))
    return out
