"""Consistency scores of all candidate moves of one sweep (port of
``cl_multiview_stereo_tpu/ops/pallas/consistency.py``, the "strips" engine,
and on the card also the gather engine's scorer).

The JAX module stages, for every (pair, cell, sample), a 32-position strip
of the rasterized input state so that its Pallas ``_terms_kernel`` can
resolve every move with one 128-lane lookup; lookups outside the strip are
fixed up by an exact narrow gather.  That staging serves Mosaic's lane
gather only.  On the card ``csrc/consistency.cu`` computes the function it
served: each thread scores moves of one cell, walking the view's pairs
and the 9 samples and reading each projected pixel of ``cache.ras``
directly; the threads of one cell's moves are neighbouring lanes of a
warp, so their reads are served together.

:func:`consistency_moves` launches the kernel on CUDA tensors (or raises)
and runs :func:`consistency_moves_reference`, the plain twin, on CPU
tensors (:func:`route`).  The twin is ``refine.consistency_from_cache``
over the move axis in ``score_chunk`` batches.  ``rule`` names how a
sample that does not project into the table counts:

- ``"strips"``: the strips engine's one documented difference from the
  gather form: a sample whose candidate-plane disparity is not finite
  counts as outside the image for every pair (JAX ``consistency.py:35-39``,
  which explains why the accept chain rejects such candidates under either
  engine);
- ``"gather"``: the gather form itself, NaN terms included, so that
  ``refine.score_moves`` and ``refine.init_scores`` can send the gather
  engine's CUDA tensors here.

``img_hw``/``ras_rows`` are ``consistency_from_cache``'s: the image size
when ``ctx`` holds a band of cell rows, and the rows of each view that
``cache.ras`` holds.  ``cache.ras`` may hold more views than ``ctx`` (a
block of views scored against every view's table); the pairs' neighbours
index the table's views.

Against the JAX signature, the frozen-state window anchor (``state_d``,
``state_n``) is dropped, because it only places the TPU strip window, and
so is the escape-overflow count, because no lookup can escape here.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from cl_multiview_stereo_tpu_torch.device import device_table
from cl_multiview_stereo_tpu_torch.kernels.build import check_input
from cl_multiview_stereo_tpu_torch.ops.refine import (
    SCORE_CHUNK,
    IterCache,
    RefineContext,
    consistency_from_cache,
)

# Kernel launches since import (or since the caller reset it): chip_smoke.py
# reads it to show that the main path went through the kernel.
LAUNCHES = 0
RULES = ("strips", "gather")


def route(device) -> str:
    """Where a tensor on ``device`` is scored: ``"plain"`` (the plain twin)
    on the CPU, ``"kernel"`` on a CUDA device; any other device raises."""
    kind = torch.device(device).type
    if kind == "cpu":
        return "plain"
    if kind == "cuda":
        return "kernel"
    raise ValueError(f"no consistency kernel for device {device}")


def consistency_moves_reference(
    ctx: RefineContext,
    cache: IterCache,
    d_c: torch.Tensor,  # (M, V, Mh, Mw)
    n_c: torch.Tensor,  # (M, V, Mh, Mw, 3)
    *,
    gamma: float,
    alpha: float,
    fuse: float,
    bl_ratio: float,
    pairs: tuple,
    score_chunk: int = SCORE_CHUNK,
    rule: str = "strips",
    img_hw: tuple[int, int] | None = None,
    ras_rows: tuple[int, int] | None = None,
) -> torch.Tensor:
    """Plain PyTorch scores (M, V, Mh, Mw), ``score_chunk`` moves at a time."""
    _check_rule(rule)
    parts = [
        consistency_from_cache(
            ctx, cache, d_c[k:k + score_chunk], n_c[k:k + score_chunk], gamma=gamma,
            alpha=alpha, fuse=fuse, bl_ratio=bl_ratio, pairs=pairs,
            blown_up_outside=rule == "strips", img_hw=img_hw, ras_rows=ras_rows,
        )
        for k in range(0, d_c.shape[0], score_chunk)
    ]
    return torch.cat(parts) if parts else torch.empty_like(d_c)


def _check_rule(rule: str) -> None:
    if rule not in RULES:
        raise ValueError(f"unknown rule {rule!r}; expected one of {RULES}")


def pair_tables(pairs: tuple, n_views: int, table_views: int | None = None) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(start (V+1,) int32, view (P,) int32, (dvx, dvy) (P, 2) float32).
    The pairs must be grouped by reference view in ascending order, as
    ``refine.pairs_from_subsets`` makes them; the sums keep their order.
    ``n_views`` counts the reference views scored, ``table_views`` (default
    ``n_views``) the views of the table that the neighbours index."""
    table_views = n_views if table_views is None else table_views
    refs = np.asarray([p[0] for p in pairs], np.int64)
    if np.any(np.diff(refs) < 0) or np.any(refs < 0) or np.any(refs >= n_views):
        raise ValueError("pairs must be grouped by reference view in ascending order")
    start = np.searchsorted(refs, np.arange(n_views + 1)).astype(np.int32)
    view = np.asarray([p[1] for p in pairs], np.int32)
    if np.any(view < 0) or np.any(view >= table_views):
        raise ValueError(f"a pair names a view outside 0..{table_views - 1}")
    dv = np.asarray([(p[2], p[3]) for p in pairs], np.float32).reshape(len(pairs), 2)
    return start, view, dv


def device_pair_tables(pairs: tuple, n_views: int, device, table_views: int | None = None) -> tuple[torch.Tensor, ...]:
    """:func:`pair_tables` as tensors on ``device``, copied there once per
    value (``device.device_table``), so that a launch copies nothing from
    the host."""
    return tuple(device_table(a, torch.from_numpy(a).dtype, device)
                 for a in pair_tables(pairs, n_views, table_views))


def _launch(ctx, cache, d_c, n_c, *, gamma, alpha, fuse, bl_ratio, pairs, rule, img_hw, ras_rows):
    global LAUNCHES
    from cl_multiview_stereo_tpu_torch.kernels.build import load

    dev = d_c.device
    m = d_c.shape[0]
    v, mh, mw = ctx.center.shape[:3]
    h, w = ctx.labels.shape[1:3] if img_hw is None else img_hw
    row_lo, rows = (0, h) if ras_rows is None else ras_rows
    f32 = torch.float32
    check_input("d_c", d_c, f32, (m, v, mh, mw), dev)
    check_input("n_c", n_c, f32, (m, v, mh, mw, 3), dev)
    check_input("ctx.center", ctx.center, f32, (v, mh, mw, 2), dev)
    check_input("ctx.color", ctx.color, f32, (v, mh, mw, 3), dev)
    check_input("ctx.samples", ctx.samples, torch.int32, (v, mh, 9, mw, 2), dev)
    check_input("ctx.fl", ctx.fl, f32, (v, mh, mw, 2), dev)
    if rows < 1 or cache.ras.ndim != 2 or cache.ras.shape[0] % (rows * w):
        raise ValueError(f"cache.ras has shape {tuple(cache.ras.shape)}, not whole views of {rows} rows x {w}")
    table_views = cache.ras.shape[0] // (rows * w)
    check_input("cache.ras", cache.ras, f32, (table_views * rows * w, 4), dev)
    if cache.ras.data_ptr() % 16:
        raise ValueError("cache.ras must be 16-byte aligned (one float4 per pixel)")
    start, view, dv = device_pair_tables(pairs, v, dev, table_views)

    lib = load("consistency")
    fn = lib.consistency_launch
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 10 + [ctypes.c_float] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty((m, v, mh, mw), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(
            ctx.center.data_ptr(), ctx.color.data_ptr(), ctx.samples.data_ptr(),
            ctx.fl.data_ptr(), cache.ras.data_ptr(), d_c.data_ptr(), n_c.data_ptr(),
            start.data_ptr(), view.data_ptr(), dv.data_ptr(), out.data_ptr(),
            m, v, mh, mw, h, w, row_lo, rows, len(pairs), int(rule == "gather"),
            gamma, alpha, fuse, bl_ratio, stream,
        )
    if rc != 0:
        raise RuntimeError(f"consistency kernel launch failed with CUDA error {rc}")
    LAUNCHES += 1
    return out


def consistency_moves(
    ctx: RefineContext,
    cache: IterCache,
    d_c: torch.Tensor,  # (M, V, Mh, Mw) candidate plane disparities
    n_c: torch.Tensor,  # (M, V, Mh, Mw, 3) candidate plane normals
    *,
    gamma: float,
    alpha: float,
    fuse: float,
    bl_ratio: float,
    pairs: tuple,
    score_chunk: int = SCORE_CHUNK,
    rule: str = "strips",
    img_hw: tuple[int, int] | None = None,
    ras_rows: tuple[int, int] | None = None,
) -> torch.Tensor:
    """Consistency scores (M, V, Mh, Mw) of every candidate move at once.

    A CUDA ``d_c`` launches the kernel once (every input contiguous, on
    that device); a CPU ``d_c`` runs the plain twin in ``score_chunk``
    batches; another device raises (:func:`route`).  Nothing falls back
    from one to the other."""
    kw = dict(gamma=gamma, alpha=alpha, fuse=fuse, bl_ratio=bl_ratio, pairs=pairs, rule=rule,
              img_hw=img_hw, ras_rows=ras_rows)
    _check_rule(rule)
    if route(d_c.device) == "plain":
        return consistency_moves_reference(ctx, cache, d_c, n_c, score_chunk=score_chunk, **kw)
    return _launch(ctx, cache, d_c, n_c, **kw)
