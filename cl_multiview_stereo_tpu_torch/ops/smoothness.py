"""PatchMatch smoothness on the card: the sweep's tap cache and the scores of
all candidate moves of a phase (``csrc/smoothness.cu``).

The JAX package computes both with XLA (``ops/refine.py``:
``build_cell_cache`` and ``smoothness_from_cache``); the reference ran them
inside its propagate kernel (``clcode.cl:1136-1254``, ``:1407-1525``).  The
port's plain forms are the functions of the same names in ``ops/refine``,
which add their taps one at a time in tap order; the kernels keep that order
and the forms' flush points, and are bitwise the plain forms on the card.

:func:`cell_cache` and :func:`smoothness_moves` launch the kernels on CUDA
tensors (or raise) and run the plain forms on CPU tensors (:func:`route`);
nothing falls back from one to the other.

- ``smooth_cache``: every field of ``refine.IterCache`` but ``ras`` (left
  the plain form's (1, 4) zeros), for the whole map or for a band of its
  cell rows (``rows``), the taps and ring read from the whole map;
- ``smooth_moves``: one launch scores all M moves of a phase.

Both kernels take dense arrays, so the wrappers make every input
contiguous, a copy only where it is not (a cache cut to a band of rows by
the plain route), with one exception: ``smooth_moves`` takes ``d_c``'s
move stride, so the refit phase's ``d0[None].expand(8, ...)`` (stride 0)
is read from ``d0`` itself, never copied.  A band of the row-sharded
refinement is not cut on the card: ``cell_cache(rows=...)`` has the kernel
write only those rows.  An empty output launches nothing.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from cl_multiview_stereo_tpu_torch.device import device_table
from cl_multiview_stereo_tpu_torch.kernels import build
from cl_multiview_stereo_tpu_torch.kernels.build import check_input
from cl_multiview_stereo_tpu_torch.ops.refine import (
    SCORE_CHUNK,
    IterCache,
    RefineContext,
    build_cell_cache,
    smoothness_from_cache,
    tap_gammas,
)

# Each kernel's launches since import (or since the caller reset them):
# chip_smoke.py reads them to show that the main path went through the
# kernels.
LAUNCHES = {"smooth_cache": 0, "smooth_moves": 0}
# pointer, int and float arguments of each C entry, in order, before the
# stream (kernels/build.py's library "smoothness")
_ENTRIES = {
    "smooth_cache": (14, 6, 1),
    "smooth_moves": (8, 4, 1),
}
# the fields that smooth_cache writes, in IterCache's order
_CACHE_FIELDS = tuple(f for f in IterCache._fields if f != "ras")


def route(device) -> str:
    """Where a tensor on ``device`` is scored: ``"plain"`` (the plain forms)
    on the CPU, ``"kernel"`` on a CUDA device; any other device raises."""
    kind = torch.device(device).type
    if kind == "cpu":
        return "plain"
    if kind == "cuda":
        return "kernel"
    raise ValueError(f"no smoothness kernel for device {device}")


@functools.cache
def _entry(name: str):
    """The C entry ``<name>_launch`` of ``csrc/smoothness.cu``, built at first use."""
    fn = getattr(build.load("smoothness"), f"{name}_launch")
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


def _check_rows(rows, mh: int) -> tuple[int, int]:
    row0, n = (0, mh) if rows is None else (int(rows[0]), int(rows[1]))
    if row0 < 0 or n < 0 or row0 + n > mh:
        raise ValueError(f"rows {rows} are not a band of the map's {mh} cell rows")
    return row0, n


def cell_cache_reference(
    ctx: RefineContext, tgt_d: torch.Tensor, *, gamma: float, steps: int, step_size: float,
    rows: tuple[int, int] | None = None,
) -> IterCache:
    """The plain form: ``refine.build_cell_cache`` of the whole map, cut to
    the cell rows ``rows`` = (row0, n) when given."""
    row0, n = _check_rows(rows, tgt_d.shape[1])
    cache = build_cell_cache(ctx, tgt_d, gamma=gamma, steps=steps, step_size=step_size)
    if rows is None:
        return cache
    return cache._replace(**{f: getattr(cache, f)[:, row0:row0 + n] for f in _CACHE_FIELDS})


def _launch_cache(ctx, tgt_d, gamma, steps, step_size, rows) -> IterCache:
    dev = tgt_d.device
    if tgt_d.ndim != 3:
        raise ValueError(f"tgt_d has shape {tuple(tgt_d.shape)}, expected (V, Mh, Mw)")
    v, mh, mw = tgt_d.shape
    row0, n = _check_rows(rows, mh)
    if steps < 0:
        raise ValueError(f"steps must be >= 0, got {steps}")
    f32 = torch.float32
    tgt_d, center, color, fl = (a.contiguous() for a in (tgt_d, ctx.center, ctx.color, ctx.fl))
    check_input("tgt_d", tgt_d, f32, (v, mh, mw), dev)
    check_input("ctx.center", center, f32, (v, mh, mw, 2), dev)
    check_input("ctx.color", color, f32, (v, mh, mw, 3), dev)
    check_input("ctx.fl", fl, f32, (v, mh, mw, 2), dev)
    t = 8 + 4 * steps
    gammas = device_table(tap_gammas(gamma, steps), f32, dev)
    taps = [torch.empty((v, n, mw, t), dtype=f32, device=dev) for _ in range(4)]
    wn = torch.empty((v, n, mw), dtype=f32, device=dev)
    ring = [torch.empty((v, n, mw, 8), dtype=f32, device=dev) for _ in range(3)]
    ring_ok = torch.empty((v, n, mw, 8), dtype=torch.bool, device=dev)
    outs = (*taps, wn, *ring, ring_ok)
    if wn.numel():
        _launch("smooth_cache", dev, center.data_ptr(), color.data_ptr(), tgt_d.data_ptr(), fl.data_ptr(),
                gammas.data_ptr(), *(o.data_ptr() for o in outs),
                v, mh, mw, row0, n, steps, step_size)
    fields = dict(zip(_CACHE_FIELDS, (*taps, wn, *ring, ring_ok)))
    return IterCache(ras=torch.zeros((1, 4), dtype=f32, device=dev), **fields)


def cell_cache(
    ctx: RefineContext, tgt_d: torch.Tensor, *, gamma: float, steps: int, step_size: float,
    rows: tuple[int, int] | None = None,
) -> IterCache:
    """The smoothness taps and ring data of one sweep for input
    disparities ``tgt_d`` (V, Mh, Mw): every cell, or the cell rows
    ``rows`` = (row0, n) of the map (the taps still read the whole map).
    ``ras`` is left empty.

    A CUDA ``tgt_d`` launches ``smooth_cache`` once (``ctx``'s centre,
    colour and flatness float32 on that device); a CPU one runs
    :func:`cell_cache_reference`; another device raises."""
    if route(tgt_d.device) == "plain":
        return cell_cache_reference(ctx, tgt_d, gamma=gamma, steps=steps, step_size=step_size, rows=rows)
    return _launch_cache(ctx, tgt_d, gamma, steps, step_size, rows)


def smoothness_moves_reference(
    cache: IterCache, d_c: torch.Tensor, n_c: torch.Tensor, *, alpha: float, score_chunk: int = SCORE_CHUNK,
) -> torch.Tensor:
    """The plain form: ``refine.smoothness_from_cache`` on ``score_chunk``
    moves at a time, (M, V, Mh, Mw)."""
    parts = [smoothness_from_cache(cache, d_c[k:k + score_chunk], n_c[k:k + score_chunk], alpha=alpha)
             for k in range(0, d_c.shape[0], score_chunk)]
    return torch.cat(parts) if parts else torch.empty_like(d_c)


def _launch_moves(cache, d_c, n_c, alpha) -> torch.Tensor:
    dev = d_c.device
    if d_c.ndim != 4:
        raise ValueError(f"d_c has shape {tuple(d_c.shape)}, expected (M, V, Mh, Mw)")
    m, v, mh, mw = d_c.shape
    if cache.tap_ax.ndim != 4:
        raise ValueError(f"cache.tap_ax has shape {tuple(cache.tap_ax.shape)}, expected (V, Mh, Mw, T)")
    t = cache.tap_ax.shape[-1]
    f32 = torch.float32
    if m > 1 and d_c.stride(0) == 0:  # one d row for every move: read it in place
        d_c, d_stride, d_shape = d_c[0].contiguous(), 0, (v, mh, mw)
    else:
        d_c, d_stride, d_shape = d_c.contiguous(), v * mh * mw, (m, v, mh, mw)
    n_c = n_c.contiguous()
    taps = [getattr(cache, f).contiguous() for f in ("tap_ax", "tap_ay", "tap_d", "tap_sim")]
    wn = cache.wn.contiguous()
    check_input("n_c", n_c, f32, (m, v, mh, mw, 3), dev)
    check_input("d_c", d_c, f32, d_shape, dev)
    for name, a in zip(("tap_ax", "tap_ay", "tap_d", "tap_sim"), taps):
        check_input(f"cache.{name}", a, f32, (v, mh, mw, t), dev)
    check_input("cache.wn", wn, f32, (v, mh, mw), dev)
    out = torch.empty((m, v, mh, mw), dtype=f32, device=dev)
    if out.numel():
        _launch("smooth_moves", dev, *(a.data_ptr() for a in taps), wn.data_ptr(), d_c.data_ptr(),
                n_c.data_ptr(), out.data_ptr(), m, v * mh * mw, t, d_stride, alpha)
    return out


def smoothness_moves(
    cache: IterCache, d_c: torch.Tensor, n_c: torch.Tensor, *, alpha: float, score_chunk: int = SCORE_CHUNK,
) -> torch.Tensor:
    """Smoothness scores (M, V, Mh, Mw) of candidate planes ``d_c`` (M, V,
    Mh, Mw), ``n_c`` (M, V, Mh, Mw, 3) against ``cache``'s taps.

    A CUDA ``d_c`` launches ``smooth_moves`` once for all M moves; a CPU
    one runs :func:`smoothness_moves_reference` in ``score_chunk``
    batches; another device raises."""
    if route(d_c.device) == "plain":
        return smoothness_moves_reference(cache, d_c, n_c, alpha=alpha, score_chunk=score_chunk)
    return _launch_moves(cache, d_c, n_c, alpha)
