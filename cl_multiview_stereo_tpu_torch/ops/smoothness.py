"""PatchMatch smoothness on the card: the sweep's cell table and the scores
of all candidate moves of a phase (``csrc/smoothness.cu``).

The JAX package computes both with XLA (``ops/refine.py``:
``build_cell_cache`` and ``smoothness_from_cache``); the reference ran them
inside its propagate kernel (``clcode.cl:1136-1254``, ``:1407-1525``).  The
port's plain forms are the functions of the same names in ``ops/refine``,
which build a (V, Mh, Mw, T) tap cache and add their taps one at a time in
tap order; the kernels keep that order and the forms' flush points, and
are bitwise the plain forms on the card.

:func:`cell_cache` and :func:`smoothness_moves` launch the kernels on CUDA
tensors (or raise) and run the plain forms on CPU tensors (:func:`route`);
nothing falls back from one to the other.

- ``smooth_cache``: ``refine.IterCache``'s ``cell_table`` of the whole map
  (32 bytes a cell: centre, colour, disparity and the long taps' pitch)
  and its ring fields for the whole map or a band of its cell rows
  (``rows``); ``gammas`` and ``row0`` come from the host.  Nothing T-wide
  is allocated: the tap fields and ``wn`` are None, and ``ras`` is left
  the plain form's (1, 4) zeros;
- ``smooth_moves``: one launch scores all M moves of a phase, deriving
  every tap from the table (so it takes the plain form's cache as well).

Both kernels take dense arrays, so the wrappers make every input
contiguous, a copy only where it is not, with one exception:
``smooth_moves`` takes ``d_c``'s move stride, so the refit phase's
``d0[None].expand(8, ...)`` (stride 0) is read from ``d0`` itself, never
copied.  A band of the row-sharded refinement is not cut on the card:
``cell_cache(rows=...)`` has the kernel write only those rows' ring, and
``smooth_moves`` scores the band's cells against the whole map's table.
An empty output launches nothing.

:func:`hoisted_divide` runs ``smooth_moves``' divide on its own, for the
card test that holds it to the IEEE quotient.
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
# stream (kernels/build.py's library "smoothness"); smooth_divide is the
# divide check, not a kernel of the path
_ENTRIES = {
    "smooth_cache": (9, 5, 1),
    "smooth_moves": (5, 8, 1),
    "smooth_divide": (3, 1, 0),
}
# the fields that smooth_cache writes
_CACHE_FIELDS = ("ring_dcx", "ring_dcy", "ring_d", "ring_ok", "cell_table")
# the fields of the cells scored, (V, rows, Mw, ...): a band cuts them
_BAND_FIELDS = ("tap_ax", "tap_ay", "tap_d", "tap_sim", "wn", "ring_dcx", "ring_dcy", "ring_d", "ring_ok")
# the table's floats a cell, and the largest step_size whose pitch it holds
# exactly
TABLE_ROW = 8
MAX_STEP_SIZE = float(2 ** 24)


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


def _launch(name: str, dev: torch.device, *args, count: bool = True) -> None:
    """Calls kernel ``name``'s entry with ``args`` and the current stream of
    ``dev``; raises on a CUDA error and counts the launch."""
    fn = _entry(name)
    with torch.cuda.device(dev):
        rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {rc}")
    if count:
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
    """The plain form: ``refine.build_cell_cache`` of the whole map, its
    fields of the scored cells cut to the cell rows ``rows`` = (row0, n)
    when given (the table stays the whole map's)."""
    row0, n = _check_rows(rows, tgt_d.shape[1])
    cache = build_cell_cache(ctx, tgt_d, gamma=gamma, steps=steps, step_size=step_size)
    if rows is None:
        return cache
    return cache._replace(row0=row0, **{f: getattr(cache, f)[:, row0:row0 + n] for f in _BAND_FIELDS})


def _launch_cache(ctx, tgt_d, gamma, steps, step_size, rows) -> IterCache:
    dev = tgt_d.device
    if tgt_d.ndim != 3:
        raise ValueError(f"tgt_d has shape {tuple(tgt_d.shape)}, expected (V, Mh, Mw)")
    v, mh, mw = tgt_d.shape
    row0, n = _check_rows(rows, mh)
    if steps < 0:
        raise ValueError(f"steps must be >= 0, got {steps}")
    if not abs(step_size) < MAX_STEP_SIZE:
        raise ValueError(f"step_size {step_size} is not below {MAX_STEP_SIZE:g}, the table's exact pitches")
    f32 = torch.float32
    tgt_d, center, color, fl = (a.contiguous() for a in (tgt_d, ctx.center, ctx.color, ctx.fl))
    check_input("tgt_d", tgt_d, f32, (v, mh, mw), dev)
    check_input("ctx.center", center, f32, (v, mh, mw, 2), dev)
    check_input("ctx.color", color, f32, (v, mh, mw, 3), dev)
    check_input("ctx.fl", fl, f32, (v, mh, mw, 2), dev)
    table = torch.empty((v, mh, mw, TABLE_ROW), dtype=f32, device=dev)
    ring = [torch.empty((v, n, mw, 8), dtype=f32, device=dev) for _ in range(3)]
    ring_ok = torch.empty((v, n, mw, 8), dtype=torch.bool, device=dev)
    if table.numel():
        _launch("smooth_cache", dev, center.data_ptr(), color.data_ptr(), tgt_d.data_ptr(), fl.data_ptr(),
                table.data_ptr(), *(o.data_ptr() for o in (*ring, ring_ok)), v, mh, mw, row0, n, step_size)
    return IterCache(
        tap_ax=None, tap_ay=None, tap_d=None, tap_sim=None, wn=None,
        ras=torch.zeros((1, 4), dtype=f32, device=dev),
        ring_dcx=ring[0], ring_dcy=ring[1], ring_d=ring[2], ring_ok=ring_ok,
        cell_table=table, gammas=device_table(tap_gammas(gamma, steps), f32, dev), row0=row0,
    )


def cell_cache(
    ctx: RefineContext, tgt_d: torch.Tensor, *, gamma: float, steps: int, step_size: float,
    rows: tuple[int, int] | None = None,
) -> IterCache:
    """The smoothness cache of one sweep for input disparities ``tgt_d``
    (V, Mh, Mw): the whole map's cell table and tap weights, and the ring
    data of every cell or of the cell rows ``rows`` = (row0, n) of the map
    (whose taps still read the whole map).  ``ras`` is left empty.

    A CUDA ``tgt_d`` launches ``smooth_cache`` once (``ctx``'s centre,
    colour and flatness float32 on that device) and allocates nothing
    T-wide; a CPU one runs :func:`cell_cache_reference`, tap fields and
    all; another device raises."""
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
        raise ValueError(f"d_c has shape {tuple(d_c.shape)}, expected (M, V, rows, Mw)")
    m, v, n, mw = d_c.shape
    table, gammas = cache.cell_table.contiguous(), cache.gammas.contiguous()
    if table.ndim != 4:
        raise ValueError(f"cache.cell_table has shape {tuple(table.shape)}, expected (V, Mh, Mw, {TABLE_ROW})")
    mh, row0, t = table.shape[1], int(cache.row0), gammas.numel()
    _check_rows((row0, n), mh)
    f32 = torch.float32
    if m > 1 and d_c.stride(0) == 0:  # one d row for every move: read it in place
        d_c, d_stride, d_shape = d_c[0].contiguous(), 0, (v, n, mw)
    else:
        d_c, d_stride, d_shape = d_c.contiguous(), v * n * mw, (m, v, n, mw)
    n_c = n_c.contiguous()
    check_input("n_c", n_c, f32, (m, v, n, mw, 3), dev)
    check_input("d_c", d_c, f32, d_shape, dev)
    check_input("cache.cell_table", table, f32, (v, mh, mw, TABLE_ROW), dev)
    check_input("cache.gammas", gammas, f32, (t,), dev)
    if table.data_ptr() % 16:
        raise ValueError("cache.cell_table must be 16-byte aligned (two float4 a row)")
    if t < 1:
        raise ValueError("cache.gammas holds no tap")
    out = torch.empty((m, v, n, mw), dtype=f32, device=dev)
    if out.numel():
        _launch("smooth_moves", dev, table.data_ptr(), gammas.data_ptr(), d_c.data_ptr(), n_c.data_ptr(),
                out.data_ptr(), m, v, mh, mw, row0, n, t, d_stride, alpha)
    return out


def smoothness_moves(
    cache: IterCache, d_c: torch.Tensor, n_c: torch.Tensor, *, alpha: float, score_chunk: int = SCORE_CHUNK,
) -> torch.Tensor:
    """Smoothness scores (M, V, rows, Mw) of candidate planes ``d_c`` (M,
    V, rows, Mw), ``n_c`` (M, V, rows, Mw, 3) of the cells of ``cache``
    (the rows from ``cache.row0``).

    A CUDA ``d_c`` launches ``smooth_moves`` once for all M moves, from the
    cache's table; a CPU one runs :func:`smoothness_moves_reference` in
    ``score_chunk`` batches on its tap fields; another device raises."""
    if route(d_c.device) == "plain":
        return smoothness_moves_reference(cache, d_c, n_c, alpha=alpha, score_chunk=score_chunk)
    return _launch_moves(cache, d_c, n_c, alpha)


def hoisted_divide(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """``num / den`` elementwise by ``smooth_moves``' divide: one reciprocal
    per divisor and the quotient steps per term where both operands lie in
    [2^-60, 2^60] in magnitude, else CUDA's IEEE divide.  On the CPU the
    plain ``num / den``; on a card, float32 of one shape, not counted."""
    if route(num.device) == "plain":
        return num / den
    num, den = num.contiguous(), den.contiguous()
    check_input("den", den, torch.float32, tuple(num.shape), num.device)
    check_input("num", num, torch.float32, tuple(num.shape), num.device)
    out = torch.empty_like(num)
    if out.numel():
        _launch("smooth_divide", num.device, num.data_ptr(), den.data_ptr(), out.data_ptr(), out.numel(),
                count=False)
    return out
