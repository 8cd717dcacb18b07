"""Dense plane-sweep kernel wrapper (port of
``cl_multiview_stereo_tpu/ops/pallas/sweep.py``).

:func:`plane_sweep` launches ``csrc/sweep.cu`` on a CUDA tensor; the plain
twin and the entry point that picks between them are in
``models/plane_sweep.py``.  The host builds the per-(pair, hypothesis)
integer shift tables in double precision (:func:`shift_table`, which the
plain twin uses too), hands the kernel the pairs grouped by reference
view, and cuts the ladder into the chunks whose neighbour slabs the
kernel stages (:func:`chunk_tables`).  All of it goes to the card in one
copy per call (:func:`kernel_tables`).  The TPU's padded channel-planar
slabs (``pad_images``) have no counterpart.

A call may sweep a row window (:class:`RowWindow`): ``lab`` then holds
only a band of each view's rows and the output only some rows, with every
row test on the global row and height, so that a row tile of the image
(``parallel/spatial.spatial_plane_sweep``) gets the whole image's rows
bitwise.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Sequence

import numpy as np
import torch

MAX_RADIUS = 4  # the kernel's shared-memory halo
CHUNK = 8  # hypotheses a chunk holds at most: csrc/sweep.cu kChunk
SPARE = 16  # slab rows and columns beyond a tile's halo: csrc/sweep.cu kSpare
TILE_ROWS = 16  # output rows of a kernel block: csrc/sweep.cu kTileH

# Kernel launches since import (or since the caller reset it): chip_smoke.py
# reads it to show that the sweep path went through the kernel.
LAUNCHES = 0


class RowWindow(NamedTuple):
    """Rows of one call: ``lab`` holds the global rows ``band0 ..
    band0 + Hb - 1`` of an image ``height`` rows high, and the output rows
    are ``out0 .. out0 + out_rows - 1``."""

    height: int
    band0: int
    out0: int
    out_rows: int


def row_reach(
    ladder: Sequence[float], pairs: Sequence[tuple[int, int, int, int]], bl_ratio: float, radius: int
) -> tuple[int, int]:
    """(rows above, rows below) an output row whose reference and clamped
    neighbour rows the sweep reads: the box radius plus the largest
    downward and upward shift, counting the reference's own 0."""
    sy = [shift_window(bl_ratio * d * dvy)[0] for d in ladder for _, _, _, dvy in pairs]
    return max(sy + [0]) + radius, max([-x for x in sy] + [0]) + radius


def check_window(
    win: RowWindow, band_rows: int, ladder, pairs, bl_ratio: float, radius: int
) -> None:
    """Raise unless the band holds every in-image row that the output rows
    read (the kernel and the plain twin read nothing else)."""
    h, band0, out0, ho = win
    if not (0 <= band0 and band_rows >= 1 and band0 + band_rows <= h):
        raise ValueError(f"band rows {band0}..{band0 + band_rows - 1} outside an image of {h} rows")
    if not (0 <= out0 and 0 <= ho and out0 + ho <= h):
        raise ValueError(f"output rows {out0}..{out0 + ho - 1} outside an image of {h} rows")
    if ho == 0:
        return
    up, down = row_reach(ladder, pairs, bl_ratio, radius)
    lo, hi = max(0, out0 - up), min(h - 1, out0 + ho - 1 + down)
    if lo < band0 or hi > band0 + band_rows - 1:
        raise ValueError(
            f"output rows {out0}..{out0 + ho - 1} read rows {lo}..{hi}, but the band holds "
            f"{band0}..{band0 + band_rows - 1}"
        )


def shift_window(c: float) -> tuple[int, int]:
    """(shift, first valid index) of a projection ``i - c`` along one axis.

    The reference truncates the projected coordinate (clcode.cl:1034) and
    rejects it outside ``(-1, n)``, so pixel i reads ``clamp(i - ceil(c))``
    and is valid iff ``floor(c) <= i <= n - 1 + ceil(c)``.  ``c`` is the
    double-precision product the JAX form computes on the host; an f32
    product can land ``ceil`` on another integer."""
    return int(math.ceil(c)), int(math.floor(c))


def shift_table(ladder: Sequence[float], dvx: float, dvy: float, bl_ratio: float) -> list[tuple[int, int, int, int]]:
    """Per hypothesis: (shift y, shift x, first valid y, first valid x)."""
    out = []
    for d in ladder:
        sy, loy = shift_window(bl_ratio * d * dvy)
        sx, lox = shift_window(d * dvx)
        out.append((sy, sx, loy, lox))
    return out


def pair_tables(
    ladder: Sequence[float], pairs: Sequence[tuple[int, int, int, int]], bl_ratio: float, n_views: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(start (V+1,), view (P,), shifts (P, D, 4)) int32: the pairs grouped
    by reference view (CSR, subset order kept within a view) and each
    pair's (sy, sx, loy, lox) per hypothesis."""
    for ref, view, _, _ in pairs:
        if not (0 <= ref < n_views and 0 <= view < n_views):
            raise ValueError(f"pair ({ref}, {view}) names a view outside 0..{n_views - 1}")
    order = sorted(range(len(pairs)), key=lambda i: pairs[i][0])
    counts = np.bincount(np.asarray([p[0] for p in pairs], np.int64), minlength=n_views)
    start = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    view = np.asarray([pairs[i][1] for i in order], np.int32)
    shifts = np.asarray(
        [shift_table(ladder, pairs[i][2], pairs[i][3], bl_ratio) for i in order], np.int64
    ).reshape(len(pairs), len(ladder), 4)
    if np.abs(shifts).max(initial=0) >= 2**31:
        raise ValueError("a shift does not fit int32")
    return start, view, shifts.astype(np.int32)


def chunk_tables(shifts: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(bounds (C+1,), box (P, C, 4)) int32: the kernel's hypothesis chunks.

    ``shifts`` is :func:`pair_tables`' (P, D, 4).  The ladder, in its own
    order, is cut into chunks of at most CHUNK consecutive hypotheses; a
    chunk closes early where, for some pair, the spread (max - min) of sy
    or sx over it would exceed SPARE.  ``box`` holds each (pair,
    chunk)'s (max sy, max sx, min sy, min sx): a tile at (y0, x0) with box
    radius r stages its slab from row y0 - r - max sy and column x0 - r -
    max sx, and reads hypothesis d at slab row (y - sy) - row0, column
    (x - sx) - col0."""
    n_pairs, n_d = shifts.shape[:2]
    s = shifts[..., :2].astype(np.int64)
    bounds = [0]
    while bounds[-1] < n_d:
        start = bounds[-1]
        lo = hi = s[:, start]
        end = start + 1
        while end < n_d and end - start < CHUNK:
            lo_next, hi_next = np.minimum(lo, s[:, end]), np.maximum(hi, s[:, end])
            if (hi_next - lo_next > SPARE).any():
                break
            lo, hi, end = lo_next, hi_next, end + 1
        bounds.append(end)
    box = np.zeros((n_pairs, len(bounds) - 1, 4), np.int32)
    for c, (a, b) in enumerate(zip(bounds, bounds[1:])):
        box[:, c, :2] = s[:, a:b].max(1)
        box[:, c, 2:] = s[:, a:b].min(1)
    return np.asarray(bounds, np.int32), box


def kernel_tables(
    ladder: Sequence[float], pairs: Sequence[tuple[int, int, int, int]], bl_ratio: float, n_views: int
) -> tuple[np.ndarray, dict[str, int]]:
    """Every table the kernel reads, packed into one int32 array (the ladder
    as float32 bits), and each table's offset in it, in entries."""
    start, view, shifts = pair_tables(ladder, pairs, bl_ratio, n_views)
    bounds, box = chunk_tables(shifts)
    parts = dict(start=start, view=view, shifts=shifts,
                 ladder=np.asarray(ladder, np.float32).view(np.int32), bounds=bounds, box=box)
    offsets = np.cumsum([0] + [a.size for a in parts.values()])
    return np.concatenate([a.reshape(-1) for a in parts.values()]), dict(zip(parts, offsets.tolist()))


def plane_sweep(
    lab: torch.Tensor,  # (V, H, W, 3) float32 on CUDA, contiguous
    ladder: Sequence[float],
    pairs: Sequence[tuple[int, int, int, int]],
    bl_ratio: float,
    window_radius: int = 2,
    rows: RowWindow | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the sweep kernel: (disp, cost), each (V, H, W) float32, or
    (V, out_rows, W) for a row window ``rows`` (:class:`RowWindow`)."""
    global LAUNCHES
    from cl_multiview_stereo_tpu_torch.kernels.build import load

    if lab.device.type != "cuda":
        raise ValueError(f"the sweep kernel needs a CUDA tensor, got one on {lab.device}")
    if lab.dtype != torch.float32:
        raise TypeError(f"lab must be float32, got {lab.dtype}")
    if lab.dim() != 4 or lab.shape[3] != 3:
        raise ValueError(f"lab has shape {tuple(lab.shape)}, expected (V, H, W, 3)")
    if not lab.is_contiguous():
        raise ValueError("lab must be contiguous")
    if not 0 <= window_radius <= MAX_RADIUS:
        raise ValueError(f"window_radius {window_radius} outside 0..{MAX_RADIUS}")
    v, hb, w = lab.shape[:3]
    ladder = [float(d) for d in ladder]
    win = RowWindow(hb, 0, 0, hb) if rows is None else RowWindow(*(int(x) for x in rows))
    check_window(win, hb, ladder, pairs, bl_ratio, window_radius)
    dev = lab.device
    band0 = win.band0
    if rows is not None:
        # the kernel's blocks keep the whole image's tiles of TILE_ROWS: the
        # first and last block of a window stage rows beyond the output
        # rows' reach; give the band zero rows there (only outputs outside
        # the window read them)
        up, down = row_reach(ladder, pairs, bl_ratio, window_radius)
        first = max(0, win.out0 // TILE_ROWS * TILE_ROWS - up)
        last = min(win.height - 1, -(-(win.out0 + win.out_rows) // TILE_ROWS) * TILE_ROWS - 1 + down)
        top, bottom = max(0, band0 - first), max(0, last - (band0 + hb - 1))
        if top or bottom:
            lab = torch.cat([lab.new_zeros((v, top, w, 3)), lab, lab.new_zeros((v, bottom, w, 3))], dim=1)
            band0, hb = band0 - top, hb + top + bottom
    packed, at = kernel_tables(ladder, pairs, bl_ratio, v)

    lib = load("sweep")
    fn = lib.sweep_launch
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    disp = torch.empty((v, win.out_rows, w), dtype=torch.float32, device=dev)
    cost = torch.empty((v, win.out_rows, w), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        # one copy from pinned memory, ordered on the stream before the launch
        tables = torch.from_numpy(packed).pin_memory().to(dev, non_blocking=True)
        ptr = {k: tables.data_ptr() + 4 * off for k, off in at.items()}
        n_chunks = at["box"] - at["bounds"] - 1  # bounds holds C + 1 entries
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(
            lab.data_ptr(), ptr["start"], ptr["view"], ptr["shifts"], ptr["ladder"],
            ptr["bounds"], ptr["box"], disp.data_ptr(), cost.data_ptr(),
            v, win.height, w, len(ladder), window_radius, n_chunks,
            band0, hb, win.out0, win.out_rows, stream,
        )
    if rc != 0:
        raise RuntimeError(f"sweep kernel launch failed with CUDA error {rc}")
    LAUNCHES += 1
    return disp, cost
