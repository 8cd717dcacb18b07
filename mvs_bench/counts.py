"""Bytes and float operations each operation of the depth pipeline needs
for one scene, counted from the operation's own inputs and outputs at the
cell's shapes and data, and the least time they take on an H100.

The least time is the larger of the bytes over the memory rate and the
operations over the float32 rate (NVIDIA's data sheet, H100 SXM: 3.35
TB/s, 67 TFLOP/s outside the tensor cores).  Each input is counted read
once and each output written once, whatever an implementation reads
again.  The per-term operation costs are the port's ``tools/roofline.py``
constants; where that tool counts a table that exists only in today's
design (the consistency kernel's rasterized state, the smoothness cell
table and ring, the move chain's masks and similarities), the operation
here counts what it reads and writes instead, so a share reads the same
work whatever implements it.  Each function's docstring says what it
counts.

:func:`scene_work` gives every operation's (bytes, operations) for one
scene; :data:`KERNELS` names the device kernels whose time each one owns.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mvs_bench import reference as ref

PEAK_BYTES_S, PEAK_F32_S = 3.35e12, 67e12
# f32 operations a term: a valid cost-volume sample (3 differences, 3
# absolutes, 2 adds, the running sum); a consistency (move, cell, pair,
# sample) term 36 and its plane disparity per (move, cell, view, sample) 8;
# a SLIC candidate 18, a member pixel 5, a cluster 59; a smoothness (cell,
# tap) similarity 14 and a (move, cell, tap) term 12; a rasterized pixel 8;
# a move candidate 19, an accept test 3 (5 under the greedy rule), a refit
# normal 20, a ring entry 2; a Lab pixel 33
CV_OPS_VALID, CONS_OPS_TERM, CONS_OPS_DIP = 9, 36, 8
SLIC_OPS_CAND, SLIC_OPS_MEMBER, SLIC_OPS_CLUSTER = 18, 5, 59
SMOOTH_OPS_TAP, SMOOTH_OPS_TERM, RASTER_OPS_PIXEL = 14, 12, 8
CHAIN_OPS_MOVE, CHAIN_OPS_ACCEPT, CHAIN_OPS_GREEDY, CHAIN_OPS_REFIT, RING_OPS = 19, 3, 5, 20, 2
LAB_OPS_PIXEL = 33
SECTOR = 32  # bytes of a device memory sector, the unit a gather reads in

# the device kernels (names as the profiler gives them, before the
# template arguments) whose time each operation owns
KERNELS = {
    "lab": ("lab_kernel",),
    "slic": ("assign_kernel", "update_partial_kernel", "update_finalize_kernel"),
    "extent": ("extent_kernel",),
    "cost_volume": ("cost_volume_kernel",),
    "consistency": ("consistency_kernel",),
    "smoothness": ("smooth_cache_kernel", "smooth_moves_kernel"),
    "chain": ("chain_moves_kernel", "chain_update_kernel", "chain_refit_kernel"),
    "raster": ("raster_kernel",),
}


class Shapes(NamedTuple):
    """The sizes of one scene of a cell."""

    v: int
    h: int
    w: int
    mh: int
    mw: int
    levels: int
    pairs: int  # (reference view, neighbour view) pairs of the refinement
    moves: tuple  # update moves of each sweep
    taps: tuple  # smoothness taps of the init and of each sweep
    valid_moves: tuple  # (move, cell) with the neighbour on the map, each sweep
    valid_refits: int  # (refit, cell) with both ring neighbours on the map
    spixl: int
    no_iter: int


def shapes(st: ref.Settings, v: int, h: int, w: int) -> Shapes:
    """The cell's sizes from its settings and capture shape."""
    mw, mh = ref.map_size(w, h, st.spixl_size)
    sc = ref.schedule(st)
    offs = [ref.update_move_offsets(sc.steps_per_iter[i], sc.step_size_per_iter[i], mw, mh)
            for i in range(st.no_prop)]
    valid = tuple(sum((mw - abs(dx)) * (mh - abs(dy)) * v for dx, dy in o) for o in offs)
    ring = ref._RING
    refits = sum(_on_map(mw, mh, ring[r], ring[(r + 1) % 8]) for r in range(8)) * v
    pairs = len(ref.pairs_from_subsets(ref.view_subsets(st)[0], st.array_width))
    taps = tuple(8 + 4 * k for k in (sc.kernel_steps, *sc.steps_per_iter))
    return Shapes(v, h, w, mh, mw, len(ref.disp_levels(st)), pairs, tuple(len(o) for o in offs), taps,
                  valid, refits, st.spixl_size, st.no_iter)


def _on_map(mw: int, mh: int, a: tuple, b: tuple) -> int:
    """Cells whose two ring neighbours at offsets ``a`` and ``b`` both lie
    on an mh x mw map."""
    xs = [x for x in range(mw) if 0 <= x + a[0] < mw and 0 <= x + b[0] < mw]
    ys = [y for y in range(mh) if 0 <= y + a[1] < mh and 0 <= y + b[1] < mh]
    return len(xs) * len(ys)


def least_ms(n_bytes: float, n_ops: float) -> float:
    """The least ms the card takes for ``n_bytes`` and ``n_ops``."""
    return max(n_bytes / PEAK_BYTES_S, n_ops / PEAK_F32_S) * 1e3


def lab(s: Shapes) -> tuple[int, int]:
    """The uint8 capture read once (3 bytes a pixel), the float32 Lab image
    written once (12); LAB_OPS_PIXEL a pixel."""
    px = s.v * s.h * s.w
    return 15 * px, LAB_OPS_PIXEL * px


def slic_candidates(s: Shapes) -> int:
    """Candidate clusters on the map, summed over one view's pixels (four a
    pixel, picked with the column and row parity swapped)."""
    col, row = np.arange(s.w)[None, :], np.arange(s.h)[:, None]
    dxp, dyp = (col % s.spixl + s.spixl // 2) // s.spixl, (row % s.spixl + s.spixl // 2) // s.spixl
    total = 0
    for i_off in (-1, 0):
        for j_off in (-1, 0):
            qy, qx = row // s.spixl + dxp + i_off, col // s.spixl + dyp + j_off
            total += int(((qy >= 0) & (qy < s.mh) & (qx >= 0) & (qx < s.mw)).sum())
    return total


def slic_members(labels: torch.Tensor, s: Shapes) -> int:
    """Pixels an update adds to a cluster: a label on the map at most one
    cell from the pixel's home cell."""
    lbl = labels.to(torch.int64)
    home_y = torch.arange(s.h, device=lbl.device)[:, None] // s.spixl
    home_x = torch.arange(s.w, device=lbl.device)[None, :] // s.spixl
    near = ((lbl.div(s.mw, rounding_mode="floor") - home_y).abs() <= 1) & ((lbl % s.mw - home_x).abs() <= 1)
    return int(((lbl >= 0) & (lbl < s.mh * s.mw) & near).sum())


def slic(s: Shapes, members: int) -> tuple[int, int]:
    """``no_iter + 1`` assignments, each reading the Lab image (12 bytes a
    pixel) and the (x, y, L, a, b) clusters (20 bytes) and writing the
    int32 labels; ``no_iter`` updates, each reading Lab and labels and
    writing centre, colour and count (24 bytes a cluster).  ``members``:
    :func:`slic_members` of the scene's labels, for every update."""
    px, clusters = s.v * s.h * s.w, s.v * s.mh * s.mw
    assign = (16 * px + 20 * clusters, SLIC_OPS_CAND * s.v * slic_candidates(s))
    update = (16 * px + 24 * clusters, SLIC_OPS_MEMBER * members + SLIC_OPS_CLUSTER * clusters)
    k = s.no_iter
    return (k + 1) * assign[0] + k * update[0], (k + 1) * assign[1] + k * update[1]


def extent_sectors(labels_shape: tuple, centers: torch.Tensor, spixl: int) -> int:
    """The SECTOR-byte sectors of the int32 label map that hold a pixel of
    some superpixel's 8 rays inside its view, from its clamped centre."""
    v, h, w = labels_shape
    cx, cy = ref.clamp_center(centers[..., 0].to(torch.int64), centers[..., 1].to(torch.int64), w, h, spixl)
    base = (torch.arange(v, dtype=torch.int64, device=centers.device) * h * w).reshape(v, 1, 1)
    per = SECTOR // 4
    touched = torch.zeros(-(-v * h * w // per), dtype=torch.bool, device=centers.device)
    for i in range(1, spixl):
        for dx, dy in ref._DIRS:
            px, py = cx + i * dx, cy + i * dy
            inb = (px >= 0) & (py >= 0) & (px < w) & (py < h)
            touched[((base + py * w + px)[inb]) // per] = True
    return int(touched.sum())


def extent(s: Shapes, sectors: int) -> tuple[int, int]:
    """The label sectors the rays read (:func:`extent_sectors`), the
    centres read (8 bytes a cell) and the int32 extent written (32); no
    float arithmetic."""
    return SECTOR * sectors + 40 * s.v * s.mh * s.mw, 0


def cost_volume_terms(centers, step, levels: torch.Tensor, s: Shapes, st: ref.Settings) -> tuple[int, int]:
    """(valid sample terms, (view, delta) pairs): a term is one (pair, cell,
    sample, hypothesis), valid where the truncated sample lies in the
    image and -1 < x - d·gx < W, -1 < y - (bl·d)·gy < H."""
    h, w, v = s.h, s.w, s.v
    xr = torch.stack([(centers[..., 0] + float(i) * step[..., 0]).to(torch.int64) for i in range(-2, 3)], -1)
    yr = torch.stack([(centers[..., 1] + float(j) * step[..., 1]).to(torch.int64) for j in range(-2, 3)], -1)
    x_in = ((xr >= 0) & (xr < w))[..., None]
    y_in = ((yr >= 0) & (yr < h))[..., None]
    bl_d = levels * float(np.float32(st.bl_ratio))
    valid = pairs = 0
    for gx in range(-st.neib_hor, st.neib_hor + 1):
        for gy in range(-st.neib_ver, st.neib_ver + 1):
            if gx == 0 and gy == 0:
                continue
            views = [z for z in range(v) if 0 <= z % st.array_width + gx < st.array_width
                     and 0 <= z // st.array_width + gy < v // st.array_width]
            if not views:
                continue
            pairs += len(views)
            px = xr[views].to(torch.float32)[..., None] - levels * float(gx)
            py = yr[views].to(torch.float32)[..., None] - bl_d * float(gy)
            nx = (x_in[views] & (px > -1.0) & (px < w)).sum(3)
            ny = (y_in[views] & (py > -1.0) & (py < h)).sum(3)
            valid += int((nx * ny).sum())
    return valid, pairs


def cost_volume(s: Shapes, valid: int, pairs: int) -> tuple[int, int]:
    """Lab (12 bytes a pixel), centres and sample steps (16 bytes a cell)
    and the ladder read once, the (V, D, Mh, Mw) volume written once;
    CV_OPS_VALID a valid term (:func:`cost_volume_terms`), 1 (the penalty's
    add) an invalid one, one min a (pair, cell, hypothesis)."""
    cells = s.mh * s.mw
    terms = 25 * s.levels * cells * pairs
    n_bytes = 12 * s.v * s.h * s.w + 16 * s.v * cells + 4 * s.levels + 4 * s.v * s.levels * cells
    return n_bytes, CV_OPS_VALID * valid + (terms - valid) + s.levels * cells * pairs


def _launches(s: Shapes) -> list[tuple[int, int]]:
    """(moves scored, whether the planes' d is one row) of each scoring
    launch: the init's one, then each sweep's update moves and 8 refits."""
    out = [(1, False)]
    for m in s.moves:
        out += [(m, False), (8, True)]
    return out


def consistency(s: Shapes) -> tuple[int, int]:
    """Per scoring launch: the cell maps read (centre 8, colour 12, sample
    offsets 72, flatness 8, the frozen state's d and n 16 bytes a cell), the
    int32 labels that say which cell a projected pixel shows, the candidate
    planes (d 4 bytes a (move, cell), once where all moves share it; n 12)
    and the scores written (4); CONS_OPS_TERM a (move, cell, pair, sample)
    and CONS_OPS_DIP a (move, cell, view, sample).  The port's count reads a
    rasterized state table instead of the labels: an intermediate."""
    cells = s.v * s.mh * s.mw
    n_bytes = n_ops = 0
    for m, one_d in _launches(s):
        n_bytes += 116 * cells + 4 * s.v * s.h * s.w + 4 * cells * (1 if one_d else m) + 16 * m * cells
        n_ops += m * s.mh * s.mw * 9 * (s.pairs * CONS_OPS_TERM + s.v * CONS_OPS_DIP)
    return n_bytes, n_ops


def smoothness(s: Shapes) -> tuple[int, int]:
    """Per sweep (and the init): the cell inputs read once (centre, colour,
    d and flatness, 28 bytes a cell), SMOOTH_OPS_TAP a (cell, tap) for the
    taps' weights; per scoring launch the candidate planes read (as
    :func:`consistency`) and the scores written, SMOOTH_OPS_TERM a (move,
    cell, tap).  The port's count adds the weights on every launch and the
    ring the cache writes: neither is the operation's."""
    cells = s.v * s.mh * s.mw
    n_bytes = 28 * cells * len(s.taps)
    n_ops = sum(SMOOTH_OPS_TAP * cells * t for t in s.taps)
    launches = _launches(s)
    tap_of = [s.taps[0]] + [t for t in s.taps[1:] for _ in range(2)]
    for (m, one_d), t in zip(launches, tap_of):
        n_bytes += 4 * cells * (1 if one_d else m) + 16 * m * cells
        n_ops += SMOOTH_OPS_TERM * m * cells * t
    return n_bytes, n_ops


def chain(s: Shapes) -> tuple[int, int]:
    """Per sweep, the move chain as one operation: the cell map read
    (centre 8, colour 12, d 4, n 12, sm 4, cs 4 bytes a cell), each valid
    move's and refit's two scores read (8 bytes), the candidates written for
    the scorers (d and n, 16 bytes a (move, cell)), the refit normals (12 a
    (refit, cell)) and the new state (32 a cell); CHAIN_OPS_MOVE a (move,
    cell), an accept test a valid move and refit, CHAIN_OPS_REFIT a (refit,
    cell), RING_OPS a (cell, ring neighbour).  The port's three counts add
    the masks, similarities and ring that the kernels hand each other."""
    cells = s.v * s.mh * s.mw
    n_bytes = n_ops = 0
    for it, (m, valid) in enumerate(zip(s.moves, s.valid_moves)):
        accept = CHAIN_OPS_GREEDY if it < 4 else CHAIN_OPS_ACCEPT
        n_bytes += 44 * cells + 8 * (valid + s.valid_refits) + 16 * m * cells + 96 * cells + 32 * cells
        n_ops += (CHAIN_OPS_MOVE * m * cells + accept * (valid + s.valid_refits) + CHAIN_OPS_REFIT * 8 * cells
                  + RING_OPS * 8 * cells)
    return n_bytes, n_ops


def raster(s: Shapes) -> tuple[int, int]:
    """Seven rasterizations a scene (the init's and each sweep's state
    table, fusion's maps): the int32 labels and the cell planes (centre, d,
    n: 24 bytes a cell) read, for a table also each pixel's colour (12
    bytes), and the table (16 bytes a pixel) or the map (4) written;
    RASTER_OPS_PIXEL a pixel."""
    px, cells = s.v * s.h * s.w, s.v * s.mh * s.mw
    tables = 1 + len(s.moves)
    per_table = 4 * px + 24 * cells + 12 * px + 16 * px
    per_map = 4 * px + 24 * cells + 4 * px
    return tables * per_table + per_map, (tables + 1) * RASTER_OPS_PIXEL * px


def scene_work(st: ref.Settings, out: ref.Outputs) -> dict[str, tuple[int, int]]:
    """(bytes, operations) of every operation of :data:`KERNELS` for the
    scene whose reference outputs are ``out``."""
    v, h, w = out.labels.shape
    s = shapes(st, v, h, w)
    levels = torch.as_tensor(ref.disp_levels(st), device=out.center.device)
    valid, pairs = cost_volume_terms(out.center, ref.extent_step(out.extent), levels, s, st)
    return {
        "lab": lab(s),
        "slic": slic(s, slic_members(out.labels, s)),
        "extent": extent(s, extent_sectors(tuple(out.labels.shape), out.center, s.spixl)),
        "cost_volume": cost_volume(s, valid, pairs),
        "consistency": consistency(s),
        "smoothness": smoothness(s),
        "chain": chain(s),
        "raster": raster(s),
    }
