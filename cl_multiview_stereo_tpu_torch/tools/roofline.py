"""Each hand kernel's time against the least time the card could take for
the same work (port of the JAX package's ``tools/roofline.py``).

A kernel's bound is the larger of two times: the bytes it must move (each
input read once, each output written once) over the card's memory rate,
and the f32 operations it does on these inputs over the card's f32 peak.
Each kernel has one work function that counts (bytes, operations) from its
real inputs: :func:`cost_volume_work`, :func:`sweep_work`,
:func:`consistency_work`, for SLIC's three kernels :func:`slic_work`, and
for smoothness's two :func:`smooth_cache_work` and :func:`smooth_moves_work`,
for the plane rasterization :func:`raster_work`, for the move chain's
three :func:`chain_moves_work`, :func:`chain_update_work` and
:func:`chain_refit_work`, for the Lab conversion and the superpixel
extent :func:`lab_work` and :func:`extent_work`, and for the cross-check's
warp and vote and the seeds' edge snap :func:`fuse_warp_work`,
:func:`fuse_vote_work` and :func:`edge_snap_work`.
``chip_smoke.py`` and this tool both use them, so a kernel's roofline
share reads the same work whatever implements it.
:func:`gather_work` counts the row gathers of ``tools.profile_propagate``'s
gather-rate ladder the same way.

Usage:

  python -m cl_multiview_stereo_tpu_torch.tools.roofline \\
      [--kernel all|cost_volume|sweep|consistency|slic_assign|slic_update|slic_vote|smooth_cache|smooth_moves|
                raster_planes|chain_moves|chain_update|chain_refit|lab_convert|extent_walk|fuse_warp|fuse_vote|
                edge_snap] \\
      [--shapes main|row] [--calls sweep0|path] [--csrc DIR] [--view-range FIRST,COUNT] \\
      [--views 2 --height 480 --width 640 --d 64] [--device cuda|cpu]

``--shapes main`` is the slice's scene: 9 views of 1080x1920 at
``SystemSettings()`` (31 hypotheses, 40 pairs; the consistency kernel on
sweep 0's two calls of the gather engine, the main path's launches; the
SLIC kernels on the scene's converged labels and map, the vote on both of
``segment``'s launches under ``enforce_connectivity`` (:func:`vote_rounds`:
round 1 on the converged labels, round 2 on round 1's output); the
smoothness kernels on sweep 0's cache and its two calls, the main path's
launches; the raster and chain kernels on sweep 0's table, candidates and
two accept walks; the Lab conversion on the scene's uint8 views and the
extent on its converged labels and map; the cross-check's warp and vote on the slice's refined
disparity, ``MVSPipeline.run``'s ``disp_full``, the vote on that map's
warp; the edge snap on the scene's Lab and SLIC's seed centres).
``--shapes row`` is the JAX tool's case: ``--views`` views in one row,
``--height`` x ``--width``, the ladder 4 .. 3 + ``--d``; the sweep there
reads random Lab with each view against its right and left neighbour.  Without ``--shapes`` the sweep takes
``row`` (2x480x640, D = 64: BASELINE config 1) and the others ``main``.
``--kernel`` repeats (``--kernel fuse_warp --kernel fuse_vote``).
``--calls path`` takes the raster and chain kernels on every call of the
main path instead of sweep 0's: ``raster_planes`` on the init's table,
sweeps 0-4's tables and fusion's map (7 launches), each chain kernel on
sweeps 0-4 (5), each sweep run from the initial state.  ``--csrc DIR``
builds every kernel from the sources in DIR (e.g. an unpacked parent
commit's ``cl_multiview_stereo_tpu_torch/csrc``, whose C entries must be
this tree's), so two kernels' versions are timed on the same calls.
``--view-range FIRST,COUNT`` runs ``fuse_warp`` and ``fuse_vote`` on those
reference views only, as a rank of the view-sharded path does.

Each kernel and its plain twin run once, then their times are taken with
CUDA events in turns (kernel, plain, kernel, plain).  Prints one JSON line
per kernel: ``kernel``, ``shape``, ``ms``, ``plain_ms``, ``bound_ms``,
``bound_by``, ``share`` (= bound_ms / ms) and ``card`` (nvidia-smi's name
and power limit), the sums over the kernel's launches, and ``calls``: each
launch's ``call``, ``ms``, ``plain_ms``, ``bound_ms`` and ``share``
(``fuse_vote``'s also each walk's operations and bound and the counts of
:func:`fuse_vote_work`; its ``bound_ms`` is the lesser).  With ``--device
cpu`` nothing is timed: ``ms``, ``plain_ms`` and ``share`` read "not
measured" and ``card`` "cpu".
"""

from __future__ import annotations

import argparse
import json
import math

import numpy as np
import torch

# H100 SXM peaks for a kernel's bound (NVIDIA's data sheet, dense, f32
# outside the tensor cores)
PEAK_BYTES_S, PEAK_F32_S = 3.35e12, 67e12
# f32 operations the bounds count: a valid cost-volume sample term (three
# differences, three absolutes, two adds, the running sum); a sweep
# (pair, hypothesis, pixel) term is 8 for the SAD, 4r for the separable
# box sums and 1 for the min over pairs; a consistency (move, cell, pair,
# sample) term is about 36 (projection, bounds, the two exp terms and five
# sums, each exp counted as one) and its plane disparity per (move, cell,
# sample) 8
CV_OPS_VALID, SWEEP_OPS_SAD, CONS_OPS_TERM, CONS_OPS_DIP = 9, 8, 36, 8
# SLIC: a candidate cluster inside the map costs 18 (the colour and space
# distances, the weighted sum, the sqrt and the compare; about 72 a pixel);
# a member pixel of the update 5 adds, each cluster 9 x 6 adds of the
# partials and 5 divides; an interior pixel of the vote 25 compares and 25
# adds, counted at the f32 rate
SLIC_OPS_CAND, SLIC_OPS_MEMBER, SLIC_OPS_CLUSTER, SLIC_OPS_VOTE = 18, 5, 59, 50
# smoothness: a (cell, tap) similarity costs 14 (the colour distance's 8,
# the weight's product and exp, the two centre differences, the add into
# wn), a ring entry 2; a move's (cell, tap) term 12 (the plane's 3
# products, 2 adds and divide, the difference, the weight's 2 products and
# exp, the product and the add), each exp counted as one
SMOOTH_OPS_TAP, SMOOTH_OPS_RING, SMOOTH_OPS_TERM = 14, 2, 12
# the plane rasterization: a pixel's plane costs 8 (two differences, three
# products, two adds, the divide); the move chain: a candidate (move, cell)
# 19 (the plane's 8, the colour distance's 8, the weight's product,
# negation and exp), an accept test 3 under the product rule (two products,
# the compare) and 5 under the greedy rules (another product and compare),
# a refit normal 20 (two differences, the cross product's 9, the norm's 6,
# three divides), the sqrt and each exp counted as one
RASTER_OPS_PIXEL, CHAIN_OPS_MOVE, CHAIN_OPS_ACCEPT, CHAIN_OPS_GREEDY, CHAIN_OPS_REFIT = 8, 19, 3, 5, 20
# the Lab conversion: a pixel costs 33 (3 scalings, the matrix's 9 products
# and 6 adds, 3 white-point products, each f()'s compare and cube root, L's
# 2, a's 2 and b's 2), each cube root counted as one; the extent walk does
# no float arithmetic (integer bounds tests and label compares)
LAB_OPS_PIXEL = 33
# the cross-check: a warp probe costs 16 (the shift's 3 products, two
# OpenCL rounds at 3 (the compare, the add, the floor), 2 differences, 4
# bounds compares, the max's compare); the vote's take tests 4 a (candidate,
# output), and a candidate it looks at costs 1 (bl * d) and 5 an agreement
# term (a difference, an absolute, 2 compares, the add), a lookup it makes
# 23 (2 grid differences, 2 products, 2 rounds, 2 differences, 4 bounds
# compares, a difference, an absolute, 2 compares, the add, the 2 tests
# whether the sign is settled); the edge snap's Sobel
# magnitude costs 60 a pixel (a channel's DX and DY 8 each, its square sum
# 3; 2 channel adds; the sqrt as one), its ring scan 1 a neighbour in the view
FUSE_OPS_PROBE, FUSE_OPS_TAKE, FUSE_OPS_AGREE, FUSE_OPS_LOOKUP = 16, 4, 5, 23
EDGE_OPS_PIXEL, EDGE_OPS_RING = 60, 1
# the bytes of one device memory sector, the unit a gather reads rows in
SECTOR = 32
# the card's SMs, warp schedulers an SM (each issues one warp instruction a
# clock) and lanes a warp (H100 SXM), for issue_ms
SMS, SCHEDULERS, WARP = 132, 4, 32
# CUDA-event iterations of (kernel, plain twin) in each of the two turns
ITERS = {"cost_volume": (10, 2), "sweep": (3, 1), "consistency": (10, 1),
         "slic_assign": (20, 2), "slic_update": (20, 1), "slic_vote": (20, 2),
         "smooth_cache": (10, 1), "smooth_moves": (10, 1),
         "raster_planes": (20, 2), "chain_moves": (20, 2), "chain_update": (20, 1), "chain_refit": (20, 2),
         "lab_convert": (20, 1), "extent_walk": (20, 1), "fuse_warp": (20, 1), "fuse_vote": (10, 1),
         "edge_snap": (20, 2)}
SLIC_KERNELS = ("slic_assign", "slic_update", "slic_vote")
SMOOTH_KERNELS = ("smooth_cache", "smooth_moves")
CHAIN_KERNELS = ("raster_planes", "chain_moves", "chain_update", "chain_refit")
FUSION_KERNELS = ("fuse_warp", "fuse_vote")
KERNELS = tuple(ITERS)
NOT_MEASURED = "not measured"
# device clock cycles cuda_ms spins before its window: about 5 ms, longer
# than the host takes to queue a window of the kernels' calls
QUEUE_CYCLES = 10_000_000


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """The least ms the card could take, and what bounds it: the larger of
    the bytes over the memory rate and the operations over the f32 peak."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S * 1e3, n_ops / PEAK_F32_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def issue_ms(instructions_per_item: float, items: int, clock_ghz: float) -> float:
    """The least ms the card takes to issue ``items`` items' SASS
    instructions, ``instructions_per_item`` on the lane that runs each item
    (32 items a warp instruction), at one warp instruction a clock on each
    of SMS x SCHEDULERS schedulers at ``clock_ghz``.  A note beside
    :func:`bound`, which it does not change."""
    return instructions_per_item * items / WARP / (SMS * SCHEDULERS * clock_ghz * 1e9) * 1e3


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def distinct_bytes(t) -> int:
    """The bytes of ``t``'s distinct elements: a broadcast (stride-0) axis
    counts once, as a kernel that takes its stride reads it."""
    return math.prod(n for n, st in zip(t.shape, t.stride()) if st != 0) * t.element_size()


def cost_volume_terms(centers, step, levels, h: int, w: int, settings) -> tuple[int, int]:
    """(valid sample terms, pairs) of the cost volume on these inputs: a
    term is one (pair, cell, sample, hypothesis), valid as the kernel
    tests it: the f32 sample positions, truncated, in the image, and
    -1 < x - d*gx < W, -1 < y - (bl*d)*gy < H."""
    s = settings
    v = centers.shape[0]
    xr = torch.stack([(centers[..., 0] + float(i) * step[..., 0]).to(torch.int64) for i in range(-2, 3)], -1)
    yr = torch.stack([(centers[..., 1] + float(j) * step[..., 1]).to(torch.int64) for j in range(-2, 3)], -1)
    x_in = ((xr >= 0) & (xr < w))[..., None]  # (V, Mh, Mw, 5, 1)
    y_in = ((yr >= 0) & (yr < h))[..., None]
    bl_d = levels * float(np.float32(s.bl_ratio))
    valid_terms = pairs = 0
    for gx in range(-s.neib_hor, s.neib_hor + 1):
        for gy in range(-s.neib_ver, s.neib_ver + 1):
            if gx == 0 and gy == 0:
                continue
            views = [z for z in range(v) if 0 <= z % s.array_width + gx < s.array_width
                     and 0 <= z // s.array_width + gy < v // s.array_width]
            if not views:
                continue
            pairs += len(views)
            px = xr[views].to(torch.float32)[..., None] - levels * float(gx)  # (n, Mh, Mw, 5, D)
            py = yr[views].to(torch.float32)[..., None] - bl_d * float(gy)
            nx = (x_in[views] & (px > -1.0) & (px < w)).sum(3)  # (n, Mh, Mw, D)
            ny = (y_in[views] & (py > -1.0) & (py < h)).sum(3)
            valid_terms += int((nx * ny).sum())
    return valid_terms, pairs


def cost_volume_work(lab, centers, step, levels, settings, out) -> tuple[int, int]:
    """(bytes, operations) of the cost volume ``out`` from these inputs:
    each input read once and the output written once; per sample term
    CV_OPS_VALID operations where the sample is valid and 1 (the penalty's
    add) where not, and one min per (cell, hypothesis, pair)."""
    h, w = lab.shape[1:3]
    cells = centers.shape[1] * centers.shape[2]
    n_d = levels.shape[0]
    valid_terms, pairs = cost_volume_terms(centers, step, levels, h, w, settings)
    terms = 25 * n_d * cells * pairs
    ops = CV_OPS_VALID * valid_terms + (terms - valid_terms) + n_d * cells * pairs
    return nbytes(lab, centers, step, levels, out), ops


def sweep_work(lab, ladder, pairs, bl_ratio: float, radius: int = 2, rows: int | None = None) -> tuple[int, int]:
    """(bytes, operations) of one sweep launch on ``lab`` (the whole image,
    or a row window's band with ``rows`` output rows): the input and the
    kernel's tables read once, disp and cost written once; per (pair,
    hypothesis, output pixel) the SAD, the box sums and the min over pairs,
    per (view, hypothesis, output pixel) the WTA compare."""
    from cl_multiview_stereo_tpu_torch.ops import sweep

    v, h, w = lab.shape[:3]
    rows = h if rows is None else rows
    ladder = [float(d) for d in ladder]
    ops = (len(pairs) * (SWEEP_OPS_SAD + 4 * radius + 1) + v) * len(ladder) * rows * w
    tables = sweep.kernel_tables(ladder, pairs, bl_ratio, v)[0].nbytes
    return nbytes(lab) + 2 * 4 * v * rows * w + tables, ops


def consistency_work(ctx, cache, d_c, n_c, pairs) -> tuple[int, int]:
    """(bytes, operations) of one consistency launch: every input the
    kernel takes read once (the pair tables' 4 * (V + 1 + 3 * pairs)
    bytes among them) and the (M, V, Mh, Mw) scores written once; every
    (move, cell, pair, sample) term counted valid, at most what the data
    needs (the bytes bound it at the main path's shapes all the same)."""
    m, v, mh, mw = d_c.shape
    ops = m * mh * mw * 9 * (len(pairs) * CONS_OPS_TERM + v * CONS_OPS_DIP)
    n_bytes = nbytes(ctx.center, ctx.color, ctx.samples, ctx.fl, cache.ras, d_c, n_c) + 4 * d_c.numel()
    return n_bytes + 4 * (v + 1 + 3 * len(pairs)), ops


def slic_candidates(h: int, w: int, geom) -> int:
    """The assignment's candidates inside the map, summed over one view's
    pixels (each pixel has four, as ``find_center_association`` picks them)."""
    s, mh, mw = geom.spixl_size, geom.map_h, geom.map_w
    col, row = torch.arange(w)[None, :], torch.arange(h)[:, None]
    dxp, dyp = (col % s + s // 2) // s, (row % s + s // 2) // s
    total = 0
    for i_off in (-1, 0):
        for j_off in (-1, 0):
            qy, qx = row // s + dxp + i_off, col // s + dyp + j_off
            total += int(((qy >= 0) & (qy < mh) & (qx >= 0) & (qx < mw)).sum())
    return total


def slic_members(labels, geom) -> int:
    """Pixels that the update adds to a cluster: a label in [0, Mh*Mw) at
    most one cell from the pixel's home cell."""
    s, mh, mw = geom.spixl_size, geom.map_h, geom.map_w
    h, w = labels.shape[1:3]
    lbl = labels.to(torch.int64)
    home_y = torch.arange(h, device=lbl.device)[:, None] // s
    home_x = torch.arange(w, device=lbl.device)[None, :] // s
    near = ((lbl.div(mw, rounding_mode="floor") - home_y).abs() <= 1) & ((lbl % mw - home_x).abs() <= 1)
    return int(((lbl >= 0) & (lbl < mh * mw) & near).sum())


def slic_work(kernel: str, lab, labels, geom) -> tuple[int, int]:
    """(bytes, operations) of one SLIC launch at ``labels``' shape: the
    assignment reads lab and the (x, y, L, a, b) table and writes the
    labels; the update reads lab and ``labels`` and writes the map's centre,
    colour and count; the vote reads ``labels`` and writes as many."""
    v, h, w = labels.shape
    clusters = v * geom.map_h * geom.map_w
    if kernel == "slic_assign":
        return nbytes(lab, labels) + 4 * 5 * clusters, SLIC_OPS_CAND * v * slic_candidates(h, w, geom)
    if kernel == "slic_update":
        return (nbytes(lab, labels) + 4 * 6 * clusters,
                SLIC_OPS_MEMBER * slic_members(labels, geom) + SLIC_OPS_CLUSTER * clusters)
    if kernel == "slic_vote":
        return 2 * nbytes(labels), SLIC_OPS_VOTE * v * max(h - 4, 0) * max(w - 4, 0)
    raise ValueError(f"no SLIC kernel {kernel!r}; expected one of {SLIC_KERNELS}")


def _cell_input_bytes(v: int, mh: int, mw: int) -> int:
    """The smoothness inputs of a map of cells, each read once: centre (2),
    colour (3), disparity (1) and flatness's first channel (1), float32."""
    return 4 * 7 * v * mh * mw


def smooth_cache_work(ctx, tgt_d, cache) -> tuple[int, int]:
    """(bytes, operations) of one ``smooth_cache`` launch that wrote
    ``cache``, counted as any implementation must do the work: the map's
    cell inputs read once, the ring fields of the cells scored (what the
    move chain reads) written once, SMOOTH_OPS_RING per (cell, ring
    neighbour).  The taps' similarities are the moves' work
    (:func:`smooth_moves_work`), whatever an implementation stores."""
    v, mh, mw = tgt_d.shape
    ring = (cache.ring_dcx, cache.ring_dcy, cache.ring_d, cache.ring_ok)
    return _cell_input_bytes(v, mh, mw) + nbytes(*ring), SMOOTH_OPS_RING * cache.ring_d.numel()


def smooth_moves_work(cache, d_c, n_c) -> tuple[int, int]:
    """(bytes, operations) of one ``smooth_moves`` launch, counted as any
    implementation must do the work: the map's cell inputs read once, the
    (M, ...) moves read once (a broadcast ``d_c``, the refit's one d row,
    once), the (M, V, rows, Mw) scores written once; SMOOTH_OPS_TERM per
    (move, cell, tap) and SMOOTH_OPS_TAP per (cell, tap), T from the tap
    weights ``cache.gammas``."""
    v, mh, mw = cache.cell_table.shape[:3]
    cells, t, m = d_c[0].numel(), cache.gammas.numel(), d_c.shape[0]
    n_bytes = _cell_input_bytes(v, mh, mw) + nbytes(n_c) + distinct_bytes(d_c) + 4 * d_c.numel()
    return n_bytes, SMOOTH_OPS_TERM * m * cells * t + SMOOTH_OPS_TAP * cells * t


def _leaves(x) -> list:
    """The tensors of ``x``, a tensor or a (nested) tuple holding tensors."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for a in x for t in _leaves(a)]
    return []


def raster_work(labels, center, state_d, state_n, ras_color, out) -> tuple[int, int]:
    """(bytes, operations) of one ``raster_planes`` launch that wrote
    ``out``: the labels, the cell maps (centre, disparity, normal) and, for
    the table, ``ras_color`` read once, ``out`` written once;
    RASTER_OPS_PIXEL a pixel."""
    n_bytes = nbytes(labels, center, state_d, state_n, out) + (0 if ras_color is None else nbytes(ras_color))
    return n_bytes, RASTER_OPS_PIXEL * labels.numel()


def chain_moves_work(ctx, state_in, offs, out) -> tuple[int, int]:
    """(bytes, operations) of one ``chain_moves`` launch that wrote ``out``
    (d, n, sim, ok): the map's centre, colour, disparity and normal read
    once, the move table's 8 bytes a move, the candidates written once;
    CHAIN_OPS_MOVE a (move, cell)."""
    n_bytes = nbytes(ctx.center, ctx.color, state_in.d, state_in.n, *out) + 8 * len(offs)
    return n_bytes, CHAIN_OPS_MOVE * out[0].numel()


def chain_update_work(cache, state, moves, sm1, cs1, greedy, out) -> tuple[int, int]:
    """(bytes, operations) of one ``chain_update`` launch that wrote ``out``
    (state, n_ref, ok_ref), counted as this run's data needs: each move's
    ``ok`` read once, its scores (and under the greedy rules its
    similarity) only where it is valid; a cell's d and n once, from the
    state or from its last accepted move; the state's sm and cs and the
    ring fields read once, ``out`` written once; an accept test a valid
    (move, cell), CHAIN_OPS_REFIT a (refit, cell)."""
    valid = int(moves[3].sum())
    ring = (cache.ring_dcx, cache.ring_dcy, cache.ring_d, cache.ring_ok)
    n_bytes = (nbytes(moves[3], state.d, state.sm, state.cs, state.n, *ring, *_leaves(out))
               + (12 if greedy else 8) * valid)
    accept = CHAIN_OPS_GREEDY if greedy else CHAIN_OPS_ACCEPT
    return n_bytes, accept * valid + CHAIN_OPS_REFIT * out[2].numel()


def chain_refit_work(state, n_ref, ok_ref, sm1, cs1, greedy, out) -> tuple[int, int]:
    """(bytes, operations) of one ``chain_refit`` launch that wrote the
    state ``out``, counted as this run's data needs: each refit's
    ``ok_ref`` read once, its scores only where it is valid; a cell's n
    once, from the state or from its last accepted refit; the state's sm
    and cs read once, out's sm, cs and n written once; an accept test a
    valid (refit, cell)."""
    valid = int(ok_ref.sum())
    n_bytes = nbytes(ok_ref, state.sm, state.cs, state.n, out.sm, out.cs, out.n) + 8 * valid
    return n_bytes, (CHAIN_OPS_GREEDY if greedy else CHAIN_OPS_ACCEPT) * valid


def lab_work(rgb, out) -> tuple[int, int]:
    """(bytes, operations) of one ``lab_convert`` launch on the image
    ``rgb`` (..., 3) that wrote ``out``: ``rgb`` read once, ``out`` written
    once; LAB_OPS_PIXEL a pixel."""
    return nbytes(rgb, out), LAB_OPS_PIXEL * (rgb.numel() // 3)


def extent_work(labels, centers, geom, out) -> tuple[int, int]:
    """(bytes, operations) of one ``extent_walk`` launch that wrote ``out``,
    counted as this run's data needs: the labels on each superpixel's rays
    that lie inside its view, in the distinct SECTOR-byte sectors of the
    (contiguous int32) label map that hold them, each read once; the
    centres read once, ``out`` written once.  No float arithmetic."""
    from cl_multiview_stereo_tpu_torch.ops.superpixel import _DIRS, clamp_center

    v, h, w = labels.shape
    s = geom.spixl_size
    cx, cy = clamp_center(centers[..., 0].to(torch.int64), centers[..., 1].to(torch.int64), w, h, s)
    base = (torch.arange(v, dtype=torch.int64, device=labels.device) * h * w).reshape(v, 1, 1)
    per_sector = SECTOR // 4
    touched = torch.zeros(-(-v * h * w // per_sector), dtype=torch.bool, device=labels.device)
    for i in range(1, s):
        for dx, dy in _DIRS:
            px, py = cx + i * dx, cy + i * dy
            inb = (px >= 0) & (py >= 0) & (px < w) & (py < h)
            touched[((base + py * w + px)[inb]) // per_sector] = True
    return SECTOR * int(touched.sum()) + nbytes(centers, out), 0


def fuse_warp_work(disp_full, out) -> tuple[int, int]:
    """(bytes, operations) of one ``fuse_warp`` launch that wrote ``out``
    (nv, H, W) from ``disp_full`` (V, H, W): the map read once, ``out``
    written once; FUSE_OPS_PROBE a (reference pixel, other view)."""
    return nbytes(disp_full, out), FUSE_OPS_PROBE * out.numel() * (disp_full.shape[0] - 1)


def vote_counts(disp_proj, disp_full, array_width: int, bl_ratio: float, fuse: float,
                view_range=None) -> dict:
    """The work of the stability vote's two walks on these inputs, on the
    plain vote's stabilities (``fusion.vote_stabilities``), and the
    descending walk's result.

    ``view_order``: (candidates looked at, lookups made) of the walk over
    the candidates in view order, one reference view at a time: a
    (candidate, output) is looked at (vote 1 scored) where the take rule
    could still accept it whatever its stability (d != 0, and no earlier
    winner or one below d); its lookups run in view order while the lookups
    left could still change the stability's sign (stability - left < 0 <=
    stability + left).

    ``descending``: (values scored, lookups made) of the walk over each
    pixel's distinct nonzero candidates in descending order, for all its
    reference views at once: a value is scored (vote 1 once) while a view
    is still open, each open view makes its lookups under the same stop, and
    a view closes on the first value whose stability is >= 0 (or with 0 when
    the values run out).  A pixel whose candidates hold a NaN walks in view
    order instead; ``nan`` holds those pixels' (looked at, lookups,
    pixels).  ``pixels``: H x W.  ``winners`` (nv, H, W): the descending
    walk's result, the view-order walk's on the NaN pixels."""
    from cl_multiview_stereo_tpu_torch.ops.fusion import vote_stabilities

    v, h, w = disp_proj.shape
    dev = disp_proj.device
    looked = torch.zeros((h, w), dtype=torch.int64, device=dev)
    lookups = torch.zeros_like(looked)
    best = None
    valid, made = [], []
    for d, stab1, votes in vote_stabilities(disp_proj, disp_full, array_width, bl_ratio, fuse, view_range):
        if best is None:
            best = torch.zeros_like(d)
        need = (d != 0) & ((best == 0) | (best < d))
        stability = stab1.expand(d.shape)
        n = torch.zeros(d.shape, dtype=torch.int16, device=dev)
        for j, vote in enumerate(votes):
            left = v - j
            n += ((stability - left < 0) & (stability + left >= 0)).to(torch.int16)
            stability = stability + vote
        looked += need.sum(0)
        lookups += (need * n).sum(0)
        best = torch.where(need & (stability >= 0), d, best)
        valid.append((d != 0) & (stability >= 0))
        made.append(n)
    valid, made = torch.stack(valid), torch.stack(made)  # (V, nv, H, W)
    nan = torch.isnan(disp_proj).any(0)
    open_ = (~nan).expand(best.shape).clone()
    winners = torch.zeros_like(best)
    prev = torch.zeros((h, w), dtype=torch.float32, device=dev)
    below = torch.ones((v, h, w), dtype=torch.bool, device=dev)  # the first step takes any value
    scored = made_desc = 0
    for _ in range(v):
        cond = (disp_proj != 0) & below & ~nan
        d = torch.where(cond, disp_proj, float("-inf")).max(0).values
        found = cond.any(0)
        live = found & open_.any(0)
        if not bool(live.any()):
            break
        # the first view holding the value: equal values score alike
        at = ((cond & (disp_proj == d)).to(torch.int8).argmax(0))[None, None].expand(1, *best.shape)
        active = open_ & live
        scored += int(live.sum())
        made_desc += int((made.gather(0, at)[0] * active).sum())
        take = active & valid.gather(0, at)[0]
        winners = torch.where(take, d.expand_as(winners), winners)
        open_ = open_ & ~take & found
        prev = d
        below = disp_proj < prev
    return {"view_order": (int(looked.sum()), int(lookups.sum())), "descending": (scored, made_desc),
            "nan": (int(looked[nan].sum()), int(lookups[nan].sum()), int(nan.sum())), "pixels": h * w,
            "winners": torch.where(nan, best, winners)}


def vote_ops(counts: dict, v: int, nv: int) -> tuple[int, int]:
    """f32 operations of the vote's (view-order, descending) walk on
    :func:`vote_counts`' counts: FUSE_OPS_TAKE a candidate each time a
    walk tests V candidates (the view-order walk for each output, the
    descending one for each value it scores, to pick it, and for each
    output of a NaN pixel), 1 + V FUSE_OPS_AGREE a candidate scored (bl * d
    and vote 1), FUSE_OPS_LOOKUP a lookup."""
    looked, lookups = counts["view_order"]
    scored, made = counts["descending"]
    nan_looked, nan_lookups, nan_pixels = counts["nan"]
    score = 1 + v * FUSE_OPS_AGREE
    view_order = FUSE_OPS_TAKE * v * nv * counts["pixels"] + looked * score + lookups * FUSE_OPS_LOOKUP
    descending = (FUSE_OPS_TAKE * v * (scored + nv * nan_pixels) + (scored + nan_looked) * score
                  + (made + nan_lookups) * FUSE_OPS_LOOKUP)
    return view_order, descending


def fuse_vote_work(disp_proj, disp_full, array_width: int, bl_ratio: float, fuse: float, view_range,
                   out) -> tuple[int, int, dict]:
    """(bytes, operations, the two walks' counts) of one ``fuse_vote``
    launch that wrote ``out`` (nv, H, W), counted as this run's data needs:
    both maps read once, ``out`` written once; the operations of whichever
    walk needs fewer (:func:`vote_ops`).  The dict holds each walk's
    operations and bound (``view_order_ops``, ``view_order_bound_ms``,
    ``descending_ops``, ``descending_bound_ms``) and :func:`vote_counts`'
    counts (``counts``)."""
    v, nv = disp_proj.shape[0], out.shape[0]
    counts = vote_counts(disp_proj, disp_full, array_width, bl_ratio, fuse, view_range)
    n_bytes = nbytes(disp_proj, disp_full, out)
    ops = dict(zip(("view_order", "descending"), vote_ops(counts, v, nv)))
    extra = {f"{walk}_{key}": val for walk, n in ops.items()
             for key, val in (("ops", n), ("bound_ms", bound(n_bytes, n)[0]))}
    extra["counts"] = {k: c for k, c in counts.items() if k != "winners"}
    return n_bytes, min(ops.values()), extra


def edge_snap_work(lab, spmap, out) -> tuple[int, int]:
    """(bytes, operations) of one ``edge_snap`` launch on ``lab`` (V, H, W,
    3) and the seeds ``spmap`` that wrote the map ``out``, counted as this
    run's data needs: the Lab pixels of each centre's 5x5 block around its
    clamped centre (rows and columns clamped into the view: every tap of the
    centre's and its ring's magnitudes), in the distinct SECTOR-byte sectors
    that hold them, each read once; the centres and colours read once and
    written once; EDGE_OPS_PIXEL a magnitude (the centre's and those of its
    ring pixels in the view), EDGE_OPS_RING a ring pixel in the view."""
    from cl_multiview_stereo_tpu_torch.ops.slic import _EDGE_RING

    v, h, w = lab.shape[:3]
    cx, cy = spmap.center[..., 0].to(torch.int64), spmap.center[..., 1].to(torch.int64)
    ccx, ccy = cx.clamp(0, w - 1), cy.clamp(0, h - 1)
    base = (torch.arange(v, dtype=torch.int64, device=lab.device) * h * w).reshape(v, 1, 1)
    touched = torch.zeros(-(-nbytes(lab) // SECTOR), dtype=torch.bool, device=lab.device)
    for dy in range(-2, 3):
        for dx in range(-2, 3):
            pix = base + (ccy + dy).clamp(0, h - 1) * w + (ccx + dx).clamp(0, w - 1)
            touched[12 * pix // SECTOR] = True
            touched[(12 * pix + 11) // SECTOR] = True
    ring = sum(int(((cx + dx >= 0) & (cy + dy >= 0) & (cx + dx < w) & (cy + dy < h)).sum()) for dx, dy in _EDGE_RING)
    n_bytes = SECTOR * int(touched.sum()) + nbytes(spmap.center, spmap.color, out.center, out.color)
    return n_bytes, EDGE_OPS_PIXEL * (cx.numel() + ring) + EDGE_OPS_RING * ring


def gather_work(n_rows: int, row_bytes: int, rows, out, *indices) -> tuple[int, int]:
    """(bytes, operations) of a row gather ``out`` from a contiguous table
    of ``n_rows`` rows of ``row_bytes`` each (``tools.profile_propagate``'s
    ladder): the rows that ``rows`` (flat row ids) reads, in the distinct
    SECTOR-byte sectors that hold them, each read once; the index tensors
    ``indices`` read once; the output written once.  No arithmetic."""
    first = rows * row_bytes // SECTOR
    last = (rows * row_bytes + row_bytes - 1) // SECTOR
    touched = torch.zeros(-(-n_rows * row_bytes // SECTOR), dtype=torch.bool, device=rows.device)
    for k in range(-(-row_bytes // SECTOR) + 1):  # the most sectors a row can span
        sector = first + k
        touched[sector[sector <= last]] = True
    return SECTOR * int(touched.sum()) + nbytes(*indices, out), 0


def cuda_ms(fn, iters: int) -> float:
    """Mean device milliseconds of ``fn()`` over ``iters`` back-to-back calls.
    The device first spins for QUEUE_CYCLES while the host queues the calls,
    so a kernel shorter than its wrapper's host time (the smoothness cache,
    20 us) is timed on the device, not at the host's pace."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(QUEUE_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def in_turns(kernel, plain, k_iters: int, p_iters: int) -> tuple[float, float]:
    """Kernel and plain ms, each the mean of two windows: kernel, plain,
    kernel, plain."""
    k_ms, p_ms = [], []
    for _ in range(2):
        k_ms.append(cuda_ms(kernel, k_iters))
        p_ms.append(cuda_ms(plain, p_iters))
    return sum(k_ms) / 2, sum(p_ms) / 2


def depth_inputs(rgb, settings, device):
    """Port stages up to the cost volume's inputs: (lab, centers, step)."""
    from cl_multiview_stereo_tpu_torch.config import DerivedGeometry, SlicParams
    from cl_multiview_stereo_tpu_torch.ops import slic, superpixel
    from cl_multiview_stereo_tpu_torch.ops.color import rgb_to_lab

    h, w = rgb.shape[1:3]
    geom = DerivedGeometry.create(w, h, settings)
    lab = rgb_to_lab(torch.as_tensor(rgb, device=device))
    labels, spmap = slic.segment(lab, geom, SlicParams.create(settings))
    extent = superpixel.superpixel_extent(labels, spmap.center, geom)
    step = superpixel.extent_step(extent).contiguous()
    return lab.contiguous(), spmap.center.contiguous(), step


def slic_inputs(rgb, settings, device):
    """SLIC on scene ``rgb`` as the slice runs it: (lab, geometry, params,
    the converged labels, the map they were assigned from)."""
    from cl_multiview_stereo_tpu_torch.config import DerivedGeometry, SlicParams
    from cl_multiview_stereo_tpu_torch.ops import slic
    from cl_multiview_stereo_tpu_torch.ops.color import rgb_to_lab

    h, w = rgb.shape[1:3]
    geom, p = DerivedGeometry.create(w, h, settings), SlicParams.create(settings)
    lab = rgb_to_lab(torch.as_tensor(rgb, device=device)).contiguous()
    labels, spmap = slic.segment(lab, geom, p)
    return lab, geom, p, labels, spmap


def slic_calls(kernel: str, lab, geom, p, labels, spmap) -> tuple:
    """(kernel fn, plain fn) of one SLIC kernel on these inputs."""
    from cl_multiview_stereo_tpu_torch.ops import slic

    if kernel == "slic_assign":
        return (lambda: slic.find_center_association(lab, spmap, geom, p),
                lambda: slic.find_center_association_reference(lab, spmap, geom, p))
    if kernel == "slic_update":
        return (lambda: slic.update_cluster_centers(lab, labels, spmap, geom),
                lambda: slic.update_cluster_centers_reference(lab, labels, spmap, geom))
    return (lambda: slic.suppress_local_labels(labels), lambda: slic.suppress_local_labels_reference(labels))


def vote_rounds(labels) -> dict:
    """The inputs of ``segment``'s two vote launches under
    ``enforce_connectivity``, by call: round 1 the converged ``labels``,
    round 2 round 1's output."""
    from cl_multiview_stereo_tpu_torch.ops import slic

    return {"round 1": labels, "round 2": slic.suppress_local_labels(labels)}


def fusion_inputs(settings, rgb, device) -> tuple:
    """The cross-check's inputs on scene ``rgb``: the slice's refined
    disparity (``MVSPipeline.run``'s ``disp_full`` at the defaults), its
    warp, and the geometry (array_width, bl_ratio, fuse) the pipeline's
    fusion passes."""
    from cl_multiview_stereo_tpu_torch.config import RefinementSchedule
    from cl_multiview_stereo_tpu_torch.models.mvs_pipeline import MVSPipeline
    from cl_multiview_stereo_tpu_torch.ops import crosscheck

    s = settings
    h, w = rgb.shape[1:3]
    disp_full = MVSPipeline.create(w, h, s, device=device).run(rgb).disp_full
    geo = (s.array_width, s.bl_ratio, RefinementSchedule.create(s).fuse_eff)
    return disp_full, crosscheck.warp(disp_full, *geo[:2]), geo


def fusion_case(kernel: str, disp_full, disp_proj, geo, view_range=None) -> tuple:
    """(kernel fn, plain fn, (bytes, operations[, the vote's counts])) of the
    cross-check's warp or vote on :func:`fusion_inputs`, for the reference
    views ``view_range`` (first, count; None: all)."""
    from cl_multiview_stereo_tpu_torch.ops import crosscheck, fusion

    aw, bl, fuse = geo
    if kernel == "fuse_warp":
        warp = (disp_full, aw, bl, view_range)
        return (lambda: crosscheck.warp(*warp), lambda: fusion.project_to_reference_inv_reference(*warp),
                fuse_warp_work(disp_full, crosscheck.warp(*warp)))
    args = (disp_proj, disp_full, aw, bl, fuse, view_range)
    return (lambda: crosscheck.vote(*args), lambda: fusion.remove_view_inconsistency_reference(*args),
            fuse_vote_work(*args, crosscheck.vote(*args)))


def snap_inputs(rgb, settings, device) -> tuple:
    """The edge snap's inputs on scene ``rgb`` as SLIC takes them: (Lab,
    the seed map)."""
    from cl_multiview_stereo_tpu_torch.config import DerivedGeometry
    from cl_multiview_stereo_tpu_torch.ops import slic
    from cl_multiview_stereo_tpu_torch.ops.color import rgb_to_lab

    h, w = rgb.shape[1:3]
    lab = rgb_to_lab(torch.as_tensor(rgb, device=device)).contiguous()
    return lab, slic.init_cluster_centers(lab, DerivedGeometry.create(w, h, settings))


def sweep0_state(settings, rgb, device):
    """The slice's stages on scene ``rgb`` up to the refinement's initial
    state: (context, initial state, the scoring keywords, the schedule)."""
    from cl_multiview_stereo_tpu_torch.config import RefinementSchedule, build_view_subsets
    from cl_multiview_stereo_tpu_torch.models.mvs_pipeline import MVSPipeline
    from cl_multiview_stereo_tpu_torch.ops import refine

    s = settings
    h, w = rgb.shape[1:3]
    art = MVSPipeline.create(w, h, s, device=device).run(rgb)
    sched = RefinementSchedule.create(s)
    ctx = refine.make_context(
        art.spmap.center, art.spmap.color, art.disp_init, art.labels, art.extent, art.flatness
    )
    kw = dict(gamma=sched.gamma_eff, alpha=sched.alpha_eff, fuse=sched.fuse_eff,
              bl_ratio=sched.bl_ratio,
              pairs=refine.pairs_from_subsets(build_view_subsets(s)[0], s.array_width))
    state0 = refine.init_state(ctx, **kw, steps=sched.kernel_steps, step_size=sched.sp_kernel_step)
    return ctx, state0, kw, sched


def refine_calls(settings, rgb, device, engine: str = "gather") -> dict:
    """The consistency calls of the refinement on scene ``rgb``, as (args,
    keywords): ``init``, the init state's (one move, the gather rule under
    every engine), then ``update`` and ``refit``, sweep 0's two calls under
    ``engine`` ("gather": the main path's)."""
    from cl_multiview_stereo_tpu_torch.ops import consistency, refine

    ctx, state0, kw, sched = sweep0_state(settings, rgb, device)
    calls, real = [], consistency.consistency_moves

    def record(*a, **k):
        calls.append((a, k))
        return real(*a, **k)

    consistency.consistency_moves = record
    try:
        refine.init_state(ctx, **kw, steps=sched.kernel_steps, step_size=sched.sp_kernel_step)
        refine.propagate_iteration(
            ctx, state0, 0, **kw, steps=sched.steps_per_iter[0],
            step_size=sched.step_size_per_iter[0], cons_engine=engine,
        )
    finally:
        consistency.consistency_moves = real
    if len(calls) != 3:
        raise AssertionError(f"the init and sweep 0 made {len(calls)} consistency calls, expected 3")
    return dict(zip(("init", "update", "refit"), calls))


def smooth_calls(settings, rgb, device, sweeps=(0,)) -> dict:
    """The smoothness calls of the refinement on scene ``rgb``, as (kernel,
    args, keywords, plain args): ``init cache`` and ``init`` (one move),
    then for each sweep ``it`` of ``sweeps``, run from the initial state at
    that sweep's reach, ``sweep it cache``, ``sweep it update`` and ``sweep
    it refit``.  A cache call's plain args are its args; a moves call's
    swap the routed cache for the plain form's (``cell_cache_reference`` of
    the cache call before it), whose tap fields the plain scorer reads."""
    from cl_multiview_stereo_tpu_torch.ops import refine, smoothness

    ctx, state0, kw, sched = sweep0_state(settings, rgb, device)
    calls, real = [], (smoothness.cell_cache, smoothness.smoothness_moves)
    plain = {}

    def record_cache(*a, **k):
        plain.clear()
        calls.append(("smooth_cache", a, k, a))
        return real[0](*a, **k)

    def record_moves(*a, **k):
        if not plain:
            _, ca, ck, _ = next(c for c in reversed(calls) if c[0] == "smooth_cache")
            plain["cache"] = smoothness.cell_cache_reference(*ca, **ck)
        calls.append(("smooth_moves", a, k, (plain["cache"], *a[1:])))
        return real[1](*a, **k)

    smoothness.cell_cache, smoothness.smoothness_moves = record_cache, record_moves
    try:
        refine.init_state(ctx, **kw, steps=sched.kernel_steps, step_size=sched.sp_kernel_step)
        for it in sweeps:
            refine.propagate_iteration(ctx, state0, it, **kw, steps=sched.steps_per_iter[it],
                                       step_size=sched.step_size_per_iter[it])
    finally:
        smoothness.cell_cache, smoothness.smoothness_moves = real
    names = ["init cache", "init"] + [f"sweep {it} {p}" for it in sweeps for p in ("cache", "update", "refit")]
    if len(calls) != len(names):
        raise AssertionError(f"the init and sweeps {sweeps} made {len(calls)} smoothness calls, expected {len(names)}")
    return dict(zip(names, calls))


def smooth_case(kernel: str, a, k, plain_a) -> tuple:
    """(kernel fn, plain fn, (bytes, operations)) of one recorded smoothness
    call (:func:`smooth_calls`)."""
    from cl_multiview_stereo_tpu_torch.ops import smoothness

    if kernel == "smooth_cache":
        out = smoothness.cell_cache(*a, **k)
        return (lambda: smoothness.cell_cache(*a, **k), lambda: smoothness.cell_cache_reference(*plain_a, **k),
                smooth_cache_work(a[0], a[1], out))
    return (lambda: smoothness.smoothness_moves(*a, **k),
            lambda: smoothness.smoothness_moves_reference(*plain_a, **k), smooth_moves_work(*a))


# each routed wrapper of the raster and chain kernels: (module, attribute,
# kernel, its plain form's module and attribute)
CHAIN_WRAPPERS = {
    "table": ("raster", "table", "raster_planes", "refine", "rasterize_table_reference"),
    "planes": ("raster", "planes", "raster_planes", "fusion", "rasterize_planes_reference"),
    "candidates": ("chain", "candidates", "chain_moves", "refine", "update_candidates_reference"),
    "update": ("chain", "update", "chain_update", "refine", "update_phase_reference"),
    "refit": ("chain", "refit", "chain_refit", "refine", "refit_phase_reference"),
}


def _module(name: str):
    import importlib

    return importlib.import_module(f"cl_multiview_stereo_tpu_torch.ops.{name}")


def chain_calls(settings, rgb, device, sweeps=(0,)) -> dict:
    """The raster and chain calls of the refinement on scene ``rgb``, as
    (wrapper, args, keywords), wrapper a key of CHAIN_WRAPPERS: ``init
    table``, then for each sweep ``it`` of ``sweeps``, run from the initial
    state at that sweep's reach, ``sweep it table``, ``sweep it
    candidates``, ``sweep it update`` and ``sweep it refit``; last ``fusion
    map``, fusion's rasterization of the initial state."""
    ctx, state0, kw, sched = sweep0_state(settings, rgb, device)
    calls, real = [], {}

    def recorder(wrapper):
        mod, attr = CHAIN_WRAPPERS[wrapper][:2]
        fn = real[wrapper] = getattr(_module(mod), attr)

        def record(*a, **k):
            calls.append((wrapper, a, k))
            return fn(*a, **k)
        return record

    for wrapper in CHAIN_WRAPPERS:
        setattr(_module(CHAIN_WRAPPERS[wrapper][0]), CHAIN_WRAPPERS[wrapper][1], recorder(wrapper))
    try:
        from cl_multiview_stereo_tpu_torch.ops import fusion, refine

        refine.init_state(ctx, **kw, steps=sched.kernel_steps, step_size=sched.sp_kernel_step)
        for it in sweeps:
            refine.propagate_iteration(ctx, state0, it, **kw, steps=sched.steps_per_iter[it],
                                       step_size=sched.step_size_per_iter[it])
        fusion.rasterize_planes(ctx.labels, ctx.center, state0.d, state0.n)
    finally:
        for wrapper, fn in real.items():
            setattr(_module(CHAIN_WRAPPERS[wrapper][0]), CHAIN_WRAPPERS[wrapper][1], fn)
    phases = ("table", "candidates", "update", "refit")
    names = ["init table"] + [f"sweep {it} {p}" for it in sweeps for p in phases] + ["fusion map"]
    if [c[0] for c in calls] != ["table", *phases * len(sweeps), "planes"]:
        raise AssertionError(f"the init, sweeps {sweeps} and fusion made the calls {[c[0] for c in calls]}")
    return dict(zip(names, calls))


def chain_case(wrapper: str, a, k) -> tuple:
    """(kernel, kernel fn, plain fn, (bytes, operations)) of one recorded
    raster or chain call (:func:`chain_calls`)."""
    mod, attr, kernel, plain_mod, plain_attr = CHAIN_WRAPPERS[wrapper]
    routed, plain = getattr(_module(mod), attr), getattr(_module(plain_mod), plain_attr)
    out = routed(*a, **k)
    if wrapper == "table":
        labels, center, ras_color, d, n = a[:5]
        work = raster_work(labels, center, d, n, ras_color, out)
    elif wrapper == "planes":
        work = raster_work(*a, None, out)
    elif wrapper == "candidates":
        work = chain_moves_work(a[0], a[1], a[2], out)
    elif wrapper == "update":
        work = chain_update_work(*a, out)
    else:
        work = chain_refit_work(*a, out)
    return kernel, (lambda: routed(*a, **k)), (lambda: plain(*a, **k)), work


def _cases(kernel: str, shapes: str, args, device) -> tuple[str, list]:
    """(shape label, [(kernel fn, plain fn, (bytes, ops))]) of one kernel;
    a kernel of several launches (consistency: sweep 0's two) lists each."""
    from cl_multiview_stereo_tpu_torch.config import SystemSettings, build_disp_levels
    from cl_multiview_stereo_tpu_torch.models.plane_sweep import plane_sweep_reference, sweep_args
    from cl_multiview_stereo_tpu_torch.ops import consistency, cost_volume, superpixel, sweep
    from cl_multiview_stereo_tpu_torch.ops.color import rgb_to_lab, rgb_to_lab_reference
    from cl_multiview_stereo_tpu_torch.testing.synthetic import fronto_parallel_scene

    if shapes == "main":
        s, h, w = SystemSettings(), 1080, 1920
        disp = 40.0
    else:
        s = SystemSettings(array_width=args.views, array_height=1, min_disp=4, max_disp=3 + args.d, inc=1)
        h, w, disp = args.height, args.width, float(4 + args.d // 2)
    if kernel in SLIC_KERNELS:
        rgb, _ = fronto_parallel_scene(h, w, s.array_width, s.array_height, disp=disp, bl_ratio=s.bl_ratio)
        lab, geom, p, labels, spmap = slic_inputs(rgb, s, device)
        label = f"{lab.shape[0]}x{h}x{w} S{geom.spixl_size} -> {geom.map_h}x{geom.map_w} cells"
        if kernel == "slic_vote":
            return label, [(*slic_calls(kernel, lab, geom, p, x, spmap), slic_work(kernel, lab, x, geom), call)
                           for call, x in vote_rounds(labels).items()]
        return label, [(*slic_calls(kernel, lab, geom, p, labels, spmap), slic_work(kernel, lab, labels, geom))]
    if kernel == "sweep" and shapes == "row":
        # the JAX tool's inputs: random Lab, each view against its neighbours
        v = args.views
        rng = np.random.default_rng(0)
        lab = torch.as_tensor((rng.random((v, h, w, 3), dtype=np.float32) * 100), device=device)
        ladder = [float(d) for d in range(4, 4 + args.d)]
        pairs = tuple(p for z in range(v - 1) for p in ((z, z + 1, 1, 0), (z + 1, z, -1, 0)))
        bl = 1.0
    else:
        rgb, _ = fronto_parallel_scene(h, w, s.array_width, s.array_height, disp=disp, bl_ratio=s.bl_ratio)
    if kernel == "lab_convert":
        x = torch.as_tensor(rgb, device=device)
        label = f"{x.shape[0]}x{h}x{w} uint8"
        return label, [(lambda: rgb_to_lab(x), lambda: rgb_to_lab_reference(x), lab_work(x, rgb_to_lab(x)))]
    if kernel == "extent_walk":
        _, geom, _, labels, spmap = slic_inputs(rgb, s, device)
        ex = (labels, spmap.center, geom)
        label = f"{labels.shape[0]}x{h}x{w} S{geom.spixl_size} -> {geom.map_h}x{geom.map_w} cells"
        return label, [(lambda: superpixel.superpixel_extent(*ex),
                        lambda: superpixel.superpixel_extent_reference(*ex),
                        extent_work(*ex, superpixel.superpixel_extent(*ex)))]
    if kernel in FUSION_KERNELS:
        disp_full, disp_proj, geo = fusion_inputs(s, rgb, device)
        label = f"{tuple(disp_full.shape)} refined disparity, array_width {geo[0]}, fuse {geo[2]}"
        if args.view_range:
            label += f", reference views {args.view_range[0]}..{sum(args.view_range) - 1}"
        return label, [fusion_case(kernel, disp_full, disp_proj, geo, args.view_range)]
    if kernel == "edge_snap":
        from cl_multiview_stereo_tpu_torch.ops import slic

        lab, spmap = snap_inputs(rgb, s, device)
        label = f"{tuple(lab.shape)} Lab, {tuple(spmap.center.shape[:3])} seeds"
        return label, [(lambda: slic.edge_snap(lab, spmap), lambda: slic.edge_snap_reference(lab, spmap),
                        edge_snap_work(lab, spmap, slic.edge_snap(lab, spmap)))]
    if kernel == "cost_volume":
        lab, centers, step = depth_inputs(rgb, s, device)
        levels = torch.as_tensor(build_disp_levels(s), device=device)
        cv = (lab, centers, step, levels, s.array_width, s.bl_ratio, s.neib_hor, s.neib_ver)
        out = cost_volume.superpixel_cost_volume(*cv)
        label = f"{lab.shape[0]}x{h}x{w} D{len(levels)} -> {tuple(out.shape)}"
        return label, [(lambda: cost_volume.superpixel_cost_volume(*cv),
                        lambda: cost_volume.cost_volume_reference(*cv),
                        cost_volume_work(lab, centers, step, levels, s, out))]
    if kernel == "sweep":
        if shapes == "main":
            lab = rgb_to_lab(torch.as_tensor(rgb, device=device)).contiguous()
            ladder, pairs = sweep_args(s)
            ladder, bl = [float(d) for d in ladder], s.bl_ratio
        sw = (lab, ladder, pairs, bl, 2)
        label = f"{lab.shape[0]}x{h}x{w} D{len(ladder)} P{len(pairs)}"
        return label, [(lambda: sweep.plane_sweep(*sw), lambda: plane_sweep_reference(*sw), sweep_work(*sw))]
    if kernel in SMOOTH_KERNELS:
        calls = [c for name, c in smooth_calls(s, rgb, device).items() if name.startswith("sweep") and c[0] == kernel]
        # the cache's (V, Mh, Mw) and tap count, or each call's (M, V, Mh, Mw)
        label = "sweep 0's launches " + ", ".join(
            f"{tuple(a[1].shape)}" + (f" T {8 + 4 * k['steps']}" if kernel == "smooth_cache" else "")
            for _, a, k, _ in calls)
        return label, [smooth_case(*c) for c in calls]
    if kernel in CHAIN_KERNELS:
        sweeps = tuple(range(s.no_prop)) if args.calls == "path" else (0,)
        calls = {name: c for name, c in chain_calls(s, rgb, device, sweeps=sweeps).items()
                 if CHAIN_WRAPPERS[c[0]][2] == kernel and (args.calls == "path" or name.startswith("sweep 0"))}
        cases = []
        for name, (wrapper, a, k) in calls.items():
            _, kern, plain, work = chain_case(wrapper, a, k)
            cases.append((kern, plain, work, name))
        wrapper, a, _ = next(iter(calls.values()))
        # the table's labels, else the cells' state
        shape = a[0].shape if wrapper == "table" else (a[0] if wrapper == "refit" else a[1]).d.shape
        label = f"{'the main path' if args.calls == 'path' else 'sweep 0'}'s launches: {', '.join(calls)} " \
                f"({wrapper} of {tuple(shape)})"
        return label, cases
    calls = [c for name, c in refine_calls(s, rgb, device).items() if name != "init"]
    label = "sweep 0's launches " + ", ".join(str(tuple(a[2].shape)) for a, _ in calls)
    return label, [(lambda a=a, k=k: consistency.consistency_moves(*a, **k),
                    lambda a=a, k=k: consistency.consistency_moves_reference(*a, **k),
                    consistency_work(*a, k["pairs"])) for a, k in calls]


def measure(kernel: str, shapes: str, args, device, card: str) -> dict:
    """One kernel's record: its launches' summed ms, plain ms and bound,
    and each launch's."""
    label, launches = _cases(kernel, shapes, args, device)
    k_iters, p_iters = ITERS[kernel]
    ms = plain_ms = bound_ms = 0.0
    bound_by = ""
    calls = []
    for i, (kern, plain, work, *name) in enumerate(launches):
        b, bound_by = bound(*work[:2])
        bound_ms += b
        call = {"call": name[0] if name else f"launch {i}", "ms": NOT_MEASURED, "plain_ms": NOT_MEASURED,
                "bound_ms": b, "share": NOT_MEASURED, **(work[2] if len(work) > 2 else {})}
        if device.type == "cuda":
            kern()
            plain()
            k, p = in_turns(kern, plain, k_iters, p_iters)
            ms += k
            plain_ms += p
            call.update(ms=k, plain_ms=p, share=b / k)
        calls.append(call)
    rec = {"kernel": kernel, "shape": label, "ms": NOT_MEASURED, "plain_ms": NOT_MEASURED,
           "bound_ms": bound_ms, "bound_by": bound_by, "share": NOT_MEASURED, "card": card, "calls": calls}
    if device.type == "cuda":
        rec.update(ms=ms, plain_ms=plain_ms, share=bound_ms / ms)
    return rec


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="roofline")
    ap.add_argument("--kernel", action="append", choices=("all",) + KERNELS,
                    help="a kernel, repeatable (default: all)")
    ap.add_argument("--shapes", choices=("main", "row"),
                    help="the slice's shapes, or the JAX tool's row of views "
                         "(default: row for the sweep, main for the others)")
    ap.add_argument("--views", type=int, default=2)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--d", type=int, default=64, help="hypotheses of the row case")
    ap.add_argument("--calls", choices=("sweep0", "path"), default="sweep0",
                    help="the raster and chain kernels on sweep 0's calls, or on every call of the main path")
    ap.add_argument("--csrc", help="build the kernels from this directory's sources")
    ap.add_argument("--view-range", type=lambda a: tuple(int(n) for n in a.split(",")), metavar="FIRST,COUNT",
                    help="the cross-check's kernels on these reference views only (default: all)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu (counts only)")
    return ap


def main(argv: list[str] | None = None) -> list[dict]:
    args = build_parser().parse_args(argv)

    from cl_multiview_stereo_tpu_torch.cli import resolve_device
    from cl_multiview_stereo_tpu_torch.device import card_name

    if args.csrc:
        from pathlib import Path

        from cl_multiview_stereo_tpu_torch.kernels import build

        build.CSRC = Path(args.csrc).resolve()
        if not any(build.CSRC.glob("*.cu")):
            raise SystemExit(f"roofline: no kernel sources in {build.CSRC}")
    dev = resolve_device(args.device)
    card = card_name() if dev.type == "cuda" else "cpu"
    recs = []
    for kernel in KERNELS if not args.kernel or "all" in args.kernel else args.kernel:
        shapes = args.shapes or ("row" if kernel == "sweep" else "main")
        recs.append(measure(kernel, shapes, args, dev, card))
        print(json.dumps(recs[-1]), flush=True)
    return recs


if __name__ == "__main__":
    main()
