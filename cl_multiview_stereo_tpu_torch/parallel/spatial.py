"""Depth-slab and row-tile sharding (port of
``cl_multiview_stereo_tpu/parallel/spatial.py``).

* **Depth-slab sharding** (:func:`disp_sharded_depth_init`): each rank
  sweeps a contiguous slab of the disparity ladder through the cost-volume
  kernel, reduces it with a first-occurrence argmin, and the per-slab
  winners are combined after one all-gather of (cost, disparity) per
  superpixel (:func:`combine_slab_winners`).  Slabs are contiguous and
  ascending, so a tie goes to the lowest disparity, as in the reference's
  strict-``<`` scan (clcode.cl:1059-1067).
* **Row-tile sharding with halo exchange** (:func:`spatial_plane_sweep`,
  :func:`spatial_refine`): each rank owns a band of image rows of every
  view and receives ``halo`` rows from its neighbours on the mesh axis
  (:func:`halo_exchange_rows`).  The dense sweep runs its kernel in row-
  window mode on the band; the refinement scores its own superpixel rows
  against a halo-extended window of the rasterized table.

Each function is split in two: the rank's local work, a plain function of
the inputs and of (rank, n) with no collective inside (``slab_winners``,
``tile_band``/``sweep_tile``, ``block_table``/``block_init``/
``block_sweep``), and a thin collective layer on the mesh axis's process
group.  One process can so run every rank's local work in turn, as the
tests and ``chip_smoke.py`` do.  The collectives are ``all_gather`` only:
they move data and add nothing, so every sharded result is bitwise the
unsharded one.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from cl_multiview_stereo_tpu_torch.models import plane_sweep
from cl_multiview_stereo_tpu_torch.ops import cost_volume, refine, smoothness, sweep
from cl_multiview_stereo_tpu_torch.ops.fusion import gather_cells
from cl_multiview_stereo_tpu_torch.parallel.mesh import axis_of


def all_gather_cat(x: torch.Tensor, group, n: int, dim: int) -> torch.Tensor:
    """Every rank's ``x`` of the group, concatenated along ``dim`` in rank
    order (the tiled all-gather)."""
    if n == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


# ---------------------------------------------------------------------------
# Halo exchange
# ---------------------------------------------------------------------------


def _zeros_rows(x: torch.Tensor, rows: int, row_axis: int) -> torch.Tensor:
    shape = list(x.shape)
    shape[row_axis] = rows
    return torch.zeros(shape, dtype=x.dtype, device=x.device)


def halo_window(full: torch.Tensor, t: int, rows: int, halo: int, row_axis: int = 0) -> torch.Tensor:
    """Rows ``t*rows - halo .. t*rows + rows + halo - 1`` of the whole array
    ``full``, zero beyond its ends: block ``t``'s halo-extended rows."""
    pad = _zeros_rows(full, halo, row_axis)
    return torch.cat([pad, full, pad], dim=row_axis).narrow(row_axis, t * rows, rows + 2 * halo)


def halo_join(x: torch.Tensor, edges: Sequence[torch.Tensor], t: int, halo: int, row_axis: int = 0) -> torch.Tensor:
    """Block ``t`` with the last ``halo`` rows of block ``t - 1`` above it
    and the first ``halo`` rows of block ``t + 1`` below, zero beyond the
    ends.  ``edges[k]`` is block k's first ``halo`` rows followed by its
    last ``halo``."""
    n = len(edges)
    above = edges[t - 1].narrow(row_axis, halo, halo) if t > 0 else _zeros_rows(x, halo, row_axis)
    below = edges[t + 1].narrow(row_axis, 0, halo) if t < n - 1 else _zeros_rows(x, halo, row_axis)
    return torch.cat([above, x, below], dim=row_axis)


def halo_exchange_rows(x: torch.Tensor, halo: int, mesh, axis: str, row_axis: int = 0) -> torch.Tensor:
    """Extend this rank's block of a row-sharded array with ``halo`` rows
    from each neighbour on mesh axis ``axis``; rows beyond the global edges
    are zero.  Returns ``2 * halo`` more rows than ``x`` has.

    When ``halo`` exceeds the block's rows the halo spans several blocks:
    the whole array is all-gathered and the window cut from it, as in JAX.
    Otherwise each rank all-gathers its two edge slabs (``2 * halo`` rows)
    and keeps its neighbours'.  An all-gather and not ``batch_isend_irecv``:
    gloo carries all-gather on CPU and CUDA tensors alike (and NCCL of
    course), while its point-to-point ops take CPU tensors only, and one
    collective call has no send/receive order to get wrong.  The edges are
    a few rows per rank, so sending them to every rank costs little at the
    mesh sizes of one host."""
    if halo == 0:
        return x
    group, t, n = axis_of(mesh, axis)
    rows = x.shape[row_axis]
    if halo > rows:
        return halo_window(all_gather_cat(x, group, n, row_axis), t, rows, halo, row_axis)
    edges = torch.cat([x.narrow(row_axis, 0, halo), x.narrow(row_axis, rows - halo, halo)], dim=row_axis)
    if n == 1:
        gathered = [edges]
    else:
        gathered = [torch.empty_like(edges) for _ in range(n)]
        dist.all_gather(gathered, edges.contiguous(), group=group)
    return halo_join(x, gathered, t, halo, row_axis)


# ---------------------------------------------------------------------------
# Depth-slab sharded superpixel depth init
# ---------------------------------------------------------------------------


def padded_ladder(disp_levels, n: int) -> np.ndarray:
    """The ladder padded to a multiple of ``n`` with repeats of its last
    level: a repeat can never win a strict-``<`` tie against the first
    occurrence."""
    ladder = np.asarray(disp_levels, np.float32).reshape(-1)
    pad = (-len(ladder)) % n
    return np.concatenate([ladder, np.repeat(ladder[-1:], pad)]) if pad else ladder


def slab_winners(
    lab, centers, step, ladder: np.ndarray, t: int, n: int, array_width: int, bl_ratio: float,
    neib_hor: int = 1, neib_ver: int = 1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Rank ``t``'s local work: the cost volume of its slab of the padded
    ``ladder`` and the slab's first-occurrence winner, (cost, disparity),
    each (V, Mh, Mw)."""
    per = len(ladder) // n
    slab = torch.as_tensor(ladder[t * per:(t + 1) * per], device=lab.device)
    vol = cost_volume.superpixel_cost_volume(
        lab, centers, step, slab, array_width, bl_ratio, neib_hor, neib_ver
    )
    idx = torch.argmin(vol, dim=1, keepdim=True)
    return torch.take_along_dim(vol, idx, dim=1)[:, 0], slab[idx[:, 0]]


def combine_slab_winners(costs: torch.Tensor, disps: torch.Tensor) -> torch.Tensor:
    """(n, V, Mh, Mw) slab winners in ladder order -> (V, Mh, Mw) disparity:
    the first slab that holds the least cost wins."""
    k = torch.argmin(costs, dim=0, keepdim=True)
    return torch.take_along_dim(disps, k, dim=0)[0]


def disp_sharded_depth_init(
    lab: torch.Tensor,  # (V, H, W, 3)
    centers: torch.Tensor,  # (V, Mh, Mw, 2)
    step: torch.Tensor,  # (V, Mh, Mw, 2)
    disp_levels,
    subset_num,
    mesh,
    array_width: int,
    bl_ratio: float,
    *,
    axis: str = "disp",
    neib_hor: int = 1,
    neib_ver: int = 1,
) -> torch.Tensor:
    """Superpixel plane-sweep depth init with the ladder sharded over mesh
    axis ``axis``: bitwise the unsharded ``initial_depth_estimation``
    (dense method).  Every rank holds the whole inputs and returns the
    whole (V, Mh, Mw) map; an uneven ladder is padded (:func:`padded_ladder`)."""
    group, t, n = axis_of(mesh, axis)
    ladder = padded_ladder(disp_levels, n)
    cost, disp = slab_winners(
        lab.contiguous(), centers.contiguous(), step.contiguous(), ladder, t, n,
        array_width, bl_ratio, neib_hor, neib_ver,
    )
    costs = all_gather_cat(cost[None], group, n, 0)
    disps = all_gather_cat(disp[None], group, n, 0)
    disp = combine_slab_winners(costs, disps)
    has_views = torch.as_tensor(np.asarray(subset_num), device=disp.device) > 0
    return torch.where(has_views[:, None, None], disp, 0.0)


# ---------------------------------------------------------------------------
# Row-tiled dense sweep with halo exchange
# ---------------------------------------------------------------------------


def sweep_halo(ladder, pairs, bl_ratio: float, window_radius: int) -> int:
    """Rows a tile needs from each side: the largest vertical shift plus
    the box radius (JAX's ``max|ceil(bl*d*dvy)| + r``)."""
    return max(sweep.row_reach(ladder, pairs, bl_ratio, window_radius))


def tile_band(ext: torch.Tensor, t: int, rows: int, halo: int, height: int) -> tuple[torch.Tensor, int]:
    """Tile ``t``'s halo-extended rows (V, rows + 2*halo, ...) cut to the
    rows inside the image: (band, its first global row)."""
    lo, hi = max(0, t * rows - halo), min(height, (t + 1) * rows + halo)
    start = lo - (t * rows - halo)
    return ext[:, start:start + hi - lo].contiguous(), lo


def sweep_tile(
    band: torch.Tensor, band0: int, t: int, rows: int, height: int, ladder, pairs, bl_ratio: float,
    window_radius: int = 2,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Rank ``t``'s local work: the sweep of output rows ``t*rows ..`` from
    a band that starts at global row ``band0`` (the kernel's row window on
    CUDA, the plain twin on the CPU): (disp, cost), each (V, rows, W)."""
    win = sweep.RowWindow(height, band0, t * rows, rows)
    return plane_sweep.plane_sweep_depth(band, ladder, pairs, bl_ratio, window_radius, rows=win)


def spatial_plane_sweep(
    lab: torch.Tensor,
    disp_levels,
    pairs: tuple[tuple[int, int, int, int], ...],
    bl_ratio: float,
    mesh,
    *,
    axis: str = "tile",
    window_radius: int = 2,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense plane sweep with image rows sharded over mesh axis ``axis``:
    bitwise ``models.plane_sweep.plane_sweep_depth``.

    Each rank takes its band of rows of the whole ``lab`` (V, H, W, 3),
    receives :func:`sweep_halo` rows from its neighbours
    (:func:`halo_exchange_rows`), sweeps its own rows, and the tiles are
    all-gathered: every rank returns (disp, cost), each (V, H, W).  The
    row tests of the kernel are global, so the rows past the image's edges
    are cut, not replicated: a read at row -1 clamps to row 0.  Requires
    ``H % n == 0``."""
    group, t, n = axis_of(mesh, axis)
    h = lab.shape[1]
    if h % n:
        raise ValueError(f"image height {h} not divisible by {n} tiles")
    rows = h // n
    ladder = plane_sweep._ladder(disp_levels)
    halo = sweep_halo(ladder, pairs, bl_ratio, window_radius)
    ext = halo_exchange_rows(lab[:, t * rows:(t + 1) * rows], halo, mesh, axis, row_axis=1)
    band, band0 = tile_band(ext, t, rows, halo, h)
    disp, cost = sweep_tile(band, band0, t, rows, h, ladder, pairs, bl_ratio, window_radius)
    return all_gather_cat(disp, group, n, 1), all_gather_cat(cost, group, n, 1)


# ---------------------------------------------------------------------------
# Row-sharded PatchMatch refinement with halo exchange
# ---------------------------------------------------------------------------


def refine_halo(ctx: refine.RefineContext, schedule, pairs: tuple, halo_disp) -> int:
    """Pixel rows of the rasterized table a block reads beyond its own, for
    ``halo_disp`` (JAX's sizing rule): ``None`` sizes it to the whole image
    (exact); a number bounds |plane-extrapolated disparity|; ``"auto"``
    takes ``1.5 * max|disp0| + spixl_size``.  A bound gives the largest
    vertical reach of a consistency sample plus the sample's own offset
    from its superpixel row.  The port's pairs give the largest |dvy|."""
    v, mh, _ = ctx.disp0.shape
    h = ctx.labels.shape[1]
    if halo_disp is None:
        return h
    if halo_disp == "auto":
        spixl = max(1, h // max(mh, 1))
        disp_max = float(ctx.disp0.abs().max())
        if not math.isfinite(disp_max):
            raise ValueError("halo_disp='auto' requires finite ctx.disp0")
        # pixel-space slack (+ spixl) on a disparity-space bound
        halo_disp = 1.5 * disp_max + spixl
    dvy_max = max((abs(p[3]) for p in pairs), default=0.0)
    reach = math.ceil(abs(schedule.bl_ratio) * float(halo_disp) * dvy_max)
    return int(reach) + 4 * (h // max(mh, 1)) + 1


def _rows(a: torch.Tensor, t: int, rows: int) -> torch.Tensor:
    return a[:, t * rows:(t + 1) * rows]


def block_context(ctx: refine.RefineContext, t: int, n: int) -> refine.RefineContext:
    """Block ``t``'s cell rows of the context (labels and the per-pixel
    colour its pixel rows), each a contiguous tensor as the consistency
    kernel takes them."""
    mh, h = ctx.disp0.shape[1], ctx.labels.shape[1]
    bh, bhp = mh // n, h // n
    labels = _rows(ctx.labels, t, bhp)
    cells = lambda a: _rows(a, t, bh).contiguous()  # noqa: E731
    return refine.RefineContext(
        center=cells(ctx.center), color=cells(ctx.color), disp0=cells(ctx.disp0), labels=labels,
        samples=cells(ctx.samples), fl=cells(ctx.fl),
        ras_color=gather_cells(labels, ctx.color).reshape(-1, 3),
    )


def block_table(ctx: refine.RefineContext, blk: refine.RefineContext, t: int, d_full, n_full) -> torch.Tensor:
    """Block ``t``'s pixel rows of the rasterized input state, (V, rows, W,
    4): each pixel's plane disparity and its superpixel's colour."""
    v, bhp, w = blk.labels.shape
    table = refine.rasterize_table(blk.labels, ctx.center, blk.ras_color, d_full, n_full, row0=t * bhp)
    return table.reshape(v, bhp, w, 4)


def _block_cache(ctx, d_full, gamma: float, steps: int, step_size: float, t: int, n: int, ras):
    """The cell cache of block ``t``'s cell rows for the whole map's input
    disparities ``d_full`` (its taps read the whole map), with ``ras`` as
    its table."""
    bh = d_full.shape[1] // n
    cache = smoothness.cell_cache(ctx, d_full, gamma=gamma, steps=steps, step_size=step_size, rows=(t * bh, bh))
    return cache._replace(ras=ras)


def _kw(schedule, pairs) -> dict:
    return dict(gamma=schedule.gamma_eff, alpha=schedule.alpha_eff, fuse=schedule.fuse_eff,
                bl_ratio=schedule.bl_ratio, pairs=pairs)


def block_init(ctx, blk, schedule, pairs, t: int, n: int, ras, ras_rows) -> refine.RefineState:
    """Rank ``t``'s local work of the state init: its cells' fronto-parallel
    planes scored against ``ras``, the table's rows ``ras_rows`` (row_lo,
    rows) of every view, flat."""
    d_full = ctx.disp0
    cache = _block_cache(ctx, d_full, schedule.gamma_eff, schedule.kernel_steps,
                         schedule.sp_kernel_step, t, n, ras)
    return refine.init_scores(
        blk, cache, blk.disp0, refine._fronto_normals(blk.disp0), **_kw(schedule, pairs),
        img_hw=tuple(ctx.labels.shape[1:3]), ras_rows=ras_rows,
    )


def block_sweep(
    ctx, blk, schedule, pairs, t: int, n: int, it: int, state: refine.RefineState, d_full, n_full,
    ras, ras_rows,
) -> refine.RefineState:
    """Rank ``t``'s local work of sweep ``it``: its cells' move chain
    (``refine.move_chain``) against the whole map's input state ``(d_full,
    n_full)`` and the window ``ras`` of the rasterized table."""
    mh, mw = d_full.shape[1:]
    steps, step_size = schedule.steps_per_iter[it], schedule.step_size_per_iter[it]
    kw = _kw(schedule, pairs)
    cache = _block_cache(ctx, d_full, kw["gamma"], steps, step_size, t, n, ras)
    offs = refine._update_move_offsets(steps, step_size, mw, mh)
    full_in = refine.RefineState(d=d_full, sm=None, cs=None, n=n_full)
    bh = mh // n
    moves = refine.update_candidates(ctx, full_in, offs, kw["gamma"], rows=(t * bh, bh))
    score = partial(refine.score_moves, blk, cache, **kw, img_hw=tuple(ctx.labels.shape[1:3]),
                    ras_rows=ras_rows)
    return refine.move_chain(cache, state, moves, it, score)


def spatial_refine(
    ctx: refine.RefineContext,
    schedule,
    mesh,
    *,
    pairs: tuple,
    axis: str = "tile",
    halo_disp: float | None | str = None,
) -> refine.RefineState:
    """State init and propagation (``refine.refine``, gather engine) with
    the superpixel rows and the rasterized table sharded over mesh axis
    ``axis``.  Per Jacobi sweep each rank:

    * all-gathers the cell state (d, n), a few MB even at 49 views;
    * builds its block's cell cache from it;
    * rasterizes its own pixel rows and extends them with
      :func:`halo_exchange_rows` by :func:`refine_halo` rows (the whole
      table is all-gathered when the halo covers the image);
    * scores and accepts its own cells' moves (``refine.move_chain``).

    ``halo_disp``: see :func:`refine_halo`; ``None`` (exact) is bitwise
    ``refine.refine``, and a bound differs only for planes whose samples
    project beyond it.  Requires ``Mh % n == 0`` and ``H % n == 0``.
    Every rank returns the whole gathered ``RefineState``."""
    group, t, n = axis_of(mesh, axis)
    v, mh, mw = ctx.disp0.shape
    h, w = ctx.labels.shape[1:3]
    if mh % n or h % n:
        raise ValueError(f"map rows {mh} / image rows {h} not divisible by {n}")
    halo = refine_halo(ctx, schedule, pairs, halo_disp)
    blk = block_context(ctx, t, n)
    bhp = h // n

    def window(d_full, n_full):
        own = block_table(ctx, blk, t, d_full, n_full)
        if halo >= h:  # the window covers the image: the whole table
            return all_gather_cat(own, group, n, 1).reshape(-1, 4), (0, h)
        ext = halo_exchange_rows(own, halo, mesh, axis, row_axis=1)
        return ext.reshape(-1, 4), (t * bhp - halo, bhp + 2 * halo)

    d_full = ctx.disp0
    state = block_init(ctx, blk, schedule, pairs, t, n, *window(d_full, refine._fronto_normals(d_full)))
    for it in range(schedule.no_prop):
        d_full = all_gather_cat(state.d, group, n, 1)
        n_full = all_gather_cat(state.n, group, n, 1)
        state = block_sweep(ctx, blk, schedule, pairs, t, n, it, state, d_full, n_full,
                            *window(d_full, n_full))
    return refine.RefineState(*(all_gather_cat(a, group, n, 1) for a in state))
