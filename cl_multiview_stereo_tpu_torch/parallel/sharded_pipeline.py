"""View-sharded execution of the pipeline (port of
``cl_multiview_stereo_tpu/parallel/sharded_pipeline.py``).

The view axis is the data-parallel axis: rank r of the mesh's ``view``
axis owns a contiguous block of ``V / n`` views end to end.  JAX gets the
data flow from GSPMD; here it is written out, each stage on the rank's own
views and an all-gather wherever a cross-view stage reads other views:

* Lab, SLIC, the extent and the flatness: own views only (all per view);
* all-gathered once: the Lab images, labels, centres, extents and colours;
* depth init for the own reference views (the cost-volume kernel's view
  range), all-gathered for the init's table;
* refinement of the own views' cells: each sweep all-gathers the cell
  state (d, n), about 1.1 MB at 9x1080p, and rasterizes every view's
  table locally (a few ms) instead of moving the 300 MB table.  The move
  chain and its scorer are the unsharded ones (``refine.move_chain``,
  ``refine.score_moves``), over the pairs whose reference view the rank
  owns, with their per-view sums in subset order.  That filtering is the
  port's form of JAX's ``pair_layout="view"`` (``_viewpair_tables``,
  ``_consistency_viewpairs``), which exists so that temporaries shard with
  a view mesh; both layouts are accepted and give the same bits;
* fusion of the own views; with ``cross_check`` the warp and the vote read
  the all-gathered maps;
* a final all-gather of ``disp_full``.

The collectives only move data, so the result is bitwise
``MVSPipeline.run(rgb).disp_full``.
"""

from __future__ import annotations

from functools import partial

import torch

from cl_multiview_stereo_tpu_torch.config import (
    RefinementSchedule,
    SlicParams,
    build_disp_levels,
    build_view_subsets,
)
from cl_multiview_stereo_tpu_torch.models.mvs_pipeline import MVSPipeline
from cl_multiview_stereo_tpu_torch.ops import cost_volume, fusion, refine, slic, smoothness, superpixel
from cl_multiview_stereo_tpu_torch.ops.color import rgb_to_lab
from cl_multiview_stereo_tpu_torch.ops.fusion import gather_cells
from cl_multiview_stereo_tpu_torch.parallel.mesh import axis_of
from cl_multiview_stereo_tpu_torch.parallel.spatial import all_gather_cat


def view_block(v: int, n: int, t: int) -> tuple[int, int]:
    """(first view, count) of rank ``t``'s views; ``V % n == 0``."""
    if v % n:
        raise ValueError(f"{v} views do not split over {n} ranks")
    return t * (v // n), v // n


def own_pairs(pairs: tuple, v0: int, nv: int) -> tuple:
    """The (ref, view, dvx, dvy) pairs whose reference view lies in ``v0 ..
    v0 + nv - 1``, in their order, the reference renumbered from 0 (the
    neighbour keeps its global index into the whole table)."""
    return tuple((r - v0, nb, dx, dy) for r, nb, dx, dy in pairs if v0 <= r < v0 + nv)


def run_views(pipe: MVSPipeline, rgb, t: int, n: int, gather) -> torch.Tensor:
    """Rank ``t`` of ``n``: the pipeline for its own views, with ``gather(x)``
    concatenating every rank's ``x`` along the view axis.  Returns the
    whole (V, H, W) ``disp_full``."""
    s, geom, dev = pipe.settings, pipe.geom, pipe.device
    v0, nv = view_block(s.view_num, n, t)
    sched = RefinementSchedule.create(s)
    subset, counts = build_view_subsets(s)

    lab_own = rgb_to_lab(torch.as_tensor(rgb[v0:v0 + nv], device=dev))
    labels_own, spmap = slic.segment(lab_own, geom, SlicParams.create(s))
    extent_own = superpixel.superpixel_extent(labels_own, spmap.center, geom)
    flat_own = refine.compute_flatness(spmap.color, sched.gamma_eff)
    lab, labels, centers, extent, color = (
        gather(x) for x in (lab_own, labels_own, spmap.center, extent_own, spmap.color)
    )

    disp0_own = cost_volume.initial_depth_estimation(
        lab, centers, extent, build_disp_levels(s), subset,
        torch.as_tensor(counts, dtype=torch.int32, device=dev), s.array_width, s.bl_ratio,
        method=pipe.depth_method, neib_hor=s.neib_hor, neib_ver=s.neib_ver, view_range=(v0, nv),
    )
    ctx = refine.make_context(spmap.center, spmap.color, disp0_own, labels_own, extent_own, flat_own)
    pairs = pipe.pair_deltas if pipe.pair_deltas is not None else refine.pairs_from_subsets(subset, s.array_width)
    kw = dict(gamma=sched.gamma_eff, alpha=sched.alpha_eff, fuse=sched.fuse_eff,
              bl_ratio=sched.bl_ratio, pairs=own_pairs(pairs, v0, nv))
    ras_color = gather_cells(labels, color).reshape(-1, 3)

    def cache_for(state_d, d_all, n_all, steps, step_size):
        cache = smoothness.cell_cache(ctx, state_d, gamma=kw["gamma"], steps=steps, step_size=step_size)
        return cache._replace(ras=refine.rasterize_table(labels, centers, ras_color, d_all, n_all))

    disp0 = gather(disp0_own)
    cache = cache_for(disp0_own, disp0, refine._fronto_normals(disp0),
                      sched.kernel_steps, sched.sp_kernel_step)
    state = refine.init_scores(ctx, cache, disp0_own, refine._fronto_normals(disp0_own), **kw)
    mh, mw = disp0_own.shape[1:]
    for it in range(sched.no_prop):
        steps, step_size = sched.steps_per_iter[it], sched.step_size_per_iter[it]
        cache = cache_for(state.d, gather(state.d), gather(state.n), steps, step_size)
        offs = refine._update_move_offsets(steps, step_size, mw, mh)
        moves = refine.update_candidates(ctx, state, offs, kw["gamma"])
        state = refine.move_chain(cache, state, moves, it, partial(refine.score_moves, ctx, cache, **kw))

    disp_own = fusion.rasterize_planes(labels_own, spmap.center, state.d, state.n)
    if pipe.cross_check:
        disp_all = gather(disp_own)
        proj_own = fusion.project_to_reference_inv(disp_all, s.array_width, s.bl_ratio, (v0, nv))
        disp_own = fusion.remove_view_inconsistency(
            gather(proj_own), disp_all, s.array_width, s.bl_ratio, sched.fuse_eff, (v0, nv)
        )
    return gather(disp_own)


def sharded_pipeline_fn(pipe: MVSPipeline, mesh, axis: str | tuple[str, ...] = "view"):
    """A function (V, H, W, 3) uint8 -> (V, H, W) float32 disparity that
    runs ``pipe`` with the views sharded over ``mesh``'s axis ``axis``, or
    over several axes flattened (``("host", "view")``, JAX's ``P(("host",
    "view"))``; see ``mesh.axis_of``).  Every rank passes the whole batch
    and gets the whole map; ``V`` must be a multiple of the axis size."""
    group, t, n = axis_of(mesh, axis)
    return partial(run_views, pipe, t=t, n=n, gather=partial(all_gather_cat, group=group, n=n, dim=0))


def run_sharded(pipe: MVSPipeline, rgb, mesh) -> torch.Tensor:
    return sharded_pipeline_fn(pipe, mesh)(rgb)
