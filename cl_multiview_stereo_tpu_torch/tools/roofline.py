"""Each hand kernel's time against the least time the card could take for
the same work (port of the JAX package's ``tools/roofline.py``).

A kernel's bound is the larger of two times: the bytes it must move (each
input read once, each output written once) over the card's memory rate,
and the f32 operations it does on these inputs over the card's f32 peak.
Each kernel has one work function that counts (bytes, operations) from its
real inputs: :func:`cost_volume_work`, :func:`sweep_work`,
:func:`consistency_work` and, for SLIC's three kernels, :func:`slic_work`.
``chip_smoke.py`` and this tool both use them, so a kernel's roofline
share reads the same work whatever implements it.
:func:`gather_work` counts the row gathers of ``tools.profile_propagate``'s
gather-rate ladder the same way.

Usage:

  python -m cl_multiview_stereo_tpu_torch.tools.roofline \\
      [--kernel all|cost_volume|sweep|consistency|slic_assign|slic_update|slic_vote] \\
      [--shapes main|row] \\
      [--views 2 --height 480 --width 640 --d 64] [--device cuda|cpu]

``--shapes main`` is the slice's scene: 9 views of 1080x1920 at
``SystemSettings()`` (31 hypotheses, 40 pairs; the consistency kernel on
sweep 0's two calls of the gather engine, the main path's launches; the
SLIC kernels on the scene's converged labels and map).
``--shapes row`` is the JAX tool's case: ``--views`` views in one row,
``--height`` x ``--width``, the ladder 4 .. 3 + ``--d``; the sweep there
reads random Lab with each view against its right and left neighbour.  Without ``--shapes`` the sweep takes
``row`` (2x480x640, D = 64: BASELINE config 1) and the others ``main``.

Each kernel and its plain twin run once, then their times are taken with
CUDA events in turns (kernel, plain, kernel, plain).  Prints one JSON line
per kernel: ``kernel``, ``shape``, ``ms``, ``plain_ms``, ``bound_ms``,
``bound_by``, ``share`` (= bound_ms / ms) and ``card`` (nvidia-smi's name
and power limit).  With ``--device cpu`` nothing is timed: ``ms``,
``plain_ms`` and ``share`` read "not measured" and ``card`` "cpu".
"""

from __future__ import annotations

import argparse
import json

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
# the bytes of one device memory sector, the unit a gather reads rows in
SECTOR = 32
# CUDA-event iterations of (kernel, plain twin) in each of the two turns
ITERS = {"cost_volume": (10, 2), "sweep": (3, 1), "consistency": (10, 1),
         "slic_assign": (20, 2), "slic_update": (20, 1), "slic_vote": (20, 2)}
SLIC_KERNELS = ("slic_assign", "slic_update", "slic_vote")
KERNELS = tuple(ITERS)
NOT_MEASURED = "not measured"


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """The least ms the card could take, and what bounds it: the larger of
    the bytes over the memory rate and the operations over the f32 peak."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S * 1e3, n_ops / PEAK_F32_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


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
    """Mean device milliseconds of ``fn()`` over ``iters`` back-to-back calls."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
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


def _cases(kernel: str, shapes: str, args, device) -> tuple[str, list]:
    """(shape label, [(kernel fn, plain fn, (bytes, ops))]) of one kernel;
    a kernel of several launches (consistency: sweep 0's two) lists each."""
    from cl_multiview_stereo_tpu_torch.config import SystemSettings, build_disp_levels
    from cl_multiview_stereo_tpu_torch.models.plane_sweep import plane_sweep_reference, sweep_args
    from cl_multiview_stereo_tpu_torch.ops import consistency, cost_volume, sweep
    from cl_multiview_stereo_tpu_torch.ops.color import rgb_to_lab
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
    calls = [c for name, c in refine_calls(s, rgb, device).items() if name != "init"]
    label = "sweep 0's launches " + ", ".join(str(tuple(a[2].shape)) for a, _ in calls)
    return label, [(lambda a=a, k=k: consistency.consistency_moves(*a, **k),
                    lambda a=a, k=k: consistency.consistency_moves_reference(*a, **k),
                    consistency_work(*a, k["pairs"])) for a, k in calls]


def measure(kernel: str, shapes: str, args, device, card: str) -> dict:
    """One kernel's record: its launches' summed ms, plain ms and bound."""
    label, launches = _cases(kernel, shapes, args, device)
    k_iters, p_iters = ITERS[kernel]
    ms = plain_ms = bound_ms = 0.0
    bound_by = ""
    for kern, plain, work in launches:
        b, bound_by = bound(*work)
        bound_ms += b
        if device.type == "cuda":
            kern()
            plain()
            k, p = in_turns(kern, plain, k_iters, p_iters)
            ms += k
            plain_ms += p
    rec = {"kernel": kernel, "shape": label, "ms": NOT_MEASURED, "plain_ms": NOT_MEASURED,
           "bound_ms": bound_ms, "bound_by": bound_by, "share": NOT_MEASURED, "card": card}
    if device.type == "cuda":
        rec.update(ms=ms, plain_ms=plain_ms, share=bound_ms / ms)
    return rec


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="roofline")
    ap.add_argument("--kernel", default="all", choices=("all",) + KERNELS)
    ap.add_argument("--shapes", choices=("main", "row"),
                    help="the slice's shapes, or the JAX tool's row of views "
                         "(default: row for the sweep, main for the others)")
    ap.add_argument("--views", type=int, default=2)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--d", type=int, default=64, help="hypotheses of the row case")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu (counts only)")
    return ap


def main(argv: list[str] | None = None) -> list[dict]:
    args = build_parser().parse_args(argv)

    from cl_multiview_stereo_tpu_torch.cli import resolve_device
    from cl_multiview_stereo_tpu_torch.device import card_name

    dev = resolve_device(args.device)
    card = card_name() if dev.type == "cuda" else "cpu"
    recs = []
    for kernel in KERNELS if args.kernel == "all" else (args.kernel,):
        shapes = args.shapes or ("row" if kernel == "sweep" else "main")
        recs.append(measure(kernel, shapes, args, dev, card))
        print(json.dumps(recs[-1]), flush=True)
    return recs


if __name__ == "__main__":
    main()
