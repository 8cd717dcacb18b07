#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's paths once on one GPU and check them.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

0. device: a CUDA device is visible; print its name and power limit;
1. build: compile
   ``csrc/{cost_volume,sweep,consistency,slic,smoothness,raster,chain,color,extent,crosscheck}.cu``
   with nvcc from this checkout, one nvcc each, all started together; print
   what ptxas reports, check that two cost-volume blocks and two sweep
   blocks fit on an SM and that the sweep, consistency, SLIC, smoothness,
   raster, chain, Lab, extent and cross-check kernels do not spill; print the Lab
   kernel's blocks an SM (uint8 and float32 input) and the extent
   kernel's;
2. kernels against their plain twins, on the same device tensors, with
   both times from CUDA events, in turns, beside each kernel's bound (the
   larger of its bytes over the card's memory rate and its f32 operations
   over the card's peak, counted from this run's inputs): the cost volume,
   bitwise, at the full 9-view 1080p size, one odd small shape and 9x543x967
   with 16-pixel superpixels (ragged tiles, sample steps up to 7); the
   dense sweep, bitwise, at 9x1080x1920 (31 hypotheses, 40 pairs),
   2x1080x1920 (64 hypotheses, horizontal pairs) and 9x53x131; the
   consistency kernel, NaN at the same places as its twin, on the 9-view
   1080p scene's launches: under the gather rule the init state's (M = 1)
   and sweep 0's update and refit phases (M = 8), under the strips rule
   the strips engine's two, and the sharded paths' modes on sweep 0's
   update phase: the row window of tile 1 of 3 with the "auto" halo and
   views 3..5 with their own pairs against the whole table (bitwise the
   whole launch's rows); SLIC's three kernels on the 9-view 1080p scene's
   converged labels and map: the assignment and the update (centre, count
   and colour) bitwise, with ``index_add_``'s time beside the update's,
   and the vote on both of ``segment``'s rounds under
   ``enforce_connectivity`` (``tools.roofline.vote_rounds``) and on noisy
   labels, bitwise, each round's time and share beside the bound and
   ``vote_kernel``'s registers, spills and SASS instructions
   (``tools.sass``); the smoothness kernels, bitwise (NaN at the same
   places), on the main path's calls at 9x135x240 cells: ``smooth_cache``'s cell
   table and ring at the init's and sweep 0's reach (T = 60) and sweep 4's
   (T = 16), with no T-wide field allocated, and ``smooth_moves`` on the
   init state (M = 1), sweep 0's update and refit phases (M = 8) and sweep
   4's (M = 16, 8), each against the plain scorer on the plain cache;
   the plane rasterization and the move chain's kernels, bitwise (NaN at
   the same places), on the main path's calls at 9x1080x1920
   (``tools.roofline.chain_calls``): ``raster_planes`` on the init's
   table, sweeps 0-4's tables and fusion's map, ``chain_moves`` on
   sweeps 0-4's candidates (M = 8 at sweep 0, 16 at sweep 4),
   ``chain_update`` and ``chain_refit`` on those sweeps' accept walks,
   each against its plain form, ``chain_update``'s share of its bound
   over the five sweeps and fusion's map's share of its own (the
   ``raster_planes`` record's ``map_ms`` and ``map_bound_ms``); the Lab
   conversion (``lab_convert``) on the 9-view 1080p scene and on every
   uint8 RGB triple once (a 4096x4096
   image), and the extent walk (``extent_walk``) on the scene's converged
   labels and map (``tools.roofline.slic_inputs``), each bitwise its plain
   form, with each kernel's issue time (``tools.roofline.issue_ms`` from
   ``tools.sass``'s instructions and the card's top SM clock) beside its
   byte bound; the cross-check's warp (``fuse_warp``) on the slice's
   refined disparity at 9x1080x1920 and its vote (``fuse_vote``) on that
   map and its warp, and the seeds' edge snap (``edge_snap``) on the
   scene's Lab and SLIC's seed centres (``tools.roofline.fusion_inputs``,
   ``snap_inputs``), each bitwise its plain form (NaN at the same places),
   with its SASS instruction counts (and the snap's issue time) beside its
   bound; the vote's bound from the lesser of its two walks' counts (in
   view order and in descending order), the view order's beside it;
3. the slice at full size: ``MVSPipeline(depth_method="strips")`` on a
   synthetic 9-view 1920x1080 fronto-parallel scene (31 hypotheses, 5 SLIC
   iterations, 5 propagation sweeps): one warm-up and two timed runs, the
   per-stage device times, MP/s and peak memory; each run must launch the
   consistency kernel 1 + 2 x 5 = 11 times (the gather engine on the card),
   the SLIC assignment 5 + 1 = 6 times and the update 5 times,
   ``smooth_cache`` 1 + 5 = 6 and ``smooth_moves`` 1 + 2 x 5 = 11 times,
   ``raster_planes`` 1 + 5 + 1 = 7 times (the init's table, a table a
   sweep, fusion's map), ``chain_moves``, ``chain_update`` and
   ``chain_refit`` 5 times each, and ``lab_convert`` and ``extent_walk``
   once each, and neither the cross-check's kernels nor the edge snap;
3b. the same stages with the strips consistency engine
   (``refine.refine(cons_engine="strips")``): timed the same way, and its
   refined disparity held against phase 3's gather engine; each run
   launches the Lab, extent, raster and chain kernels as phase 3's;
3c. the dense plane sweep (``models.plane_sweep.plane_sweep_depth``) on
   the scene's Lab images: timed the same way, and held against the
   scene's disparity;
4. the card against the port's CPU path, at 3x3 views of 270x480, for the
   slice, the strips path, the dense sweep, and the pipeline with each
   other knob on alone and all at once (cross-check, SLIC edge snap and
   connectivity, gather depth init, view pair layout); and the card's
   cross-check fusion of the CPU's refined state, bitwise the CPU's; the
   SLIC flags' runs launch the vote on the card;
5. the CLI path at full size (``cli.main(["run", ...])`` on the scene
   written as 9 PNGs, default depth method "dense" through the cost-volume
   kernel, cross-check fusion, PLY and checkpoint): 5a one warm-up and two
   timed runs, the wall seconds per scene, stage times, peak memory and
   the disparity recovered, each timed run launching ``fuse_warp`` and
   ``fuse_vote`` once, then one more run under ``torch.profiler`` for each
   stage's device ms (the ``fusion`` stage's printed); 5b a ``--resume``
   from 5a's checkpoint, whose ``disp_full`` must be bitwise 5a's; 5c the
   SLIC flags (``--set enforce_connectivity=true --set edge_enable=true``),
   timed and profiled as 5a, their vote launches counted and each timed run
   launching ``edge_snap`` once (the ``slic`` stage's device ms printed); 5d ``pair_layout="view"`` (the
   packed scorer in the port) bitwise equal to phase 3's packed state,
   and the gather depth init timed against the kernel's, their WTA
   agreeing on >= 0.999 of cells;
6. the SfM path (plain PyTorch, no kernel of its own) on phase 5's PNGs:
   6a ``cli.main(["sfm", ...])``, one warm-up and two timed runs, the
   seconds per scene, device ms per step and host seconds of the track
   building, peak memory, and the matches, RMS and ATE held to the JAX
   package's run_sfm on the same scene; 6b the same with ``--pose-graph``
   (warm-up and one timed run); 6c ``cli.main(["run", ..., "--sfm"])``,
   once, its stage times and its disparity from the recovered poses
   (cost-volume launches counted into the kernels' record); 6d the card
   against the port's CPU path at 9x270x480, with and without the pose
   graph: keypoint agreement and the ATE between the two runs' poses;
7. ``parallel/`` at full width, in an NCCL group of world size 1 that the
   script starts: 7a ``disp_sharded_depth_init`` bitwise the dense depth
   init, and the slab local work of 2, 3 and 4 ranks, run one after
   another and joined by ``combine_slab_winners``, bitwise too; 7b
   ``spatial_plane_sweep`` bitwise ``plane_sweep_depth``, and the sweep
   kernel's row window on each tile of 2, 4 and 8 row tiles, from a
   locally cut halo band, bitwise the whole launch's rows (a tile
   launch's ms beside the whole launch's and the tile's bound); 7c
   ``spatial_refine`` bitwise ``refine.refine`` with the exact and the
   "auto" halo; 7d ``run_sharded`` bitwise ``MVSPipeline.run`` with both
   pair layouts, and the cost volume's view range for 3 ranks of 3 views
   bitwise the whole volume; 7e ``run_sfm(mesh=...)`` on phase 5's PNGs
   held to the unsharded run and to JAX's numbers; for 7b-7e the seconds
   of a warm-up and two timed runs beside the unsharded path's; 7f two
   processes on the one card in a gloo group (NCCL refuses two ranks on
   one device, gloo carries the all-gathers of CUDA tensors that the port
   uses): 7b at n = 2, and 7d at n = 2 on an 8-view (4x2) 1080p scene;
8. host streaming and the one-program forward: 8a phase 5's PNGs decoded
   by the native loader (``io/native_loader``, g++ built from this
   checkout) bitwise the PIL loader, both timed, and the decode backend;
   then, in a fresh process of this script whose loader build directory
   holds a file that does not open under the cached library's name (as a
   library built where libpng exists, copied to a host without it), the
   same decode: PIL's bytes with the loader's "decoding with PIL" warning
   where the headers are missing, or the native bytes from the library
   rebuilt in place where the toolchain is present;
   8b ``MVSPipeline.jitted()`` (one CUDA graph of ``run``, the cost-volume
   and consistency kernels inside it) at 9x1080x1920 with the default
   knobs: its capture timed, scene A and a second scene B
   (another disparity and seed) bitwise ``run()`` on every artifact, the
   best of two replays against the best of two eager runs, peak memory,
   and one replay and one eager run under ``torch.profiler`` (device
   kernels, launch calls, pageable host-to-device copies); 8c at 9x270x480
   phase 4's knobs and float (SfM-style) pair deltas through ``jitted()``,
   each bitwise ``run()``; 8d ``io/prefetcher.run_scenes`` over 4 scenes
   (phase 5's PNGs and scene B's, alternating; depth 2), each
   ``disp_full`` bitwise ``run()`` on the same decoded images, its views/s
   against decode-then-``run()`` on the same scenes, then once the
   ``tools.stream_scenes`` command on the same lists, repeated twice;
9. the measurement tools, each in its own process: 9a ``tools.bench
   --cell slice --runs 5 --profile`` (the graph's replays: median, spread,
   peak memory, launches, the breakdown by device op and idle gap); 9b
   ``tools.roofline --kernel all --shapes main``, each kernel's bound equal
   to phase 2's (the vote's to its two rounds' sum); 9c ``tools.memcheck`` at BASELINE's config 4 (49 views of
   2048x2048, 256 hypotheses, the view pair layout), which exits 0 when it
   fits and 3 when the allocator refuses a request; 9a's replays must
   launch the cost volume once, the consistency kernel 11 times, the SLIC
   assignment 6 and the update 5 times, ``smooth_cache`` 6 and
   ``smooth_moves`` 11 times, ``raster_planes`` 7 times, each chain
   kernel 5 times and ``lab_convert`` and ``extent_walk`` once each, and
   the cross-check's kernels and the edge snap never;
10. the tools ported last, each in its own process: 10a
   ``tools.profile_propagate --engine both`` at 9x1080x1920 (each
   component of sweep 0 under both engines with its ms, launches and share
   of the sweep, the gather engine's sweep also with its plain form,
   ``consistency_from_cache`` per batch, and the gather-rate ladder with
   each entry's bound), its
   total's state bitwise a plain ``refine.propagate_iteration`` call here
   on the same initial state; 10b ``tools.scaling_sweep --device cuda --n
   1`` (NCCL, one card: no scaling efficiency), every rank bitwise the
   unsharded run; 10c ``tools.memcheck --sharded 1`` at the slice's shape.

The kernels' bound counts, the card query, the profiler helper and the
strips composition are the package's (``tools/roofline``,
``device.card_name``, ``tools/profile_stages``).

The last two lines of standard output are the kernels' JSON record and
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import gc
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

# consistency kernel vs its plain twin: the same formula, sums over the
# samples taken in another order by the twin's reductions
CONS_RTOL, CONS_ATOL = 1e-5, 1e-6
# the consistency kernel's ms per sweep in its first form, one thread per
# (move, view, cell), on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md §6)
CONS_FIRST_FORM_MS = 3.494
FULL_H, FULL_W = 1080, 1920
TRUE_DISP = 40.0
# the port-vs-JAX pipeline bounds (tests/test_torch_pipeline.py): label
# agreement, disp_init agreement, disp_full within 1e-3
LABELS_AGREE, INIT_AGREE, FULL_CLOSE = 0.995, 0.99, 0.98
# the JAX package's run_sfm on this 9-view 1080p scene at its defaults, on
# the CPU: 20 pairs x 256 matches, all valid, and the RMS after bundle
# adjustment without and with the pose graph (px)
SFM_JAX_MATCHES, SFM_JAX_RMS_AFTER, SFM_JAX_PG_RMS_AFTER = 5120, 0.03349, 0.04820
# the card against those: share of the matches, |RMS - JAX's| in px, the
# largest ATE against the grid prior, and BA may not raise the RMS by more
# than SFM_RMS_SLACK px (tests/test_sfm_pipeline.py's bound)
SFM_MATCHES_SHARE, SFM_RMS_TOL, SFM_ATE_MAX, SFM_RMS_SLACK = 0.98, 0.01, 0.01, 1e-3
# the card against the port's CPU path at 9x270x480: keypoint agreement and
# the ATE between the two runs' poses
SFM_KP_AGREE, SFM_CARD_CPU_ATE = 0.99, 1e-3
# run --sfm: share of interior pixels within 1 of the scene's disparity
SFM_RUN_NEAR = 0.90
# the kernels' sources (csrc/<name>.cu), and the kernels of the JSON record
SOURCES = ("cost_volume", "sweep", "consistency", "slic", "smoothness", "raster", "chain", "color", "extent",
           "crosscheck")
KERNELS = ("cost_volume", "sweep", "consistency", "slic_assign", "slic_update", "slic_vote", "smooth_cache",
           "smooth_moves", "raster_planes", "chain_moves", "chain_update", "chain_refit", "lab_convert",
           "extent_walk", "fuse_warp", "fuse_vote", "edge_snap")
# the Lab, extent, raster and chain kernels' launches in one run of the
# slice: the Lab image and the extent once, the init's table, then a
# table, the candidates and two accept walks a sweep (5 sweeps), then
# fusion's map
PER_RUN = {"lab_convert": 1, "extent_walk": 1, "raster_planes": 1 + 5 + 1, "chain_moves": 5, "chain_update": 5,
           "chain_refit": 5}
# the kernels of the knobs off the defaults: the cross-check's warp and vote
# (cross_check) and the seeds' edge snap (edge_enable); 0 launches a run of
# the slice, 1 a run of the CLI with --cross-check or edge_enable=true
OFF_DEFAULTS = ("fuse_warp", "fuse_vote", "edge_snap")
# the cross-check's kernel entries the main path's 9x1080x1920 launches run
# (tools.sass names): 32-bit offsets, the warp's 2 rows of 3 views a thread,
# the vote's 9 candidates in registers; SLIC's vote: a run of 4 pixels in
# each of 4 rows a thread from the L1 window
MAIN_ENTRIES = {"fuse_warp": "fuse_warp_kernel<2, 3, int>", "fuse_vote": "fuse_vote_kernel<9, int>",
                "slic_vote": "vote_kernel<4>"}
# the sweeps whose raster and chain calls phase 2 holds to their plain
# forms (each from the initial state at that sweep's reach)
SWEEPS = (0, 1, 2, 3, 4)
# phase 8's scene B: the scene generator at another disparity and seed
STREAM_B_DISP, STREAM_B_SEED = 36.0, 7
# phase 8a's process with a stale cached loader library: seconds it may take
STALE_LOADER_TIMEOUT_S = 180
# phase 8's stream tool, seconds it may take
STREAM_TOOL_TIMEOUT_S = 300
# phase 7f's two gloo ranks on the one card: seconds they may take
GLOO_TIMEOUT_S = 420
# phase 9's tools: seconds each may take, the timed runs of 9a, and 9c's
# configuration (BASELINE's config 4, as tools/memcheck.py spells it) and
# the exit code by which memcheck answers that it does not fit
TOOL_TIMEOUT_S, BENCH_RUNS = 300, 5
CONFIG4 = ["2048", "2048", "array_width=7", "array_height=7", "min_disp=0", "max_disp=255", "inc=1",
           "--pair-layout", "view"]
MEMCHECK_OOM_EXIT = 3
# phase 10b: the scaling sweep's largest rank count on the one card
SWEEP_N = 1


def _scene(h: int, w: int):
    from cl_multiview_stereo_tpu_torch import SystemSettings, fronto_parallel_scene

    s = SystemSettings()
    rgb, _ = fronto_parallel_scene(h, w, 3, 3, disp=TRUE_DISP, bl_ratio=s.bl_ratio)
    return s, rgb


def phase_build() -> None:
    from cl_multiview_stereo_tpu_torch.kernels import build

    # every kernel from this checkout's sources, with ptxas's report
    shutil.rmtree(build.BUILD_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        logs = dict(zip(SOURCES, (log for _, log in pool.map(build.build, SOURCES))))
    for name in SOURCES:
        build.load(name)
    print(f"[1] built {', '.join(SOURCES)} in {time.perf_counter() - t0:.2f} s")
    for name in SOURCES:
        for line in logs[name].splitlines():
            if "entry function" in line or "registers" in line or "spill" in line:
                print(f"[1] ptxas {name}: {line.strip()}")
    # every kernel but the cost volume builds without spills
    for name in SOURCES[1:]:
        spills = [ln.strip() for ln in logs[name].splitlines()
                  if any(int(n) for n in re.findall(r"(\d+) bytes spill", ln))]
        if spills:
            raise AssertionError(f"{name} kernel spills: {spills}")
    # the cost volume's and the sweep's designs: two blocks share an SM, one
    # stages while the other computes
    for name in ("cost_volume", "sweep"):
        fn = getattr(build.load(name), f"{name}_blocks_per_sm")
        fn.argtypes, fn.restype = [ctypes.POINTER(ctypes.c_int)], ctypes.c_int
        blocks = ctypes.c_int(0)
        rc = fn(ctypes.byref(blocks))
        if rc != 0 or blocks.value < 2:
            raise AssertionError(f"{name}: {blocks.value} blocks per SM (CUDA error {rc}), expected >= 2")
        print(f"[1] {name}: {blocks.value} blocks per SM")
    # the Lab kernel's persistent grid is this times the SMs; the extent
    # kernel's block is a tile of cells, 8 threads a cell
    fn = build.load("color").lab_convert_blocks_per_sm
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)], ctypes.c_int
    for is_float, dtype in enumerate(("uint8", "float32")):
        blocks = ctypes.c_int(0)
        rc = fn(is_float, ctypes.byref(blocks))
        if rc != 0 or blocks.value < 1:
            raise AssertionError(f"lab_convert ({dtype}): {blocks.value} blocks per SM (CUDA error {rc})")
        print(f"[1] lab_convert ({dtype} in): {blocks.value} blocks of 256 threads per SM")
    fn = build.load("extent").extent_walk_blocks_per_sm
    fn.argtypes, fn.restype = [ctypes.POINTER(ctypes.c_int)] * 3, ctypes.c_int
    blocks, ty, tx = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    rc = fn(ctypes.byref(blocks), ctypes.byref(ty), ctypes.byref(tx))
    if rc != 0 or blocks.value < 1:
        raise AssertionError(f"extent_walk: {blocks.value} blocks per SM (CUDA error {rc})")
    print(f"[1] extent_walk: {blocks.value} blocks of {ty.value} x {tx.value} cells ({8 * ty.value * tx.value} "
          f"threads) per SM")


def phase_kernel_vs_plain(card: str) -> dict:
    import torch

    from cl_multiview_stereo_tpu_torch import (
        SystemSettings,
        build_disp_levels,
        fronto_parallel_scene,
    )
    from cl_multiview_stereo_tpu_torch.ops import cost_volume
    from cl_multiview_stereo_tpu_torch.tools.roofline import bound, cost_volume_work, depth_inputs, in_turns

    dev = torch.device("cuda")
    cases = [
        ("full 9x1080x1920", SystemSettings(), (FULL_H, FULL_W), TRUE_DISP),
        ("odd 4x61x45", SystemSettings(array_width=2, array_height=2, min_disp=4, max_disp=11), (61, 45), 7.0),
        # ragged 8x8-cell tiles, the largest superpixels: sample steps up to 7
        ("ragged 9x543x967 S16", SystemSettings(spixl_size=16), (543, 967), TRUE_DISP),
    ]
    rec = {}
    for label, s, (h, w), disp in cases:
        rgb, _ = fronto_parallel_scene(h, w, s.array_width, s.array_height, disp=disp, bl_ratio=s.bl_ratio)
        lab, centers, step = depth_inputs(rgb, s, dev)
        levels = torch.as_tensor(build_disp_levels(s), device=dev)
        args = (lab, centers, step, levels, s.array_width, s.bl_ratio, s.neib_hor, s.neib_ver)
        kern = cost_volume.superpixel_cost_volume(*args)
        plain = cost_volume.cost_volume_reference(*args)
        torch.cuda.synchronize()
        if not torch.equal(kern, plain):
            bad = int((kern != plain).sum())
            raise AssertionError(f"cost_volume {label}: kernel and plain differ at {bad} outputs")
        k, p = in_turns(lambda: cost_volume.superpixel_cost_volume(*args),
                        lambda: cost_volume.cost_volume_reference(*args), 10, 2)
        bound_ms, bound_by = bound(*cost_volume_work(lab, centers, step, levels, s, kern))
        print(f"[2] cost_volume {label}: shape {tuple(kern.shape)} bitwise equal, step max "
              f"{step.max().item():.1f}, kernel {k:.3f} ms, bound {bound_ms:.4g} ms ({bound_by}), "
              f"plain {p:.3f} ms ({card})")
        rec[label] = dict(ms=k, plain_ms=p, bound_ms=bound_ms, bound_by=bound_by)
    return rec["full 9x1080x1920"] | {"max_abs_err": 0.0}


def phase_sweep_vs_plain(card: str) -> dict:
    import numpy as np
    import torch

    from cl_multiview_stereo_tpu_torch import SystemSettings
    from cl_multiview_stereo_tpu_torch.models.plane_sweep import plane_sweep_reference, sweep_args
    from cl_multiview_stereo_tpu_torch.ops import sweep
    from cl_multiview_stereo_tpu_torch.ops.color import rgb_to_lab
    from cl_multiview_stereo_tpu_torch.tools.roofline import bound, in_turns, sweep_work

    dev = torch.device("cuda")
    s_full, rgb = _scene(FULL_H, FULL_W)
    rng = np.random.default_rng(0)
    odd = SystemSettings(array_width=3, array_height=3, min_disp=10, max_disp=20, inc=1)
    cases = [
        # the slice's scene, the reference ladder (31) and pairs (40)
        ("full 9x1080x1920 D31 P40", rgb_to_lab(torch.as_tensor(rgb, device=dev)).contiguous(),
         *sweep_args(s_full), s_full.bl_ratio),
        # tools/roofline.py's case: 2 views, D = 64, horizontal pairs
        ("roofline 2x1080x1920 D64 P2",
         torch.as_tensor(rng.uniform(0, 100, (2, FULL_H, FULL_W, 3)).astype(np.float32), device=dev),
         [float(d) for d in range(4, 68)], ((0, 1, 1, 0), (1, 0, -1, 0)), 1.0),
        ("odd 9x53x131 D11 P40",
         torch.as_tensor(rng.uniform(0, 100, (9, 53, 131, 3)).astype(np.float32), device=dev),
         *sweep_args(odd), odd.bl_ratio),
    ]
    rec = {}
    radius = 2
    for label, lab, ladder, pairs, bl in cases:
        args = (lab, [float(d) for d in ladder], pairs, bl, radius)
        kd, kc = sweep.plane_sweep(*args)
        pd, pc = plane_sweep_reference(*args)
        torch.cuda.synchronize()
        if not (torch.equal(kd, pd) and torch.equal(kc, pc)):
            bad = int((kd != pd).sum() + (kc != pc).sum())
            raise AssertionError(f"sweep {label}: kernel and plain differ at {bad} outputs")
        k, p = in_turns(lambda: sweep.plane_sweep(*args), lambda: plane_sweep_reference(*args), 3, 1)
        bound_ms, bound_by = bound(*sweep_work(*args))
        print(f"[2] sweep {label}: bitwise equal, kernel {k:.3f} ms, bound {bound_ms:.4g} ms "
              f"({bound_by}), plain {p:.3f} ms ({card})")
        rec[label] = dict(ms=k, plain_ms=p, bound_ms=bound_ms, bound_by=bound_by)
    return rec["full 9x1080x1920 D31 P40"] | {"max_abs_err": 0.0}


def _cons_check(tag: str, kern, plain, k_fn, p_fn, work, card: str) -> dict:
    """One consistency launch against its plain twin on the same inputs:
    NaN at the same places, the rest within CONS_RTOL/CONS_ATOL; both
    timed in turns, the bound beside them."""
    import torch

    from cl_multiview_stereo_tpu_torch.tools.roofline import bound, in_turns

    torch.cuda.synchronize()
    if not torch.equal(torch.isnan(kern), torch.isnan(plain)):
        raise AssertionError(f"consistency {tag}: kernel and plain are NaN at different places")
    if not torch.allclose(kern, plain, rtol=CONS_RTOL, atol=CONS_ATOL, equal_nan=True):
        raise AssertionError(f"consistency {tag}: kernel and plain disagree")
    both = torch.isfinite(kern) & torch.isfinite(plain)
    err = (kern - plain).abs()[both].max().item()
    km, pm = in_turns(k_fn, p_fn, 10, 1)
    bound_ms, bound_by = bound(*work)
    print(f"[2] consistency {tag}: shape {tuple(kern.shape)} max_abs_err {err:.3e} "
          f"NaN {int(torch.isnan(kern).sum())} kernel {km:.3f} ms, bound {bound_ms:.4g} ms ({bound_by}), "
          f"plain {pm:.3f} ms ({card})")
    return dict(max_abs_err=err, ms=km, plain_ms=pm, bound_ms=bound_ms, bound_by=bound_by)


def phase_consistency_vs_plain(card: str) -> dict:
    """The consistency kernel against its plain twin at the slice's size:
    the gather rule on the main path's launches (the init state's, M = 1,
    and sweep 0's update and refit phases, M = 8), the strips rule on the
    strips engine's, the row window of a tile of 3 (``spatial``'s
    "auto" halo) and a block of 3 views against the whole table.  Returns
    the main path's record: sweep 0's two gather launches."""
    import torch

    from cl_multiview_stereo_tpu_torch import RefinementSchedule
    from cl_multiview_stereo_tpu_torch.ops import consistency, refine
    from cl_multiview_stereo_tpu_torch.parallel import spatial
    from cl_multiview_stereo_tpu_torch.parallel.sharded_pipeline import own_pairs
    from cl_multiview_stereo_tpu_torch.tools.roofline import consistency_work, refine_calls

    s, rgb = _scene(FULL_H, FULL_W)
    recs = {}
    for engine in ("strips", "gather"):
        calls = refine_calls(s, rgb, "cuda", engine)
        for phase, (a, k) in calls.items():
            if engine == "strips" and phase == "init":
                continue  # the init state is the gather rule's under every engine
            tag = f"{engine} rule, {phase} (M = {a[2].shape[0]})"
            recs[(engine, phase)] = _cons_check(
                tag, consistency.consistency_moves(*a, **k), consistency.consistency_moves_reference(*a, **k),
                lambda a=a, k=k: consistency.consistency_moves(*a, **k),
                lambda a=a, k=k: consistency.consistency_moves_reference(*a, **k),
                consistency_work(*a, k["pairs"]), card)
    per = {e: {f: sum(recs[(e, p)][f] for p in ("update", "refit")) for f in ("ms", "plain_ms", "bound_ms")}
           for e in ("strips", "gather")}
    print(f"[2] consistency per sweep (2 launches): gather rule kernel {per['gather']['ms']:.3f} ms, strips rule "
          f"{per['strips']['ms']:.3f} ms, bound {per['gather']['bound_ms']:.4g} ms; its first form took "
          f"{CONS_FIRST_FORM_MS} ms on an NVIDIA H100 80GB HBM3, 700.00 W ({card})")

    # the sharded paths' launch modes on sweep 0's gather update call
    (ctx, cache, d_c, n_c), k = calls["update"]
    sched = RefinementSchedule.create(s)
    n_tiles, t = 3, 1
    v, h, w = ctx.labels.shape
    bh, bhp = ctx.center.shape[1] // n_tiles, h // n_tiles
    halo = spatial.refine_halo(ctx, sched, k["pairs"], "auto")
    row_lo, rows = t * bhp - halo, bhp + 2 * halo
    if row_lo < 0 or row_lo + rows > h:
        raise AssertionError(f"consistency: a halo of {halo} rows leaves the image from tile {t} of {n_tiles}")
    win = cache.ras.view(v, h, w, 4)[:, row_lo:row_lo + rows].contiguous().view(-1, 4)
    blk = spatial.block_context(ctx, t, n_tiles)
    a = (blk, cache._replace(ras=win), *(x[:, :, t * bh:(t + 1) * bh].contiguous() for x in (d_c, n_c)))
    kw = dict(k, img_hw=(h, w), ras_rows=(row_lo, rows))
    recs["window"] = _cons_check(
        f"gather rule, row window of tile {t} of {n_tiles} (halo {halo} rows)",
        consistency.consistency_moves(*a, **kw), consistency.consistency_moves_reference(*a, **kw),
        lambda: consistency.consistency_moves(*a, **kw), lambda: consistency.consistency_moves_reference(*a, **kw),
        consistency_work(*a, kw["pairs"]), card)
    v0, nv = 3, 3
    vctx = refine.RefineContext(*(x[v0:v0 + nv].contiguous() if x.ndim > 2 else x for x in ctx))
    a = (vctx, cache, d_c[:, v0:v0 + nv].contiguous(), n_c[:, v0:v0 + nv].contiguous())
    kw = dict(k, pairs=own_pairs(k["pairs"], v0, nv))
    block = consistency.consistency_moves(*a, **kw)
    recs["block"] = _cons_check(
        f"gather rule, views {v0}..{v0 + nv - 1} against the whole table", block,
        consistency.consistency_moves_reference(*a, **kw), lambda: consistency.consistency_moves(*a, **kw),
        lambda: consistency.consistency_moves_reference(*a, **kw), consistency_work(*a, kw["pairs"]), card)
    if not torch.equal(block, consistency.consistency_moves(ctx, cache, d_c, n_c, **k)[:, v0:v0 + nv]):
        raise AssertionError("consistency: the view block's launch is not the whole launch's rows")
    print(f"[2] consistency view block bitwise equal to the whole launch's rows ({card})")
    return dict(per["gather"], bound_by=recs[("gather", "update")]["bound_by"],
                max_abs_err=max(r["max_abs_err"] for r in recs.values()))


@functools.cache
def _sass_report(src: str) -> list[dict]:
    """``tools.sass``'s records of ``csrc/<src>.cu``, compiled once a run."""
    from cl_multiview_stereo_tpu_torch.kernels import build
    from cl_multiview_stereo_tpu_torch.tools import sass

    return sass.report(src, build.CSRC)


def _reset_slic() -> None:
    from cl_multiview_stereo_tpu_torch.ops import slic

    slic.LAUNCHES.update(dict.fromkeys(slic.LAUNCHES, 0))


def phase_slic_vs_plain(card: str) -> dict:
    """SLIC's three kernels against their plain forms on the 9-view 1080p
    scene's converged labels and map (``tools.roofline.slic_inputs``, the
    roofline tool's inputs too): the vote on both of ``segment``'s rounds
    under ``enforce_connectivity`` (``tools.roofline.vote_rounds``), and
    also on labels with 40 % flipped, where it fires often.  Returns each
    kernel's record, one launch; the vote's round 1, each round's in
    ``rounds``."""
    import torch

    from cl_multiview_stereo_tpu_torch.tools.roofline import (
        ITERS,
        bound,
        cuda_ms,
        in_turns,
        slic_calls,
        slic_inputs,
        slic_members,
        slic_work,
        vote_rounds,
    )

    s, rgb = _scene(FULL_H, FULL_W)
    lab, geom, p, labels, spmap = slic_inputs(rgb, s, "cuda")
    v, h, w = labels.shape
    recs = {}
    for name in ("slic_assign", "slic_update"):
        kern, plain = slic_calls(name, lab, geom, p, labels, spmap)
        got, want = kern(), plain()
        torch.cuda.synchronize()
        err, lib_ms = 0.0, None
        if name == "slic_update":
            for f in ("center", "count", "color"):
                _require_equal(f"[2] slic update {f}", getattr(got, f), getattr(want, f))
            verdict = "centre, count and colour bitwise"
            # the one PyTorch call that computes the update's sums (every
            # member of these labels lies within one cell of its home
            # cell); atomics, so its order varies: timed, used nowhere
            n = geom.map_h * geom.map_w
            idx = (labels.long() + torch.arange(v, device="cuda")[:, None, None] * n).reshape(-1)
            xs = torch.arange(w, device="cuda", dtype=torch.float32).expand(v, h, w)
            ys = torch.arange(h, device="cuda", dtype=torch.float32)[:, None].expand(v, h, w)
            planes = torch.stack([lab[..., 0], lab[..., 1], lab[..., 2], xs, ys, torch.ones_like(xs)]).reshape(6, -1)

            def library():
                return torch.zeros((6, v * n), device="cuda").index_add_(1, idx, planes)

            lib_sums = library()
            if not torch.equal(lib_sums[5].reshape(v, geom.map_h, geom.map_w), want.count):
                raise AssertionError("[2] index_add_'s counts are not the update's")
            lib_ms = cuda_ms(library, ITERS[name][0])
            members = slic_members(labels, geom)
            verdict += f"; index_add_ {lib_ms:.3f} ms ({members} of {v * h * w} pixels members)"
        else:
            _require_equal(f"[2] slic {name}", got, want)
            verdict = "bitwise"
        k_ms, p_ms = in_turns(kern, plain, *ITERS[name])
        b_ms, by = bound(*slic_work(name, lab, labels, geom))
        print(f"[2] slic {name[5:]} at {v}x{h}x{w} S{geom.spixl_size} (converged map): {verdict}; kernel "
              f"{k_ms:.3f} ms, bound {b_ms:.4g} ms ({by}), plain {p_ms:.3f} ms ({card})")
        recs[name] = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=by, library_ms=lib_ms)
    t0 = time.perf_counter()
    code = {r["kernel"]: r for r in _sass_report("slic")}[MAIN_ENTRIES["slic_vote"]]
    note = (f"{MAIN_ENTRIES['slic_vote']}: {code['registers']} registers, {code['spill_bytes']} spill bytes, "
            f"{code['sass_instructions']} SASS instructions")
    parts = {"SASS report": time.perf_counter() - t0}
    rounds = []
    for call, x in vote_rounds(labels).items():
        t0 = time.perf_counter()
        kern, plain = slic_calls("slic_vote", lab, geom, p, x, spmap)
        got = kern()
        _require_equal(f"[2] slic vote {call}", got, plain())
        k_ms, p_ms = in_turns(kern, plain, *ITERS["slic_vote"])
        b_ms, by = bound(*slic_work("slic_vote", lab, x, geom))
        print(f"[2] slic vote {call} at {v}x{h}x{w}: bitwise, {int((got != x).sum())} labels changed; kernel "
              f"{k_ms:.4f} ms, bound {b_ms:.4g} ms ({by}), share {b_ms / k_ms:.3f}, plain {p_ms:.3f} ms; {note} "
              f"({card})")
        rounds.append(dict(call=call, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, share=b_ms / k_ms))
        parts[call] = time.perf_counter() - t0
    # one launch, round 1's, as every kernel's record is one launch; both
    # rounds' times beside it (9b holds their bounds' sum to the roofline
    # tool's record)
    recs["slic_vote"] = dict(rounds[0], max_abs_err=0.0, bound_by=by, library_ms=None, rounds=rounds,
                             round_ms=[r["ms"] for r in rounds])
    t0 = time.perf_counter()
    gen = torch.Generator(device="cpu").manual_seed(2)
    flip = (torch.rand(labels.shape, generator=gen) < 0.4).cuda()
    other = torch.randint(0, geom.map_h * geom.map_w, labels.shape, generator=gen, dtype=torch.int32).cuda()
    noisy = torch.where(flip, other, labels)
    kern, plain = slic_calls("slic_vote", lab, geom, p, noisy, spmap)
    got = kern()
    _require_equal("[2] slic vote on noisy labels", got, plain())
    print(f"[2] slic vote on 40 % flipped labels: bitwise, {float((got != noisy).float().mean()):.4f} of the "
          f"labels changed ({card})")
    parts["noisy labels"] = time.perf_counter() - t0
    print(f"[2] the vote's checks took {sum(parts.values()):.2f} s: "
          + ", ".join(f"{k} {t:.2f} s" for k, t in parts.items()))
    return recs


def _reset_smoothness() -> None:
    from cl_multiview_stereo_tpu_torch.ops import smoothness

    smoothness.LAUNCHES.update(dict.fromkeys(smoothness.LAUNCHES, 0))


def phase_smoothness_vs_plain(card: str) -> dict:
    """The smoothness kernels against their plain forms on the main path's
    calls at the slice's size (``tools.roofline.smooth_calls``): the init's
    cache and state (M = 1), sweep 0's cache and its update and refit
    phases, and sweep 4's (the shortest reach, T = 16, and the most update
    moves, M = 16), each run from the initial state: the routed cache's
    table and ring bitwise the plain cache's, nothing T-wide allocated, and
    each routed call's scores bitwise the plain scorer's on the plain cache.
    Returns
    each kernel's record: sweep 0's cache, and sweep 0's two
    ``smooth_moves`` launches summed, as ``tools.roofline`` counts them."""
    import torch

    from cl_multiview_stereo_tpu_torch.ops.smoothness import _CACHE_FIELDS
    from cl_multiview_stereo_tpu_torch.tools.roofline import ITERS, bound, in_turns, smooth_calls, smooth_case

    s, rgb = _scene(FULL_H, FULL_W)
    recs = {}
    for tag, (kernel, a, k, plain_a) in smooth_calls(s, rgb, "cuda", sweeps=(0, 4)).items():
        kern, plain, work = smooth_case(kernel, a, k, plain_a)
        got, want = kern(), plain()
        torch.cuda.synchronize()
        if kernel == "smooth_cache":
            for f in (*_CACHE_FIELDS, "gammas"):
                _require_equal(f"[2] smooth_cache {tag} {f}", getattr(got, f), getattr(want, f), equal_nan=True)
            wide = [f for f in ("tap_ax", "tap_ay", "tap_d", "tap_sim", "wn") if getattr(got, f) is not None]
            if wide or got.row0 != want.row0:
                raise AssertionError(f"[2] smooth_cache {tag}: T-wide fields {wide}, row0 {got.row0}")
            shape = f"table {tuple(got.cell_table.shape)} T {got.gammas.numel()}, nothing T-wide"
            nan = int(torch.isnan(got.cell_table).sum())
        else:
            _require_equal(f"[2] smooth_moves {tag}", got, want, equal_nan=True)
            shape = f"{tuple(got.shape)} M {got.shape[0]} T {a[0].gammas.numel()}"
            nan = int(torch.isnan(got).sum())
        k_ms, p_ms = in_turns(kern, plain, *ITERS[kernel])
        b_ms, by = bound(*work)
        print(f"[2] {kernel} {tag} {shape}: bitwise (NaN {nan}); kernel {k_ms:.3f} ms, bound {b_ms:.4g} ms "
              f"({by}), plain {p_ms:.3f} ms ({card})")
        recs[tag] = dict(max_abs_err=0.0, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=by)
        del got, want
    moves = [recs["sweep 0 update"], recs["sweep 0 refit"]]
    per = {f: sum(r[f] for r in moves) for f in ("ms", "plain_ms", "bound_ms")}
    print(f"[2] smoothness per sweep 0 (one cache, two move launches): kernels "
          f"{recs['sweep 0 cache']['ms'] + per['ms']:.3f} ms, bound "
          f"{recs['sweep 0 cache']['bound_ms'] + per['bound_ms']:.4g} ms, plain forms "
          f"{recs['sweep 0 cache']['plain_ms'] + per['plain_ms']:.3f} ms ({card})")
    return {"smooth_cache": recs["sweep 0 cache"],
            "smooth_moves": dict(per, max_abs_err=0.0, bound_by=moves[0]["bound_by"])}


def _reset_counts() -> None:
    """Sets the launch counts of PER_RUN's kernels to 0."""
    from cl_multiview_stereo_tpu_torch.ops import chain, color, raster, superpixel

    for counts in (color.LAUNCHES, superpixel.LAUNCHES, raster.LAUNCHES, chain.LAUNCHES):
        counts.update(dict.fromkeys(counts, 0))


def _off_defaults() -> dict:
    """The launch counts of OFF_DEFAULTS' kernels."""
    from cl_multiview_stereo_tpu_torch.ops import crosscheck, slic

    return {name: {**crosscheck.LAUNCHES, **slic.LAUNCHES}[name] for name in OFF_DEFAULTS}


def _reset_off_defaults() -> None:
    """Sets the launch counts of OFF_DEFAULTS' kernels to 0."""
    from cl_multiview_stereo_tpu_torch.ops import crosscheck, slic

    crosscheck.LAUNCHES.update(dict.fromkeys(crosscheck.LAUNCHES, 0))
    slic.LAUNCHES["edge_snap"] = 0


def _counts() -> dict:
    """The launch counts of PER_RUN's kernels."""
    from cl_multiview_stereo_tpu_torch.ops import chain, color, raster, superpixel

    return {**color.LAUNCHES, **superpixel.LAUNCHES, **raster.LAUNCHES, **chain.LAUNCHES}


def phase_chain_vs_plain(card: str) -> dict:
    """The plane rasterization and the move chain's kernels against their
    plain forms on the main path's calls at the slice's size
    (``tools.roofline.chain_calls``): the init's table, sweeps 0-4's table,
    candidates and two accept walks, each sweep run from the initial state,
    and fusion's map of that state; every output bitwise (NaN at the same
    places); then ``chain_update``'s five launches summed against their
    bounds.  Returns each kernel's record: its launch of sweep 0."""
    import torch

    from cl_multiview_stereo_tpu_torch.tools.roofline import ITERS, _leaves, bound, chain_calls, chain_case, in_turns

    s, rgb = _scene(FULL_H, FULL_W)
    recs = {}
    for tag, (wrapper, a, k) in chain_calls(s, rgb, "cuda", sweeps=SWEEPS).items():
        kernel, kern, plain, work = chain_case(wrapper, a, k)
        got, want = _leaves(kern()), _leaves(plain())
        torch.cuda.synchronize()
        if [(g.shape, g.dtype) for g in got] != [(w.shape, w.dtype) for w in want]:
            raise AssertionError(f"[2] {kernel} {tag}: outputs {[g.shape for g in got]}, plain {[w.shape for w in want]}")
        for i, (g, w) in enumerate(zip(got, want)):
            _require_equal(f"[2] {kernel} {tag} output {i}", g, w, equal_nan=g.is_floating_point())
        nan = sum(int(torch.isnan(g).sum()) for g in got if g.is_floating_point())
        k_ms, p_ms = in_turns(kern, plain, *ITERS[kernel])
        b_ms, by = bound(*work)
        print(f"[2] {kernel} {tag} {tuple(got[0].shape)}: bitwise (NaN {nan}); kernel {k_ms:.4f} ms, bound "
              f"{b_ms:.4g} ms ({by}), plain {p_ms:.3f} ms ({card})")
        recs[tag] = dict(max_abs_err=0.0, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=by)
        del got, want
    parts = [recs[f"sweep 0 {p}"] for p in ("table", "candidates", "update", "refit")]
    print(f"[2] raster and chain per sweep 0 (table, candidates, two walks): kernels "
          f"{sum(r['ms'] for r in parts):.4f} ms, bound {sum(r['bound_ms'] for r in parts):.4g} ms, plain forms "
          f"{sum(r['plain_ms'] for r in parts):.3f} ms ({card})")
    walk_ms = [recs[f"sweep {it} update"]["ms"] for it in SWEEPS]
    walk_bound = [recs[f"sweep {it} update"]["bound_ms"] for it in SWEEPS]
    print(f"[2] chain_update over sweeps {SWEEPS[0]}-{SWEEPS[-1]}: kernel {', '.join(f'{t:.4f}' for t in walk_ms)} "
          f"ms, bound {', '.join(f'{t:.4f}' for t in walk_bound)} ms; the {len(SWEEPS)} launches "
          f"{sum(walk_ms):.4f} ms against {sum(walk_bound):.4f} ms, share {sum(walk_bound) / sum(walk_ms):.3f} "
          f"({card})")
    fmap = recs["fusion map"]
    tables = ", ".join(f"{recs[f'sweep {it} table']['ms']:.4f}" for it in SWEEPS)
    print(f"[2] raster_planes, fusion map: kernel {fmap['ms']:.4f} ms against {fmap['bound_ms']:.4f} ms, share "
          f"{fmap['bound_ms'] / fmap['ms']:.3f}; sweeps {SWEEPS[0]}-{SWEEPS[-1]}'s tables {tables} ms ({card})")
    return {"raster_planes": dict(recs["sweep 0 table"], map_ms=fmap["ms"], map_bound_ms=fmap["bound_ms"]),
            "chain_moves": recs["sweep 0 candidates"], "chain_update": recs["sweep 0 update"],
            "chain_refit": recs["sweep 0 refit"]}


def _require_same_bits(tag: str, got, want) -> None:
    """float32 tensors equal bit for bit (NaN payloads and signed zeros too)."""
    import torch

    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{tag}: {tuple(got.shape)} {got.dtype}, plain {tuple(want.shape)} {want.dtype}")
    _require_equal(tag, got.view(torch.int32), want.view(torch.int32))


def _instructions_per_item() -> dict:
    """SASS instructions an item of the Lab and extent kernels, from
    ``tools.sass`` (a fresh build of each source): for ``lab_convert`` a
    pixel, the largest inner loop of ``lab_kernel<unsigned char>`` (the
    element path's loop, one pixel a trip, every branch of its three powf
    counted once); for ``extent_walk`` a ray (one thread), the whole
    ``extent_kernel`` counted once (its walk loop runs S - 1 trips).
    Static counts: a note beside the byte bound."""
    from cl_multiview_stereo_tpu_torch.kernels import build
    from cl_multiview_stereo_tpu_torch.tools import sass

    lab = {r["kernel"]: r for r in sass.report("color", build.CSRC)}["lab_kernel<unsigned char>"]
    ext = {r["kernel"]: r for r in sass.report("extent", build.CSRC)}["extent_kernel"]
    return {"lab_convert": max(loop["instructions"] for loop in lab["inner_loops"]),
            "extent_walk": ext["sass_instructions"]}


def _max_sm_clock_ghz() -> float:
    """The card's top SM clock, ``nvidia-smi --query-gpu=clocks.max.sm``."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0]) / 1e3


def phase_lab_extent_vs_plain(card: str) -> dict:
    """The Lab conversion and the extent walk against their plain forms on
    the card: ``lab_convert`` on the slice's 9-view 1080p scene and on every
    uint8 RGB triple once, ``extent_walk`` on that scene's converged labels
    and map (``tools.roofline.slic_inputs``, the roofline tool's inputs
    too); each bitwise.  Beside each kernel's byte bound, its issue time
    (``tools.roofline.issue_ms``) at the card's top SM clock.  Returns each
    kernel's record on the scene."""
    import torch

    from cl_multiview_stereo_tpu_torch.ops import superpixel
    from cl_multiview_stereo_tpu_torch.ops.color import rgb_to_lab, rgb_to_lab_reference
    from cl_multiview_stereo_tpu_torch.tools.roofline import (
        ITERS,
        bound,
        extent_work,
        in_turns,
        issue_ms,
        lab_work,
        slic_inputs,
    )

    s, rgb = _scene(FULL_H, FULL_W)
    x = torch.as_tensor(rgb, device="cuda")
    code = torch.arange(2**24, dtype=torch.int32, device="cuda")
    triples = torch.stack([code >> 16, (code >> 8) & 255, code & 255], dim=-1).to(torch.uint8).reshape(4096, 4096, 3)
    _require_same_bits("[2] lab_convert, every uint8 triple", rgb_to_lab(triples), rgb_to_lab_reference(triples))
    print(f"[2] lab_convert on every uint8 RGB triple (4096x4096x3): bitwise the plain form ({card})")
    del code, triples
    _, geom, _, labels, spmap = slic_inputs(rgb, s, "cuda")
    ex = (labels, spmap.center, geom)
    cases = {
        "lab_convert": (f"{tuple(x.shape)} uint8", lambda: rgb_to_lab(x), lambda: rgb_to_lab_reference(x),
                        lambda out: lab_work(x, out)),
        "extent_walk": (f"{tuple(labels.shape)} S{geom.spixl_size} -> {geom.map_h}x{geom.map_w} cells",
                        lambda: superpixel.superpixel_extent(*ex), lambda: superpixel.superpixel_extent_reference(*ex),
                        lambda out: extent_work(*ex, out)),
    }
    per_item, ghz = _instructions_per_item(), _max_sm_clock_ghz()
    items = {"lab_convert": x.numel() // 3, "extent_walk": 8 * spmap.center.numel() // 2}
    recs = {}
    for name, (label, kern, plain, work) in cases.items():
        got, want = kern(), plain()
        torch.cuda.synchronize()
        if name == "lab_convert":
            _require_same_bits(f"[2] {name} {label}", got, want)
        else:
            _require_equal(f"[2] {name} {label}", got, want)
        k_ms, p_ms = in_turns(kern, plain, *ITERS[name])
        b_ms, by = bound(*work(got))
        i_ms = issue_ms(per_item[name], items[name], ghz)
        print(f"[2] {name} {label}: bitwise; kernel {k_ms:.4f} ms, bound {b_ms:.4g} ms ({by}), plain "
              f"{p_ms:.3f} ms; issue {i_ms:.4f} ms ({per_item[name]} SASS instructions a "
              f"{'pixel' if name == 'lab_convert' else 'ray'} x {items[name]} at {ghz:.3f} GHz, a note) ({card})")
        recs[name] = dict(max_abs_err=0.0, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=by)
        del got, want
    return recs


def phase_crosscheck_snap_vs_plain(card: str) -> dict:
    """The cross-check's warp and vote and the seeds' edge snap against
    their plain forms on the card: ``fuse_warp`` on the slice's refined
    disparity at 9x1080x1920 (``MVSPipeline.run``'s ``disp_full``;
    ``tools.roofline.fusion_inputs``, the roofline tool's inputs too),
    ``fuse_vote`` on that map and its warp, ``edge_snap`` on the scene's Lab
    and SLIC's seed centres (``tools.roofline.snap_inputs``); each output
    bitwise (NaN at the same places); the vote's work under both walks, in
    view order (candidates looked at, lookups made) and in descending order
    (values scored, lookups made), and the bound from the lesser, the view
    order's beside it (``tools.roofline.fuse_vote_work``).  Beside each bound, the
    kernel's static SASS instructions and those of its inner loops
    (``tools.sass``), and for the snap, straight-line code a centre, its
    issue time at the card's top SM clock.  Returns each kernel's record."""
    import torch

    from cl_multiview_stereo_tpu_torch.ops import slic
    from cl_multiview_stereo_tpu_torch.tools.roofline import (
        ITERS,
        bound,
        edge_snap_work,
        fusion_case,
        fusion_inputs,
        in_turns,
        issue_ms,
        snap_inputs,
    )

    t_phase = time.perf_counter()
    s, rgb = _scene(FULL_H, FULL_W)
    disp_full, disp_proj, geo = fusion_inputs(s, rgb, "cuda")
    lab, spmap = snap_inputs(rgb, s, "cuda")
    v, h, w = disp_full.shape
    cases = {name: fusion_case(name, disp_full, disp_proj, geo) for name in ("fuse_warp", "fuse_vote")}
    cases["edge_snap"] = (lambda: slic.edge_snap(lab, spmap), lambda: slic.edge_snap_reference(lab, spmap),
                          edge_snap_work(lab, spmap, slic.edge_snap(lab, spmap)))
    code = {r["kernel"]: r for src in ("crosscheck", "slic") for r in _sass_report(src)}
    seeds = spmap.center.numel() // 2
    snap_issue = issue_ms(code["edge_snap_kernel"]["sass_instructions"], seeds, _max_sm_clock_ghz())
    recs = {}
    for name, (kern, plain, work) in cases.items():
        got, want = kern(), plain()
        torch.cuda.synchronize()
        pairs = list(zip(got, want)) if name == "edge_snap" else [(got, want)]
        for i, (g, p) in enumerate(pairs):
            _require_same_bits(f"[2] {name} output {i}", g, p)
        nan = sum(int(torch.isnan(g).sum()) for g, _ in pairs)
        k_ms, p_ms = in_turns(kern, plain, *ITERS[name])
        b_ms, by = bound(*work[:2])
        sass_rec = code[MAIN_ENTRIES.get(name, f"{name}_kernel")]
        note = (f"{sass_rec['sass_instructions']} SASS instructions, inner loops "
                f"{[lp['instructions'] for lp in sass_rec['inner_loops']]}")
        if name == "fuse_vote":
            walks = work[2]
            (looked, lookups), (scored, made), (nan_looked, nan_lookups, nan_px) = (
                walks["counts"][k] for k in ("view_order", "descending", "nan"))
            extra = (f"; view order: {looked} of {v * v * h * w} (candidate, output) pairs looked at, {lookups} "
                     f"lookups, bound {walks['view_order_bound_ms']:.4g} ms; descending: {scored} values scored, "
                     f"{made} lookups (+ {nan_looked} and {nan_lookups} on {nan_px} NaN pixels), bound "
                     f"{walks['descending_bound_ms']:.4g} ms; bound from the lesser")
        elif name == "edge_snap":
            extra = f"; {int((got.center != spmap.center).any(-1).sum())} of {seeds} centres moved"
            note += f"; issue {snap_issue:.4f} ms (a centre each)"
        else:
            extra = ""
        print(f"[2] {name} on {tuple(pairs[0][0].shape)}: bitwise (NaN {nan}){extra}; kernel {k_ms:.4f} ms, bound "
              f"{b_ms:.4g} ms ({by}), share {b_ms / k_ms:.3f}, plain {p_ms:.3f} ms; {note} ({card})")
        recs[name] = dict(max_abs_err=0.0, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=by)
        if name == "fuse_vote":
            recs[name]["view_order_bound_ms"] = walks["view_order_bound_ms"]
        del got, want, pairs
    print(f"[2] the cross-check and edge snap checks took {time.perf_counter() - t_phase:.1f} s")
    return recs


def phase_slice(card: str):
    import numpy as np
    import torch

    from cl_multiview_stereo_tpu_torch.models.mvs_pipeline import MVSPipeline
    from cl_multiview_stereo_tpu_torch.ops import consistency, cost_volume, slic, smoothness
    from cl_multiview_stereo_tpu_torch.utils.timing import StageTimer

    s, rgb = _scene(FULL_H, FULL_W)
    pipe = MVSPipeline.create(FULL_W, FULL_H, s, depth_method="strips", device="cuda")
    rgb_dev = torch.as_tensor(rgb, device="cuda")

    t0 = time.perf_counter()
    pipe.run(rgb_dev)
    torch.cuda.synchronize()
    print(f"[3] warm-up run {time.perf_counter() - t0:.3f} s ({card})")

    torch.cuda.reset_peak_memory_stats()
    cost_volume.LAUNCHES = 0
    times, timer, cons = [], None, []
    # the consistency kernel: the init state's launch and two a sweep
    cons_per_run = 1 + 2 * s.no_prop
    # SLIC: an assignment, then no_iter x (update, assignment); no vote
    slic_per_run = {"slic_assign": s.no_iter + 1, "slic_update": s.no_iter, "slic_vote": 0, "edge_snap": 0}
    # smoothness: the init's cache and state, and a cache and two phases a sweep
    smooth_per_run = {"smooth_cache": 1 + s.no_prop, "smooth_moves": 1 + 2 * s.no_prop}
    slic_runs, smooth_runs, chain_runs = [], [], []
    for _ in range(2):
        timer = StageTimer()
        consistency.LAUNCHES = 0
        _reset_slic()
        _reset_smoothness()
        _reset_counts()
        _reset_off_defaults()
        t0 = time.perf_counter()
        art = pipe.run(rgb_dev, timer=timer)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        cons.append(consistency.LAUNCHES)
        slic_runs.append(dict(slic.LAUNCHES))
        smooth_runs.append(dict(smoothness.LAUNCHES))
        chain_runs.append(_counts())
    launches = cost_volume.LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    if launches < 1:
        raise AssertionError("the main path never launched the cost-volume kernel")
    if cons != [cons_per_run] * 2:
        raise AssertionError(f"the main path launched the consistency kernel {cons} times a run, "
                             f"expected {cons_per_run}")
    if slic_runs != [slic_per_run] * 2:
        raise AssertionError(f"the main path launched the SLIC kernels {slic_runs} a run, expected {slic_per_run}")
    if smooth_runs != [smooth_per_run] * 2:
        raise AssertionError(f"the main path launched the smoothness kernels {smooth_runs} a run, "
                             f"expected {smooth_per_run}")
    if chain_runs != [PER_RUN] * 2:
        raise AssertionError(f"the main path launched the Lab, extent, raster and chain kernels {chain_runs} a "
                             f"run, expected {PER_RUN}")
    if any(_off_defaults().values()):
        raise AssertionError(f"the slice at the defaults launched {_off_defaults()}, expected none")

    d = art.disp_full
    if not bool(torch.isfinite(d).all()):
        raise AssertionError("disp_full has non-finite values")
    di = art.disp_init.cpu().numpy()[:, 8:-8, 8:-8]
    near = float((np.abs(di - TRUE_DISP) <= 1.0).mean())
    if near <= 0.9:
        raise AssertionError(f"disp_init within 1 of {TRUE_DISP} on only {near:.4f} of interior cells")

    t = min(times)
    mp_s = 9 * FULL_H * FULL_W / t / 1e6
    print(f"[3] runs {[round(x, 4) for x in times]} s; best {t:.4f} s = {mp_s:.4f} MP/s; "
          f"peak {peak / 2**30:.3f} GiB; disp_init near GT {near:.4f}; launches: cost_volume {launches}, "
          f"consistency {cons} (gather engine), slic {slic_runs[0]} a run, smoothness {smooth_runs[0]} a run, "
          f"Lab, extent, raster and chain {chain_runs[0]} a run ({card})")
    stage_ms = timer.ms()
    print("[3] stage ms (last run): " + json.dumps({k: round(v, 3) for k, v in stage_ms.items()}))
    print(f"[3] eager slic stage {stage_ms['slic']:.3f} ms of {sum(stage_ms.values()):.3f} ms of stages ({card})")
    slic_launches = {k: sum(r[k] for r in slic_runs) for k in slic_per_run}
    refine_launches = {k: sum(r[k] for r in smooth_runs) for k in smooth_per_run}
    refine_launches.update({k: sum(r[k] for r in chain_runs) for k in PER_RUN})
    return launches, sum(cons), slic_launches, refine_launches, pipe, rgb_dev, art


def phase_strips(card: str, pipe, rgb_dev, gather_d) -> int:
    import torch

    from cl_multiview_stereo_tpu_torch.ops import consistency
    from cl_multiview_stereo_tpu_torch.tools.profile_stages import profiled, strips_scene
    from cl_multiview_stereo_tpu_torch.utils.timing import StageTimer

    t0 = time.perf_counter()
    strips_scene(pipe, rgb_dev)
    torch.cuda.synchronize()
    print(f"[3b] warm-up run {time.perf_counter() - t0:.3f} s ({card})")

    torch.cuda.reset_peak_memory_stats()
    consistency.LAUNCHES = 0
    times, timer, chain_runs = [], None, []
    for _ in range(2):
        timer = StageTimer()
        _reset_counts()
        t0 = time.perf_counter()
        state, disp_full = strips_scene(pipe, rgb_dev, timer)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        chain_runs.append(_counts())
    launches = consistency.LAUNCHES
    if chain_runs != [PER_RUN] * 2:
        raise AssertionError(f"the strips path launched the Lab, extent, raster and chain kernels {chain_runs} a "
                             f"run, expected {PER_RUN}")
    peak = torch.cuda.max_memory_allocated()
    if launches < 1:
        raise AssertionError("the strips path never launched the consistency kernel")
    if not bool(torch.isfinite(disp_full).all()):
        raise AssertionError("strips disp_full has non-finite values")
    agree = float(((state.d - gather_d).abs() <= 1e-3).float().mean())
    if agree < 0.99:
        raise AssertionError(f"strips state.d within 1e-3 of the gather engine's on only {agree:.6f}")

    t = min(times)
    mp_s = 9 * FULL_H * FULL_W / t / 1e6
    print(f"[3b] strips runs {[round(x, 4) for x in times]} s; best {t:.4f} s = {mp_s:.4f} MP/s; "
          f"peak {peak / 2**30:.3f} GiB; state.d vs gather (1e-3) {agree:.6f}; "
          f"launches {launches}; Lab, extent, raster and chain {chain_runs[0]} a run ({card})")
    print("[3b] stage ms (last run): " + json.dumps({k: round(v, 3) for k, v in timer.ms().items()}))
    prof = profiled(lambda: strips_scene(pipe, rgb_dev))
    by_name = prof.device_ops
    # both rules' instantiations: the init state's gather rule and the sweeps' strips rule
    cons = [(ms, n) for name, (ms, n) in by_name.items() if "consistency_kernel" in name]
    cons_ms, cons_n = sum(ms for ms, _ in cons), sum(n for _, n in cons)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:3]
    print(f"[3b] one strips scene under torch.profiler: wall {prof.wall_ms:.1f} ms, device "
          f"{prof.device_ms:.1f} ms (busy {100 * prof.device_ms / prof.wall_ms:.1f} %); consistency kernel {cons_ms:.3f} ms in {cons_n} "
          f"launches; most device time: "
          + "; ".join(f"{name[:48]} {ms:.1f} ms" for name, (ms, _) in top) + f" ({card})")
    return launches


def phase_dense_sweep(card: str, lab, settings) -> int:
    import numpy as np
    import torch

    from cl_multiview_stereo_tpu_torch.models.plane_sweep import plane_sweep_depth, sweep_args
    from cl_multiview_stereo_tpu_torch.ops import sweep

    ladder, pairs = sweep_args(settings)
    lab = lab.contiguous()
    t0 = time.perf_counter()
    plane_sweep_depth(lab, ladder, pairs, settings.bl_ratio)
    torch.cuda.synchronize()
    print(f"[3c] warm-up run {time.perf_counter() - t0:.3f} s ({card})")

    torch.cuda.reset_peak_memory_stats()
    sweep.LAUNCHES = 0
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        disp, cost = plane_sweep_depth(lab, ladder, pairs, settings.bl_ratio)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = sweep.LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    if launches < 1:
        raise AssertionError("the dense sweep path never launched the sweep kernel")
    if not bool(torch.isfinite(cost).all()):
        raise AssertionError("sweep cost has non-finite values")
    interior = disp[:, 64:-64, 64:-64].cpu().numpy()
    near = float((np.abs(interior - TRUE_DISP) <= 1.0).mean())
    if near < 0.9:
        raise AssertionError(f"sweep disp within 1 of {TRUE_DISP} on only {near:.4f} of interior pixels")

    t = min(times)
    mp_s = 9 * FULL_H * FULL_W / t / 1e6
    print(f"[3c] sweep runs {[round(x, 4) for x in times]} s; best {t:.4f} s = {mp_s:.4f} MP/s; "
          f"peak {peak / 2**30:.3f} GiB; disp near GT {near:.4f}; launches {launches} ({card})")
    return launches


# phase 4's knob runs: (SystemSettings overrides, MVSPipeline.create
# keywords), each knob alone and then all at once
CARD_KNOBS = {
    "cross_check": ({}, dict(cross_check=True)),
    "edge_enable": (dict(edge_enable=True), {}),
    "enforce_connectivity": (dict(enforce_connectivity=True), {}),
    "gather": ({}, dict(depth_method="gather")),
    "view": ({}, dict(pair_layout="view")),
    "all": (dict(edge_enable=True, enforce_connectivity=True),
            dict(cross_check=True, depth_method="gather", pair_layout="view")),
}


def phase_card_vs_cpu(card: str) -> None:
    import numpy as np

    from cl_multiview_stereo_tpu_torch import RefinementSchedule
    from cl_multiview_stereo_tpu_torch.models.mvs_pipeline import MVSPipeline
    from cl_multiview_stereo_tpu_torch.models.plane_sweep import plane_sweep_depth, sweep_args
    from cl_multiview_stereo_tpu_torch.ops import fusion, slic
    from cl_multiview_stereo_tpu_torch.tools.profile_stages import strips_scene

    h, w = 270, 480
    s, rgb = _scene(h, w)
    ladder, pairs = sweep_args(s)
    fields = ("labels", "disp_init", "disp_full")
    out, cpu_state = {}, {}
    votes = slic.LAUNCHES["slic_vote"]
    for dev in ("cuda", "cpu"):
        pipe = MVSPipeline.create(w, h, s, depth_method="strips", device=dev)
        art = pipe.run(rgb)
        _, strips_full = strips_scene(pipe, rgb)
        disp, _ = plane_sweep_depth(art.lab.contiguous(), ladder, pairs, s.bl_ratio)
        out[dev] = {k: getattr(art, k).cpu().numpy() for k in fields}
        out[dev]["strips_full"] = strips_full.cpu().numpy()
        out[dev]["sweep"] = disp.cpu().numpy()
        for knob, (overrides, kw) in CARD_KNOBS.items():
            art_k = MVSPipeline.create(w, h, s.replace(**overrides), device=dev, **kw).run(rgb)
            out[dev].update({f"{knob}_{k}": getattr(art_k, k).cpu().numpy() for k in fields})
            if knob == "cross_check" and dev == "cpu":
                cpu_state = dict(labels=art_k.labels, centers=art_k.spmap.center,
                                 d=art_k.state.d, n=art_k.state.n)
        if dev == "cuda":
            votes = slic.LAUNCHES["slic_vote"] - votes
    g, c = out["cuda"], out["cpu"]

    def agree(pre: str) -> tuple[float, float, float]:
        return (float((g[pre + "labels"] == c[pre + "labels"]).mean()),
                float((g[pre + "disp_init"] == c[pre + "disp_init"]).mean()),
                float((np.abs(g[pre + "disp_full"] - c[pre + "disp_full"]) <= 1e-3).mean()))

    rows = {"base": agree("")}
    rows.update({knob: agree(knob + "_") for knob in CARD_KNOBS})
    strips_full = float((np.abs(g["strips_full"] - c["strips_full"]) <= 1e-3).mean())
    sweep_disp = float((g["sweep"] == c["sweep"]).mean())
    print(f"[4] card vs CPU at 9x{h}x{w}: strips disp_full(1e-3) {strips_full:.6f} "
          f"sweep disp {sweep_disp:.6f} ({card})")
    for name, (lab_a, init_a, full_a) in rows.items():
        print(f"[4] card vs CPU at 9x{h}x{w}, {name}: labels {lab_a:.6f} disp_init {init_a:.6f} "
              f"disp_full(1e-3) {full_a:.6f} ({card})")
    flagged = [k for k, (o, _) in CARD_KNOBS.items() if o.get("enforce_connectivity")]
    print(f"[4] SLIC labels card (csrc/slic.cu) vs CPU (plain forms): lowest agreement "
          f"{min(r[0] for r in rows.values()):.6f} over the runs; slic_vote launched {votes} times on the card "
          f"({', '.join(flagged)}: two a run) ({card})")
    if votes != 2 * len(flagged):
        raise AssertionError(f"[4] the card launched the SLIC vote {votes} times, expected {2 * len(flagged)}")
    # the vote's own witness: the card's cross-check fusion of the CPU's
    # refined state against the CPU's, so that the vote is judged apart
    # from the refinement's ulps
    sched = RefinementSchedule.create(s)
    fused = fusion.fuse_views(
        *(cpu_state[k].cuda() for k in ("labels", "centers", "d", "n")),
        array_width=s.array_width, bl_ratio=s.bl_ratio, fuse=sched.fuse_eff, cross_check=True,
    ).cpu().numpy()
    want = c["cross_check_disp_full"]
    same = bool(np.array_equal(fused, want, equal_nan=True))
    gz, cz = g["cross_check_disp_full"] == 0, want == 0
    print(f"[4] cross_check: card rejects {float(gz.mean()):.6f}, CPU {float(cz.mean()):.6f}, "
          f"one side only {float((gz != cz).mean()):.6f}; the card's vote on the CPU's state "
          f"equals the CPU's bitwise: {same} ({card})")
    if not same:
        raise AssertionError("the card's cross-check fusion of the CPU's state departs from the CPU's")
    for lab_a, init_a, full_a in rows.values():
        if lab_a <= LABELS_AGREE or init_a < INIT_AGREE or full_a < FULL_CLOSE:
            raise AssertionError("the card's output departs from the port's CPU path")
    if strips_full < FULL_CLOSE or sweep_disp < 0.999:
        raise AssertionError("the card's strips or sweep output departs from the port's CPU path")


def _cli(argv: list[str], tag: str, lines: list | None = None) -> tuple[float, dict]:
    """One ``cli.main(argv)``: (wall seconds, its stage ms).  The CLI's
    own lines are echoed with ``tag`` (and appended to ``lines``)."""
    import torch

    from cl_multiview_stereo_tpu_torch import cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"cli.main returned {rc}")
    stages = {}
    for line in buf.getvalue().splitlines():
        print(f"{tag} cli: {line}")
        if lines is not None:
            lines.append(line)
        if line.startswith("stage ms: "):
            stages = json.loads(line[len("stage ms: "):])
    return dt, stages


def _disp_checks(npz: str, tag: str):
    """disp_full of a CLI checkpoint: finite, near the scene's disparity
    64 px from the border; returns (disp_full, near share, rejected share)."""
    import numpy as np

    with np.load(npz) as z:
        disp = z["disp_full"]
    if disp.shape != (9, FULL_H, FULL_W) or not np.isfinite(disp).all():
        raise AssertionError(f"{tag}: disp_full of shape {disp.shape} is not finite everywhere")
    near = float((np.abs(disp[:, 64:-64, 64:-64] - TRUE_DISP) <= 1.0).mean())
    rejected = float((disp == 0).mean())
    if near < 0.9:
        raise AssertionError(f"{tag}: disp_full within 1 of {TRUE_DISP} on only {near:.4f} of interior pixels")
    return disp, near, rejected


def _timed_cli(argv: list[str], tag: str, card: str) -> dict:
    """One warm-up and two timed CLI runs; the cost-volume launches, the
    peak memory and each run's launches of OFF_DEFAULTS' kernels of the
    timed runs; then one more run under torch.profiler, for each stage's
    device ms (``tools.profile_stages.stage_device_ms``)."""
    import torch

    from cl_multiview_stereo_tpu_torch.ops import cost_volume
    from cl_multiview_stereo_tpu_torch.tools.profile_stages import stage_device_ms, whole_profile

    dt, _ = _cli(argv, tag)
    print(f"{tag} warm-up run {dt:.3f} s ({card})")
    torch.cuda.reset_peak_memory_stats()
    cost_volume.LAUNCHES = 0
    times, stages, off = [], {}, []
    for _ in range(2):
        _reset_off_defaults()
        dt, stages = _cli(argv, tag)
        times.append(dt)
        off.append(_off_defaults())
    launches = cost_volume.LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    if launches < 1:
        raise AssertionError(f"{tag}: the CLI path never launched the cost-volume kernel")
    t0 = time.perf_counter()
    device_ms = stage_device_ms(whole_profile(lambda: _cli(argv, f"{tag} (profiled)")))
    print(f"{tag} device ms by stage, one more run under torch.profiler ({time.perf_counter() - t0:.1f} s): "
          + json.dumps({k: round(v, 4) for k, v in device_ms.items()}) + f" ({card})")
    return dict(times=times, stages=stages, launches=launches, peak=peak, off=off, device_ms=device_ms)


def phase_cli(card: str, art3, root: str, lst: str) -> tuple[int, int, dict]:
    """Phase 5 on the scene's PNGs ``lst`` in ``root``; ``art3`` is phase
    3's artifacts (strips depth init, packed layout).  Returns the
    cost-volume launches of 5a's timed runs, the SLIC vote's of 5c's runs,
    and the launches of the cross-check's kernels in 5a's timed runs and of
    the edge snap in 5c's."""
    import numpy as np
    import torch

    from cl_multiview_stereo_tpu_torch import build_disp_levels, build_view_subsets
    from cl_multiview_stereo_tpu_torch.models.mvs_pipeline import MVSPipeline
    from cl_multiview_stereo_tpu_torch.ops import cost_volume, slic
    from cl_multiview_stereo_tpu_torch.tools.roofline import in_turns

    s, rgb = _scene(FULL_H, FULL_W)
    base = ["run", lst, "--device", "cuda", "--cross-check", "--checkpoint", "--ply"]

    out_a = os.path.join(root, "a")
    r = _timed_cli(base + ["--out", out_a], "[5a]", card)
    disp_a, near, rejected = _disp_checks(os.path.join(out_a, "pipeline_state.npz"), "[5a]")
    t = min(r["times"])
    print(f"[5a] CLI runs {[round(x, 4) for x in r['times']]} s; best {t:.4f} s per scene "
          f"= {9 * FULL_H * FULL_W / t / 1e6:.4f} MP/s; peak {r['peak'] / 2**30:.3f} GiB; "
          f"disp_full near GT {near:.6f}; vote rejected {rejected:.6f}; "
          f"cost_volume launches {r['launches']} ({card})")
    print("[5a] stage ms (last run): " + json.dumps(r["stages"]))
    want = {"fuse_warp": 1, "fuse_vote": 1, "edge_snap": 0}
    if r["off"] != [want] * 2:
        raise AssertionError(f"[5a] the cross-check runs launched {r['off']}, expected {want} a run")
    print(f"[5a] cross-check fusion: fuse_warp and fuse_vote launched once a run ({r['off']}); the fusion stage "
          f"{r['device_ms']['fusion']:.4f} device ms, slic {r['device_ms']['slic']:.4f} ({card})")

    out_b = os.path.join(root, "b")
    dt, stages = _cli(base + ["--out", out_b, "--resume", os.path.join(out_a, "pipeline_state.npz")],
                      "[5b]")
    disp_b, _, _ = _disp_checks(os.path.join(out_b, "pipeline_state.npz"), "[5b]")
    if not np.array_equal(disp_b, disp_a):
        raise AssertionError(f"[5b] resumed disp_full differs at {int((disp_b != disp_a).sum())} pixels")
    print(f"[5b] resume from the post-refinement checkpoint: {dt:.4f} s, disp_full bitwise "
          f"equal to 5a; stage ms {json.dumps(stages)} ({card})")

    out_c = os.path.join(root, "c")
    _reset_slic()
    r_c = _timed_cli(base + ["--out", out_c, "--set", "enforce_connectivity=true",
                             "--set", "edge_enable=true"], "[5c]", card)
    votes = slic.LAUNCHES["slic_vote"]
    if votes != 2 * 4:  # warm-up, two timed and one profiled run, two rounds each
        raise AssertionError(f"[5c] the SLIC flags' runs launched the vote {votes} times, expected 8")
    _, near_c, rejected_c = _disp_checks(os.path.join(out_c, "pipeline_state.npz"), "[5c]")
    t = min(r_c["times"])
    print(f"[5c] SLIC flags: CLI runs {[round(x, 4) for x in r_c['times']]} s; best {t:.4f} s "
          f"per scene; peak {r_c['peak'] / 2**30:.3f} GiB; disp_full near GT {near_c:.6f}; "
          f"vote rejected {rejected_c:.6f}; slic_vote launches {votes} ({card})")
    print("[5c] stage ms (last run): " + json.dumps(r_c["stages"]))
    want = {"fuse_warp": 1, "fuse_vote": 1, "edge_snap": 1}
    if r_c["off"] != [want] * 2:
        raise AssertionError(f"[5c] the SLIC flags' runs launched {r_c['off']}, expected {want} a run")
    print(f"[5c] SLIC flags: edge_snap launched once a run ({r_c['off']}); the slic stage "
          f"{r_c['device_ms']['slic']:.4f} device ms, fusion {r_c['device_ms']['fusion']:.4f} ({card})")

    rgb_dev = torch.as_tensor(rgb, device="cuda")
    view = MVSPipeline.create(FULL_W, FULL_H, s, depth_method="strips", pair_layout="view",
                              device="cuda").run(rgb_dev)
    for f in ("d", "sm", "cs", "n"):
        if not torch.equal(getattr(view.state, f), getattr(art3.state, f)):
            raise AssertionError(f"[5d] pair_layout='view' state.{f} differs from the packed layout")
    print(f"[5d] pair_layout='view': refined state bitwise equal to phase 3's packed state ({card})")

    levels = build_disp_levels(s)
    subset, counts = build_view_subsets(s)
    counts = torch.as_tensor(counts, dtype=torch.int32, device="cuda")
    args = (art3.lab, art3.spmap.center, art3.extent, levels, subset, counts, s.array_width, s.bl_ratio)
    kern = cost_volume.initial_depth_estimation(*args, method="dense")
    gath = cost_volume.initial_depth_estimation(*args, method="gather")
    agree = float((kern == gath).float().mean())
    if agree < 0.999:
        raise AssertionError(f"[5d] gather depth init agrees with the kernel's on only {agree:.6f}")
    k_ms, g_ms = in_turns(lambda: cost_volume.initial_depth_estimation(*args, method="dense"),
                          lambda: cost_volume.initial_depth_estimation(*args, method="gather"), 5, 2)
    print(f"[5d] depth init at 9x{FULL_H}x{FULL_W}: kernel (dense) {k_ms:.3f} ms, gather form "
          f"{g_ms:.3f} ms, WTA agreement {agree:.6f} ({card})")
    off = {"fuse_warp": sum(o["fuse_warp"] for o in r["off"]), "fuse_vote": sum(o["fuse_vote"] for o in r["off"]),
           "edge_snap": sum(o["edge_snap"] for o in r_c["off"])}
    return r["launches"], votes, off


def _sfm_run(argv: list[str], tag: str) -> dict:
    """One ``cli.main(["sfm", ...])``: wall seconds, the CLI's decode and
    run_sfm seconds, device ms per step, host seconds, and the metrics of
    its ``sfm_poses.npz``."""
    import numpy as np

    lines: list[str] = []
    dt, stages = _cli(argv, tag, lines)
    text = "\n".join(lines)
    with np.load(os.path.join(argv[argv.index("--out") + 1], "sfm_poses.npz")) as z:
        metrics = {k: float(z[k]) for k in ("rms_before", "rms_after", "ate_vs_grid")}
    return dict(
        wall=dt, stages=stages, **metrics,
        decode=float(re.search(r"loaded \d+ views of \d+x\d+ in ([\d.]+)s", text).group(1)),
        sfm=float(re.search(r"sfm done in ([\d.]+)s", text).group(1)),
        n_matches=int(re.search(r"sfm done in [\d.]+s: (\d+) pairwise matches", text).group(1)),
        host=json.loads(next(ln for ln in lines if ln.startswith("host s: "))[len("host s: "):]),
    )


def _sfm_checks(r: dict, rms_jax: float, tag: str) -> None:
    """The card's SfM held to the JAX package's run on the same scene."""
    if r["n_matches"] < SFM_MATCHES_SHARE * SFM_JAX_MATCHES:
        raise AssertionError(f"{tag}: {r['n_matches']} matches, JAX found {SFM_JAX_MATCHES}")
    if r["rms_after"] > r["rms_before"] + SFM_RMS_SLACK:
        raise AssertionError(f"{tag}: BA raised the RMS from {r['rms_before']} to {r['rms_after']} px")
    if abs(r["rms_after"] - rms_jax) > SFM_RMS_TOL:
        raise AssertionError(f"{tag}: RMS after BA {r['rms_after']} px, JAX's {rms_jax} px")
    if r["ate_vs_grid"] > SFM_ATE_MAX:
        raise AssertionError(f"{tag}: ATE vs the grid prior {r['ate_vs_grid']}")


def _sfm_line(tag: str, runs: list[dict], peak: int, rms_jax: float, card: str) -> None:
    r = runs[-1]
    walls = [round(x["wall"], 4) for x in runs]
    print(f"{tag} CLI runs {walls} s per scene (decode {r['decode']:.3f} s, run_sfm {r['sfm']:.3f} s); "
          f"peak {peak / 2**30:.3f} GiB; n_matches {r['n_matches']}; RMS {r['rms_before']:.6f} -> "
          f"{r['rms_after']:.6f} px (JAX {rms_jax}); ATE vs grid {r['ate_vs_grid']:.6f} ({card})")
    print(f"{tag} device ms (last run): " + json.dumps(r["stages"]))
    print(f"{tag} host s (last run): " + json.dumps({k: round(v, 4) for k, v in r["host"].items()}))


def _png_near(out: str) -> float:
    """Share of interior pixels within 1 of the scene's disparity, read back
    from a run's ``8- Fusion`` PNGs (each 8-bit level decoded to its bin's
    centre over the default ladder 30..60)."""
    import numpy as np
    from PIL import Image

    from cl_multiview_stereo_tpu_torch import SystemSettings

    s = SystemSettings()
    lo, hi = float(s.min_disp), float(s.max_disp)
    near = []
    for v in range(9):
        png = np.asarray(Image.open(os.path.join(out, "8- Fusion", f"disp_{v}.png")), np.float64)
        disp = lo + (png + 0.5) / 255.0 * (hi - lo)
        near.append(np.abs(disp[64:-64, 64:-64] - TRUE_DISP) <= 1.0)
    return float(np.mean(near))


def phase_sfm(card: str, root: str, lst: str) -> int:
    """Phase 6 on phase 5's PNGs.  Returns the cost-volume launches of 6c."""
    import numpy as np
    import torch

    from cl_multiview_stereo_tpu_torch.models.sfm_pipeline import gray_image, run_sfm
    from cl_multiview_stereo_tpu_torch.ops import cost_volume
    from cl_multiview_stereo_tpu_torch.ops.features import harris_keypoints

    argv = ["sfm", lst, "--device", "cuda", "--out", os.path.join(root, "sfm")]
    print(f"[6a] warm-up run {_sfm_run(argv, '[6a]')['wall']:.3f} s ({card})")
    torch.cuda.reset_peak_memory_stats()
    runs = [_sfm_run(argv, "[6a]") for _ in range(2)]
    _sfm_line("[6a]", runs, torch.cuda.max_memory_allocated(), SFM_JAX_RMS_AFTER, card)
    for r in runs:
        _sfm_checks(r, SFM_JAX_RMS_AFTER, "[6a]")

    argv_pg = argv + ["--pose-graph"]
    print(f"[6b] warm-up run {_sfm_run(argv_pg, '[6b]')['wall']:.3f} s ({card})")
    torch.cuda.reset_peak_memory_stats()
    r = _sfm_run(argv_pg, "[6b]")
    _sfm_line("[6b] --pose-graph:", [r], torch.cuda.max_memory_allocated(), SFM_JAX_PG_RMS_AFTER, card)
    _sfm_checks(r, SFM_JAX_PG_RMS_AFTER, "[6b]")

    out_c = os.path.join(root, "sfm_run")
    cost_volume.LAUNCHES = 0
    dt, stages = _cli(["run", lst, "--sfm", "--device", "cuda", "--out", out_c], "[6c]")
    launches = cost_volume.LAUNCHES
    if launches < 1:
        raise AssertionError("[6c]: run --sfm never launched the cost-volume kernel")
    near, near_a = _png_near(out_c), _png_near(os.path.join(root, "a"))
    print(f"[6c] run --sfm: {dt:.4f} s per scene; disp near GT {near:.6f} (5a's {near_a:.6f}, both "
          f"from the PNGs); cost_volume launches {launches} ({card})")
    print("[6c] stage ms: " + json.dumps(stages))
    if near < SFM_RUN_NEAR:
        raise AssertionError(f"[6c]: disparity within 1 of {TRUE_DISP} on only {near:.4f} of interior pixels")

    s, rgb = _scene(270, 480)
    gray = gray_image(torch.as_tensor(rgb))
    kp_c, kp_g = harris_keypoints(gray), harris_keypoints(gray.cuda())
    fin = torch.isfinite(kp_g.score).cpu()
    shared = sum(len({tuple(p) for p in kp_g.xy[v].cpu()[fin[v]].tolist()}
                     & {tuple(p) for p in kp_c.xy[v].tolist()}) for v in range(9))
    kp_agree = shared / max(int(fin.sum()), 1)
    for pg in (False, True):
        rg = run_sfm(rgb, s, device="cuda", use_pose_graph=pg)
        rc = run_sfm(rgb, s, device="cpu", use_pose_graph=pg)
        ate = float(np.sqrt(np.mean(np.sum((rg.t - rc.t) ** 2, -1))))
        print(f"[6d] card vs CPU at 9x270x480, pose graph {pg}: keypoints {kp_agree:.6f}; n_matches "
              f"{rg.n_matches} / {rc.n_matches}; ATE between the runs {ate:.3e}; RMS after "
              f"{rg.rms_after:.6f} / {rc.rms_after:.6f} px ({card})")
        if kp_agree < SFM_KP_AGREE or ate > SFM_CARD_CPU_ATE:
            raise AssertionError("[6d]: the card's SfM departs from the port's CPU path")
    return launches


def _seconds(fn, runs: int = 2) -> tuple[float, list[float]]:
    """Host seconds of a warm-up call of ``fn`` and of ``runs`` timed calls,
    each ended by a synchronize."""
    import torch

    out = []
    for _ in range(runs + 1):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out[0], out[1:]


def _times_line(tag: str, sharded, unsharded, card: str) -> None:
    (ws, ts), (wu, tu) = sharded, unsharded
    print(f"{tag} seconds: sharded warm-up {ws:.4f}, runs {[round(x, 4) for x in ts]}; unsharded "
          f"warm-up {wu:.4f}, runs {[round(x, 4) for x in tu]}; best sharded / unsharded "
          f"{min(ts) / min(tu):.4f} ({card})")


def _require_equal(tag: str, got, want, equal_nan: bool = False) -> None:
    """Bitwise equal (with ``equal_nan``, NaN at the same places counts as equal)."""
    import torch

    if equal_nan:
        torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True, msg=lambda m: f"{tag}: {m}")
    elif not torch.equal(got, want):
        raise AssertionError(f"{tag}: differs at {int((got != want).sum())} of {want.numel()} entries")


def phase_sharded(card: str, art, lst: str) -> dict:
    """Phase 7a-7e in a world-size-1 NCCL group.  Returns each kernel's
    launches on the sharded paths (each count reset just before its path)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from cl_multiview_stereo_tpu_torch import RefinementSchedule, build_disp_levels, build_view_subsets
    from cl_multiview_stereo_tpu_torch.io.images import load_image_array
    from cl_multiview_stereo_tpu_torch.models.mvs_pipeline import MVSPipeline
    from cl_multiview_stereo_tpu_torch.models.plane_sweep import plane_sweep_depth, sweep_args
    from cl_multiview_stereo_tpu_torch.models.sfm_pipeline import run_sfm
    from cl_multiview_stereo_tpu_torch.ops import cost_volume, refine, sweep
    from cl_multiview_stereo_tpu_torch.ops.superpixel import extent_step
    from cl_multiview_stereo_tpu_torch.parallel import initialize_distributed, make_mesh, spatial
    from cl_multiview_stereo_tpu_torch.parallel.sharded_pipeline import run_sharded
    from cl_multiview_stereo_tpu_torch.tools.roofline import bound, in_turns, sweep_work

    initialize_distributed(device="cuda")
    try:
        print(f"[7] process group: backend {dist.get_backend()}, world size {dist.get_world_size()} ({card})")
        tile = init_device_mesh("cuda", (1,), mesh_dim_names=("tile",))
        disp_mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("disp",))
        mesh = make_mesh()
        s, rgb = _scene(FULL_H, FULL_W)
        rgb_dev = torch.as_tensor(rgb, device="cuda")
        levels = build_disp_levels(s)
        subset, counts = build_view_subsets(s)
        counts_t = torch.as_tensor(counts, dtype=torch.int32, device="cuda")
        lab, center = art.lab.contiguous(), art.spmap.center.contiguous()
        step = extent_step(art.extent).contiguous()
        launches = {}

        # 7a: depth slabs
        want = cost_volume.initial_depth_estimation(lab, center, art.extent, levels, subset, counts_t,
                                                    s.array_width, s.bl_ratio, method="dense")
        cost_volume.LAUNCHES = 0
        got = spatial.disp_sharded_depth_init(lab, center, step, levels, counts, disp_mesh,
                                              s.array_width, s.bl_ratio)
        torch.cuda.synchronize()
        launches["cost_volume"] = cost_volume.LAUNCHES
        if launches["cost_volume"] < 1:
            raise AssertionError("[7a] disp_sharded_depth_init never launched the cost-volume kernel")
        _require_equal("[7a] disp_sharded_depth_init", got, want)
        for n in (2, 3, 4):
            ladder = spatial.padded_ladder(levels, n)
            wins = [spatial.slab_winners(lab, center, step, ladder, t, n, s.array_width, s.bl_ratio)
                    for t in range(n)]
            joined = spatial.combine_slab_winners(torch.stack([c for c, _ in wins]),
                                                  torch.stack([d for _, d in wins]))
            _require_equal(f"[7a] {n} slabs", torch.where(counts_t[:, None, None] > 0, joined, 0.0), want)
        print(f"[7a] disp_sharded_depth_init at 9x{FULL_H}x{FULL_W} D{len(levels)}: bitwise equal to the "
              f"dense depth init; the slab local work of 2, 3 and 4 ranks (the ladder padded to "
              f"{[len(spatial.padded_ladder(levels, n)) for n in (2, 3, 4)]}) bitwise equal; cost_volume "
              f"launches {launches['cost_volume']} ({card})")

        # 7b: row tiles
        ladder, pairs = sweep_args(s)
        ladder = [float(d) for d in ladder]
        want_d, want_c = plane_sweep_depth(lab, ladder, pairs, s.bl_ratio)
        sweep.LAUNCHES = 0
        got_d, got_c = spatial.spatial_plane_sweep(lab, ladder, pairs, s.bl_ratio, tile)
        torch.cuda.synchronize()
        launches["sweep"] = sweep.LAUNCHES
        if launches["sweep"] < 1:
            raise AssertionError("[7b] spatial_plane_sweep never launched the sweep kernel")
        _require_equal("[7b] spatial_plane_sweep disp", got_d, want_d)
        _require_equal("[7b] spatial_plane_sweep cost", got_c, want_c)
        halo = spatial.sweep_halo(ladder, pairs, s.bl_ratio, 2)
        for n in (2, 4, 8):
            rows = FULL_H // n
            for t in range(n):
                b0, b1 = max(0, t * rows - halo), min(FULL_H, (t + 1) * rows + halo)
                band = lab[:, b0:b1].contiguous()
                td, tc = spatial.sweep_tile(band, b0, t, rows, FULL_H, ladder, pairs, s.bl_ratio)
                _require_equal(f"[7b] tile {t} of {n} disp", td, want_d[:, t * rows:(t + 1) * rows])
                _require_equal(f"[7b] tile {t} of {n} cost", tc, want_c[:, t * rows:(t + 1) * rows])
        # an interior tile of 8 against the whole launch, and its bound
        rows, t = FULL_H // 8, 3
        b0, b1 = t * rows - halo, (t + 1) * rows + halo
        band = lab[:, b0:b1].contiguous()
        win = sweep.RowWindow(FULL_H, b0, t * rows, rows)
        tile_ms, full_ms = in_turns(lambda: sweep.plane_sweep(band, ladder, pairs, s.bl_ratio, 2, win),
                                    lambda: sweep.plane_sweep(lab, ladder, pairs, s.bl_ratio, 2), 5, 5)
        tile_bound, tile_by = bound(*sweep_work(band, ladder, pairs, s.bl_ratio, 2, rows))
        print(f"[7b] spatial_plane_sweep: bitwise equal to plane_sweep_depth; the row-window kernel "
              f"bitwise equal to the whole launch's rows on every tile of 2, 4 and 8 (halo {halo} rows); "
              f"tile 3 of 8 ({rows} rows from a band of {b1 - b0}): kernel {tile_ms:.3f} ms, bound "
              f"{tile_bound:.4g} ms ({tile_by}); the whole launch {full_ms:.3f} ms; sweep launches "
              f"{launches['sweep']} ({card})")
        _times_line("[7b]", _seconds(lambda: spatial.spatial_plane_sweep(lab, ladder, pairs, s.bl_ratio, tile)),
                    _seconds(lambda: plane_sweep_depth(lab, ladder, pairs, s.bl_ratio)), card)

        # 7c: row-sharded refinement
        sched = RefinementSchedule.create(s)
        ctx = refine.make_context(art.spmap.center, art.spmap.color, art.disp_init, art.labels, art.extent,
                                  art.flatness)
        rpairs = refine.pairs_from_subsets(subset, s.array_width)
        want = refine.refine(ctx, sched, pairs=rpairs)
        for hd in (None, "auto"):
            got = spatial.spatial_refine(ctx, sched, tile, pairs=rpairs, halo_disp=hd)
            for f in refine.RefineState._fields:
                _require_equal(f"[7c] spatial_refine halo_disp={hd} {f}", getattr(got, f), getattr(want, f))
        print(f"[7c] spatial_refine: bitwise equal to refine.refine with halo_disp None and 'auto' "
              f"({spatial.refine_halo(ctx, sched, rpairs, 'auto')} rows) ({card})")
        _times_line("[7c]", _seconds(lambda: spatial.spatial_refine(ctx, sched, tile, pairs=rpairs)),
                    _seconds(lambda: refine.refine(ctx, sched, pairs=rpairs)), card)

        # 7d: the view-sharded pipeline
        for layout in ("packed", "view"):
            pipe = MVSPipeline.create(FULL_W, FULL_H, s, pair_layout=layout, device="cuda")
            want = pipe.run(rgb_dev).disp_full
            cost_volume.LAUNCHES = 0
            got = run_sharded(pipe, rgb_dev, mesh)
            torch.cuda.synchronize()
            n_cv = cost_volume.LAUNCHES
            if n_cv < 1:
                raise AssertionError(f"[7d] run_sharded ({layout}) never launched the cost-volume kernel")
            launches["cost_volume"] += n_cv
            _require_equal(f"[7d] run_sharded pair_layout={layout}", got, want)
        full = cost_volume.superpixel_cost_volume(lab, center, step, levels, s.array_width, s.bl_ratio)
        parts = [cost_volume.superpixel_cost_volume(lab, center, step, levels, s.array_width, s.bl_ratio,
                                                    view_range=(3 * r, 3)) for r in range(3)]
        _require_equal("[7d] view-range cost volume of 3 ranks", torch.cat(parts), full)
        print(f"[7d] run_sharded: disp_full bitwise equal to MVSPipeline.run with pair_layout 'packed' and "
              f"'view'; the view-range cost volume of 3 ranks x 3 views bitwise equal to the whole volume; "
              f"cost_volume launches {launches['cost_volume']} with 7a's ({card})")
        pipe = MVSPipeline.create(FULL_W, FULL_H, s, device="cuda")
        _times_line("[7d]", _seconds(lambda: run_sharded(pipe, rgb_dev, mesh)),
                    _seconds(lambda: pipe.run(rgb_dev)), card)

        # 7e: SfM with the observation-sharded bundle adjustment
        rgb_png = load_image_array(lst, 9)
        res = run_sfm(rgb_png, s, device="cuda", mesh=mesh)
        res0 = run_sfm(rgb_png, s, device="cuda")
        ate = float(np.sqrt(np.mean(np.sum((res.t - res0.t) ** 2, -1))))
        print(f"[7e] run_sfm(mesh=...): n_matches {res.n_matches} (unsharded {res0.n_matches}, JAX "
              f"{SFM_JAX_MATCHES}); RMS {res.rms_before:.6f} -> {res.rms_after:.6f} px (unsharded "
              f"{res0.rms_after:.6f}, JAX {SFM_JAX_RMS_AFTER}); ATE vs grid {res.ate_vs_grid:.6f}; ATE "
              f"between the sharded and unsharded poses {ate:.3e} ({card})")
        if (res.n_matches < SFM_MATCHES_SHARE * SFM_JAX_MATCHES or res.ate_vs_grid > SFM_ATE_MAX
                or abs(res.rms_after - SFM_JAX_RMS_AFTER) > SFM_RMS_TOL
                or res.rms_after > res.rms_before + SFM_RMS_SLACK):
            raise AssertionError("[7e] run_sfm(mesh=...) departs from phase 6's bounds")
        _times_line("[7e]", _seconds(lambda: run_sfm(rgb_png, s, device="cuda", mesh=mesh)),
                    _seconds(lambda: run_sfm(rgb_png, s, device="cuda")), card)
        return launches
    finally:
        dist.destroy_process_group()


def gloo_worker(rank: int, init: str, out: str) -> None:
    """Phase 7f, one of two ranks on the one card in a gloo group that
    carries CUDA tensors: 7b at n = 2, and 7d at n = 2 on an 8-view
    (4x2) 1080p scene (9 views do not split over 2 ranks).  Writes its
    checks and seconds as JSON to ``out``."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from cl_multiview_stereo_tpu_torch import SystemSettings, fronto_parallel_scene
    from cl_multiview_stereo_tpu_torch.models.mvs_pipeline import MVSPipeline
    from cl_multiview_stereo_tpu_torch.models.plane_sweep import plane_sweep_depth, sweep_args
    from cl_multiview_stereo_tpu_torch.ops.color import rgb_to_lab
    from cl_multiview_stereo_tpu_torch.parallel import make_mesh, spatial
    from cl_multiview_stereo_tpu_torch.parallel.sharded_pipeline import run_sharded

    torch.cuda.set_device(0)
    torch.zeros(1, device="cuda")  # the device is chosen before the mesh looks
    dist.init_process_group("gloo", init_method=f"file://{init}", world_size=2, rank=rank)
    try:
        rec = {"backend": dist.get_backend()}
        s9, rgb9 = _scene(FULL_H, FULL_W)
        lab = rgb_to_lab(torch.as_tensor(rgb9, device="cuda")).contiguous()
        ladder, pairs = sweep_args(s9)
        tile = init_device_mesh("cuda", (2,), mesh_dim_names=("tile",))
        want = plane_sweep_depth(lab, ladder, pairs, s9.bl_ratio)
        got = spatial.spatial_plane_sweep(lab, ladder, pairs, s9.bl_ratio, tile)
        rec["7b"] = all(bool(torch.equal(g, w)) for g, w in zip(got, want))
        rec["7b_s"] = _seconds(lambda: spatial.spatial_plane_sweep(lab, ladder, pairs, s9.bl_ratio, tile))
        rec["7b_unsharded_s"] = _seconds(lambda: plane_sweep_depth(lab, ladder, pairs, s9.bl_ratio))

        s8 = SystemSettings(array_width=4, array_height=2)
        rgb8, _ = fronto_parallel_scene(FULL_H, FULL_W, 4, 2, disp=TRUE_DISP, bl_ratio=s8.bl_ratio)
        rgb8 = torch.as_tensor(rgb8, device="cuda")
        pipe = MVSPipeline.create(FULL_W, FULL_H, s8, device="cuda")
        want = pipe.run(rgb8).disp_full
        mesh = make_mesh()
        rec["7d"] = bool(torch.equal(run_sharded(pipe, rgb8, mesh), want))
        rec["7d_s"] = _seconds(lambda: run_sharded(pipe, rgb8, mesh))
        rec["7d_unsharded_s"] = _seconds(lambda: pipe.run(rgb8))
        with open(out, "w") as f:
            json.dump(rec, f)
    finally:
        dist.destroy_process_group()


def stale_loader_worker(lst: str, tmp: str) -> None:
    """Phase 8a's fresh process: the loader's build directory in ``tmp``
    holds a file that does not open under the cached library's name; decode
    the scene list ``lst`` and write the array to ``tmp``/rgb.npy, and the
    backend, the seconds and the warnings as a JSON line on stdout."""
    import warnings
    from pathlib import Path

    import numpy as np

    from cl_multiview_stereo_tpu_torch.io.native_loader import load_image_array_native, native_available
    from cl_multiview_stereo_tpu_torch.native import build

    build.BUILD_DIR = Path(tmp) / "build"
    build.BUILD_DIR.mkdir()
    stale = build.library_path()
    stale.write_bytes(b"not a shared library\n")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t0 = time.perf_counter()
        rgb = load_image_array_native(lst, 9)
        seconds = time.perf_counter() - t0
    np.save(os.path.join(tmp, "rgb.npy"), rgb)
    backend = "native" if native_available() else "pil"
    rebuilt = stale.read_bytes().startswith(b"\x7fELF")
    if rebuilt:
        ctypes.CDLL(str(stale))  # the cached name opens now
    print(json.dumps({"backend": backend, "seconds": seconds, "library": stale.name, "rebuilt": rebuilt,
                      "warnings": [str(w.message) for w in caught]}))


def phase_gloo_two_ranks(card: str) -> None:
    """Phase 7f: two processes of this script on the one card."""
    with tempfile.TemporaryDirectory() as tmp:
        init = os.path.join(tmp, "init")
        outs = [os.path.join(tmp, f"rank{r}.json") for r in range(2)]
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--gloo-rank", str(r), init, outs[r]],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for r in range(2)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=GLOO_TIMEOUT_S)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.perf_counter() - t0
        for r, (p, log) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                raise AssertionError(f"[7f] gloo rank {r} exited {p.returncode}:\n{log[-6000:]}")
        recs = []
        for path in outs:
            with open(path) as f:
                recs.append(json.load(f))
    for r, rec in enumerate(recs):
        if not (rec["7b"] and rec["7d"]):
            raise AssertionError(f"[7f] rank {r}: 7b bitwise {rec['7b']}, 7d bitwise {rec['7d']}")
    r0 = recs[0]
    print(f"[7f] two ranks on one card, backend {r0['backend']} on CUDA tensors: 7b at n = 2 bitwise "
          f"plane_sweep_depth on both ranks; 7d at n = 2 on 8x{FULL_H}x{FULL_W} (4x2 views) bitwise "
          f"MVSPipeline.run on both ranks; {wall:.1f} s with the processes' start ({card})")
    _times_line("[7f] 7b, rank 0,", r0["7b_s"], r0["7b_unsharded_s"], card)
    _times_line("[7f] 7d, rank 0,", r0["7d_s"], r0["7d_unsharded_s"], card)


def _leaf_pairs(a, b, prefix: str = ""):
    """(name, a's tensor, b's tensor) over two nested NamedTuples."""
    import torch

    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, torch.Tensor):
            yield prefix + f, x, y
        else:
            yield from _leaf_pairs(x, y, f"{prefix}{f}.")


def _artifacts_equal(tag: str, got, want) -> None:
    for name, x, y in _leaf_pairs(got, want):
        _require_equal(f"{tag} {name}", x, y)


def _trace_counts(fn) -> dict:
    """One ``fn()`` under torch.profiler: its device kernels, the host's
    kernel and graph launch calls, pageable host-to-device copies and
    cost-volume kernels, with the device ms and the wall ms."""
    from cl_multiview_stereo_tpu_torch.tools.profile_stages import profiled

    p = profiled(fn)
    dev = {name: n for name, (_, n) in p.device_ops.items()}
    copies = ("Memcpy", "Memset")
    return dict(
        kernels=sum(n for name, n in dev.items() if not name.startswith(copies)),
        launch_calls=sum(n for name, n in p.host_calls.items()
                         if name in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC")),
        graph_launches=sum(n for name, n in p.host_calls.items()
                           if name.startswith(("cudaGraphLaunch", "cuGraphLaunch"))),
        pageable_htod=sum(n for name, n in dev.items() if "HtoD" in name and "Pageable" in name),
        cost_volume=sum(n for name, n in dev.items() if "cost_volume_kernel" in name),
        device_ms=p.device_ms,
        wall_ms=p.wall_ms,
    )


def phase_stream(card: str, root: str, lst: str) -> dict:
    """Phase 8 on phase 5's PNGs ``lst`` in ``root``.  Returns each kernel's
    launches in 8b-8d's graph replays."""
    import numpy as np
    import torch

    from cl_multiview_stereo_tpu_torch import build_view_subsets, fronto_parallel_scene
    from cl_multiview_stereo_tpu_torch.io.images import load_image_array
    from cl_multiview_stereo_tpu_torch.io.native_loader import load_image_array_native, native_available
    from cl_multiview_stereo_tpu_torch.io.prefetcher import run_scenes
    from cl_multiview_stereo_tpu_torch.models import mvs_pipeline
    from cl_multiview_stereo_tpu_torch.native import build as native_build
    from cl_multiview_stereo_tpu_torch.ops import refine
    from cl_multiview_stereo_tpu_torch.tools.bench import write_scene

    t_phase = time.perf_counter()
    # 8a: the native decode.  Only a missing g++ or missing headers may
    # leave the PIL backend; any other build failure raises here.
    try:
        native_build.load()
        missing = ""
    except native_build.ToolchainMissing as e:
        missing = str(e).splitlines()[0]
    backend = "native" if native_available() else "pil"
    if not missing and backend != "native":
        raise AssertionError("[8a] the native loader built but the backend is not native")
    nat_s, pil_s = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        nat = load_image_array_native(lst, 9)
        nat_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        pil = load_image_array(lst, 9)
        pil_s.append(time.perf_counter() - t0)
    if not np.array_equal(nat, pil):
        raise AssertionError(f"[8a] native and PIL decodes differ at {int((nat != pil).sum())} bytes")
    print(f"[8a] decode of 9 {FULL_W}x{FULL_H} PNGs: load_image_array_native {[round(x, 4) for x in nat_s]} "
          f"s, load_image_array (PIL) {[round(x, 4) for x in pil_s]} s, bitwise equal; backend {backend}"
          + (f" (toolchain missing: {missing})" if missing else "") + f" ({card})")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--stale-loader", lst, tmp],
                              capture_output=True, text=True, timeout=STALE_LOADER_TIMEOUT_S)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"[8a] the stale-library process exited {proc.returncode}:\n{proc.stderr[-4000:]}")
        rec = json.loads(proc.stdout.splitlines()[-1])
        stale = np.load(os.path.join(tmp, "rgb.npy"))
    if not np.array_equal(stale, pil):
        raise AssertionError(f"[8a] with a stale cached library the decode differs from PIL's at "
                             f"{int((stale != pil).sum())} bytes")
    if rec["backend"] != backend:
        raise AssertionError(f"[8a] with a stale cached library the backend is {rec['backend']}, not {backend}")
    fell_back = any("decoding with PIL" in w for w in rec["warnings"])
    if missing and not fell_back:
        raise AssertionError(f"[8a] PIL decoded a stale cached library's scene without the warning: {rec}")
    if not missing and not (rec["rebuilt"] and not fell_back):
        raise AssertionError(f"[8a] the stale cached library was not rebuilt in place: {rec}")
    print(f"[8a] a stale cached library (a file that does not open under {rec['library']}) in a fresh process: "
          f"load_image_array_native {rec['seconds']:.4f} s (a rebuild included; {wall:.1f} s with the process's "
          f"start), bitwise PIL's; backend {rec['backend']}; "
          + (f"warned: {rec['warnings'][0]}" if missing else "rebuilt in place, and opens") + f" ({card})")

    # 8b: the graph at full width, default knobs, on two scenes
    s, rgb_a = _scene(FULL_H, FULL_W)
    rgb_b, _ = fronto_parallel_scene(FULL_H, FULL_W, 3, 3, disp=STREAM_B_DISP, bl_ratio=s.bl_ratio,
                                     seed=STREAM_B_SEED)
    a, b = (torch.as_tensor(x, device="cuda") for x in (rgb_a, rgb_b))
    pipe = mvs_pipeline.MVSPipeline.create(FULL_W, FULL_H, s, device="cuda")
    want_a, want_b = pipe.run(a), pipe.run(b)
    if torch.equal(want_a.disp_full, want_b.disp_full):
        raise AssertionError("[8b] scenes A and B give the same disparity")
    mvs_pipeline.REPLAYED_LAUNCHES.clear()
    torch.cuda.reset_peak_memory_stats()
    fwd = pipe.jitted()
    t0 = time.perf_counter()
    got = fwd(a)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    _artifacts_equal("[8b] scene A", got, want_a)
    _artifacts_equal("[8b] scene B", fwd(b), want_b)
    replay_s, eager_s = [], []
    for _ in range(2):
        for fn, out in ((lambda: fwd(a), replay_s), (lambda: pipe.run(a), eager_s)):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    tr, te = _trace_counts(lambda: fwd(a)), _trace_counts(lambda: pipe.run(a))
    if tr["pageable_htod"]:
        raise AssertionError(f"[8b] a replay made {tr['pageable_htod']} pageable host-to-device copies")
    mp = 9 * FULL_H * FULL_W / 1e6
    print(f"[8b] jitted() at 9x{FULL_H}x{FULL_W} (dense, packed, gather engine): capture (warm-up, "
          f"capture, first replay) {capture_s:.3f} s; scene A and scene B (disp {STREAM_B_DISP}, seed "
          f"{STREAM_B_SEED}) bitwise run() on every artifact; replays {[round(x, 4) for x in replay_s]} s, "
          f"best {min(replay_s):.4f} s = {mp / min(replay_s):.4f} MP/s; eager run() "
          f"{[round(x, 4) for x in eager_s]} s, best {min(eager_s):.4f} s = {mp / min(eager_s):.4f} MP/s; "
          f"best replay / eager {min(replay_s) / min(eager_s):.4f}; peak {peak / 2**30:.3f} GiB ({card})")
    for tag, t in (("one replay", tr), ("one eager run()", te)):
        print(f"[8b] {tag} under torch.profiler: {t['kernels']} device kernels ({t['cost_volume']} "
              f"cost_volume_kernel), {t['launch_calls']} kernel launch calls, {t['graph_launches']} graph "
              f"launches, {t['pageable_htod']} pageable host-to-device copies; device {t['device_ms']:.1f} "
              f"ms of {t['wall_ms']:.1f} ms wall ({card})")
    del fwd, got

    # 8c: the knobs at 9x270x480, and float pair deltas as SfM gives them
    h, w = 270, 480
    s_small, rgb_small = _scene(h, w)
    x = torch.as_tensor(rgb_small, device="cuda")
    grid = refine.pairs_from_subsets(build_view_subsets(s_small)[0], s_small.array_width)
    sfm_pairs = tuple((r, nb, dx * 1.0125 + 0.003 * r, dy * 0.9875 - 0.002 * nb) for r, nb, dx, dy in grid)
    configs = dict(CARD_KNOBS, pair_deltas=({}, dict(pair_deltas=sfm_pairs)))
    for knob, (overrides, kw) in configs.items():
        pipe_k = mvs_pipeline.MVSPipeline.create(w, h, s_small.replace(**overrides), device="cuda", **kw)
        _artifacts_equal(f"[8c] {knob}", pipe_k.jitted()(x), pipe_k.run(x))
    print(f"[8c] jitted() at 9x{h}x{w} bitwise run() on every artifact with {', '.join(configs)} ({card})")

    # 8d: run_scenes over 4 scenes, against decode-then-run()
    root_b = os.path.join(root, "scene_b")
    os.makedirs(root_b)
    lst_b = write_scene(root_b, rgb_b)
    order = [lst, lst_b, lst, lst_b]
    for p, rgb in ((lst, rgb_a), (lst_b, rgb_b)):
        if not np.array_equal(load_image_array(p, 9), rgb):
            raise AssertionError(f"[8d] {p} does not decode to the scene written")
    want = {lst: want_a.disp_full, lst_b: want_b.disp_full}
    done, t0 = [], time.perf_counter()
    for idx, art in run_scenes(pipe, order, depth=2):
        torch.cuda.synchronize()
        done.append(time.perf_counter() - t0)
        _require_equal(f"[8d] run_scenes scene {idx}", art.disp_full, want[order[idx]])
    if len(done) != len(order):
        raise AssertionError(f"[8d] run_scenes yielded {len(done)} of {len(order)} scenes")
    steady = (len(order) - 1) * 9 / (done[-1] - done[0])
    serial = []
    for p in order:
        t1 = time.perf_counter()
        pipe.run(load_image_array(p, 9))
        torch.cuda.synchronize()
        serial.append(time.perf_counter() - t1)
    per_scene = np.diff([0.0] + done)
    print(f"[8d] run_scenes, 4 scenes (A, B, A, B from PNGs, depth 2): each disp_full bitwise run(); "
          f"seconds per scene {[round(float(x), 4) for x in per_scene]} (the first with the capture); "
          f"scenes 2-4 {steady:.4f} views/s = {steady * FULL_H * FULL_W / 1e6:.4f} MP/s; decode-then-run() "
          f"{[round(x, 4) for x in serial]} s per scene = {9 * len(serial) / sum(serial):.4f} views/s "
          f"({card})")
    launches = dict(mvs_pipeline.REPLAYED_LAUNCHES)
    for name in ("cost_volume", "consistency", "slic_assign", "slic_update", "smooth_cache", "smooth_moves",
                 *PER_RUN):
        if launches.get(name, 0) < 1:
            raise AssertionError(f"[8b-8d] no graph replay launched the {name} kernel")

    cmd = [sys.executable, "-m", "cl_multiview_stereo_tpu_torch.tools.stream_scenes", lst, lst_b,
           "--repeat", "2"]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=STREAM_TOOL_TIMEOUT_S,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    if proc.returncode != 0:
        raise AssertionError(f"[8d] stream_scenes exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    if rec["scenes"] != 4 or rec["decode_backend"] != backend:
        raise AssertionError(f"[8d] stream_scenes: {rec}")
    print(f"[8d] python -m cl_multiview_stereo_tpu_torch.tools.stream_scenes A B --repeat 2: "
          f"{json.dumps(rec)} ({card})")
    print(f"[8] phase 8 took {time.perf_counter() - t_phase:.1f} s; kernel launches of the graph "
          f"replays {launches} ({card})")
    return launches


def _tool(name: str, argv: list[str]) -> tuple[int, list[str], str, float]:
    """``python -m cl_multiview_stereo_tpu_torch.tools.<name> argv`` from this
    checkout: (exit code, stdout lines, stderr, seconds); killed after
    TOOL_TIMEOUT_S."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", f"cl_multiview_stereo_tpu_torch.tools.{name}", *argv],
                          capture_output=True, text=True, timeout=TOOL_TIMEOUT_S,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    return proc.returncode, proc.stdout.strip().splitlines(), proc.stderr, time.perf_counter() - t0


def phase_tools(card: str, phase2: dict) -> dict:
    """Phase 9: the measurement tools, each in its own process on the card
    (this process's cached blocks released first).  ``phase2`` holds phase
    2's record per kernel.  Returns 9a's launches per kernel."""
    import torch

    from cl_multiview_stereo_tpu_torch import SystemSettings

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    argv = ["--cell", "slice", "--runs", str(BENCH_RUNS), "--profile"]
    rc, out, err, dt = _tool("bench", argv)
    if rc != 0:
        raise AssertionError(f"[9a] bench exited {rc}:\n{err[-4000:]}")
    rec = json.loads(out[-1])
    launches = rec["launches"]
    # each replay launches the cost volume once, the consistency kernel at
    # the init state and twice a sweep, SLIC's assignment and update, the
    # smoothness kernels and PER_RUN's
    d = SystemSettings()
    per_run = {"cost_volume": 1, "consistency": 1 + 2 * d.no_prop, "slic_assign": d.no_iter + 1,
               "slic_update": d.no_iter, "slic_vote": 0, "smooth_cache": 1 + d.no_prop,
               "smooth_moves": 1 + 2 * d.no_prop, **PER_RUN, **dict.fromkeys(OFF_DEFAULTS, 0)}
    if (rec["metric"] != "depth_mp_per_s" or len(rec["runs_s"]) != BENCH_RUNS or rec["card"] != card
            or any(launches[k] != BENCH_RUNS * n for k, n in per_run.items())):
        raise AssertionError(f"[9a] bench: {rec}")
    print(f"[9a] python -m cl_multiview_stereo_tpu_torch.tools.bench {' '.join(argv)} ({dt:.1f} s): "
          f"{json.dumps(rec)}")

    argv = ["--kernel", "all", "--shapes", "main"]
    rc, out, err, dt = _tool("roofline", argv)
    if rc != 0:
        raise AssertionError(f"[9b] roofline exited {rc}:\n{err[-4000:]}")
    recs = [json.loads(line) for line in out]
    if [r["kernel"] for r in recs] != list(KERNELS):
        raise AssertionError(f"[9b] roofline printed {recs}")
    for r in recs:
        print(f"[9b] python -m cl_multiview_stereo_tpu_torch.tools.roofline {' '.join(argv)}: {json.dumps(r)}")
        # the tool's record sums its calls: the vote's two rounds
        want = sum(c["bound_ms"] for c in phase2[r["kernel"]].get("rounds", [phase2[r["kernel"]]]))
        if r["bound_ms"] != want or r["card"] != card:
            raise AssertionError(f"[9b] {r['kernel']}: bound {r['bound_ms']} ms, phase 2's {want} ms")
    print(f"[9b] each kernel's bound_ms equals phase 2's ({dt:.1f} s)")

    rc, out, err, dt = _tool("memcheck", CONFIG4)
    if rc not in (0, MEMCHECK_OOM_EXIT):
        raise AssertionError(f"[9c] memcheck exited {rc}:\n{err[-4000:]}")
    rec = json.loads(out[-1])
    if rec["fits"] != (rc == 0):
        raise AssertionError(f"[9c] memcheck exited {rc} with {rec}")
    print(f"[9c] python -m cl_multiview_stereo_tpu_torch.tools.memcheck {' '.join(CONFIG4)}: exit {rc} "
          f"({'fits' if rc == 0 else 'does not fit'}; {dt:.1f} s): {json.dumps(rec)}")
    print(f"[9] phase 9 took {time.perf_counter() - t_phase:.1f} s ({card})")
    return launches


def _same_bits(a, b) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()


def phase_propagate_tools(card: str) -> None:
    """Phase 10: the propagate profile, the scaling sweep and memcheck
    --sharded, each in its own process on the card."""
    import numpy as np
    import torch

    from cl_multiview_stereo_tpu_torch import SystemSettings
    from cl_multiview_stereo_tpu_torch.ops import refine
    from cl_multiview_stereo_tpu_torch.tools import profile_propagate

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        npz = os.path.join(tmp, "state.npz")
        argv = ["--engine", "both", "--save", npz]
        rc, out, err, dt = _tool("profile_propagate", argv)
        if rc != 0:
            raise AssertionError(f"[10a] profile_propagate exited {rc}:\n{err[-4000:]}")
        for line in out[:-1]:
            print(f"[10a] {line}")
        rec = json.loads(out[-1])
        comps = rec["components"]
        if list(comps) != list(profile_propagate.ENGINES) or rec["card"] != card:
            raise AssertionError(f"[10a] profile_propagate: {rec}")
        for engine, named in comps.items():
            for name, c in named.items():
                if not (c["ms"] > 0 and c["device_ms"] > 0 and c["launches"] > 0):
                    raise AssertionError(f"[10a] {engine} {name}: {c}")
        for name, e in rec["ladder"].items():
            if not (e["ms"] > 0 and e["bound_ms"] > 0):
                raise AssertionError(f"[10a] ladder {name}: {e}")
        print(f"[10a] python -m cl_multiview_stereo_tpu_torch.tools.profile_propagate {' '.join(argv[:2])} "
              f"({dt:.1f} s): {len(comps)} engines x {len(comps['gather'])} components and "
              f"{len(rec['ladder'])} ladder entries, each timed ({rec['card']})")
        sw = profile_propagate.setup(SystemSettings(), FULL_H, FULL_W, "cuda")
        sched = sw.sched
        with np.load(npz) as z:
            for engine in profile_propagate.ENGINES:
                want = refine.propagate_iteration(
                    sw.ctx, sw.state, 0, **sw.kw, steps=sched.steps_per_iter[0],
                    step_size=sched.step_size_per_iter[0], cons_engine=engine)
                for f in refine.RefineState._fields:
                    if not _same_bits(z[f"{engine}_{f}"], getattr(want, f).cpu().numpy()):
                        raise AssertionError(f"[10a] {engine}: the tool's state.{f} is not propagate_iteration's")
        del sw, want
    print(f"[10a] the tool's propagate_iteration[0] state is bitwise a plain refine.propagate_iteration call "
          f"on the same initial state, gather and strips ({card})")

    argv = ["--device", "cuda", "--n", str(SWEEP_N)]
    rc, out, err, dt = _tool("scaling_sweep", argv)
    if rc != 0:
        raise AssertionError(f"[10b] scaling_sweep exited {rc}:\n{err[-4000:]}")
    res = json.loads(out[-1])
    if [r["devices"] for r in res] != [SWEEP_N] or not all(r["bitwise"] and r["backend"] == "nccl" for r in res):
        raise AssertionError(f"[10b] scaling_sweep: {res}")
    for line in out[:-1]:
        print(f"[10b] {line}")
    print(f"[10b] python -m cl_multiview_stereo_tpu_torch.tools.scaling_sweep {' '.join(argv)} ({dt:.1f} s): "
          f"{json.dumps(res)}")

    argv = ["--sharded", "1"]
    rc, out, err, dt = _tool("memcheck", argv)
    if rc != 0:
        raise AssertionError(f"[10c] memcheck exited {rc}:\n{err[-4000:]}")
    rec = json.loads(out[-1])
    if not (rec["fits"] and rec["sharded"] == 1 and rec["backend"] == "nccl" and rec["card"] == card):
        raise AssertionError(f"[10c] memcheck: {rec}")
    print(f"[10c] python -m cl_multiview_stereo_tpu_torch.tools.memcheck {' '.join(argv)} ({dt:.1f} s): "
          f"{json.dumps(rec)}")
    print(f"[10] phase 10 took {time.perf_counter() - t_phase:.1f} s ({card})")


def main() -> int:
    import torch

    if len(sys.argv) == 5 and sys.argv[1] == "--gloo-rank":
        gloo_worker(int(sys.argv[2]), sys.argv[3], sys.argv[4])
        return 0
    if len(sys.argv) == 4 and sys.argv[1] == "--stale-loader":
        stale_loader_worker(sys.argv[2], sys.argv[3])
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    try:
        from cl_multiview_stereo_tpu_torch.device import card_name, require_cuda
        from cl_multiview_stereo_tpu_torch.tools.bench import write_scene
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout of the repo ({e})", file=sys.stderr)
        return 1

    require_cuda()
    card = card_name()
    print(f"[0] {torch.cuda.get_device_name(0)}; torch {torch.__version__} cuda {torch.version.cuda}")

    phase_build()
    cv = phase_kernel_vs_plain(card)
    sw = phase_sweep_vs_plain(card)
    cons = phase_consistency_vs_plain(card)
    sl = phase_slic_vs_plain(card)
    sm = phase_smoothness_vs_plain(card)
    ch = phase_chain_vs_plain(card)
    le = phase_lab_extent_vs_plain(card)
    cs = phase_crosscheck_snap_vs_plain(card)
    _, cons_launches, slic_launches, refine_launches, pipe, rgb_dev, art = phase_slice(card)
    cons_launches += phase_strips(card, pipe, rgb_dev, art.state.d)
    sw_launches = phase_dense_sweep(card, art.lab, pipe.settings)
    phase_card_vs_cpu(card)
    with tempfile.TemporaryDirectory() as root:
        lst = write_scene(root, _scene(FULL_H, FULL_W)[1])
        cv_launches, slic_launches["slic_vote"], off_launches = phase_cli(card, art, root, lst)
        # the cost-volume launches of each main path: 5a's CLI and 6c's run
        # --sfm, and of phase 7's sharded paths
        cv_launches += phase_sfm(card, root, lst)
        sharded = phase_sharded(card, art, lst)
        stream_launches = phase_stream(card, root, lst)
    phase_gloo_two_ranks(card)
    del pipe, rgb_dev, art  # phase 9's tools each want the whole card
    bench_launches = phase_tools(card, {"cost_volume": cv, "sweep": sw, "consistency": cons, **sl, **sm, **ch,
                                        **le, **cs})
    phase_propagate_tools(card)
    # phase 8's graph replays and 9a's launch the cost volume and the
    # consistency kernel from the graph
    cv_launches += sharded["cost_volume"] + stream_launches["cost_volume"] + bench_launches["cost_volume"]
    cons_launches += stream_launches["consistency"] + bench_launches["consistency"]
    sw_launches += sharded["sweep"]
    # SLIC: phase 3's runs, phase 8's replays and 9a's; the vote 5c's runs
    for name in ("slic_assign", "slic_update"):
        slic_launches[name] += stream_launches[name] + bench_launches[name]
    # smoothness, raster, chain, Lab and extent: phase 3's runs, phase 8's
    # replays and 9a's
    for name in refine_launches:
        refine_launches[name] += stream_launches[name] + bench_launches[name]

    src = "cl_multiview_stereo_tpu_torch/csrc/{}.cu".format
    # library_ms: no single PyTorch call computes the first three functions,
    # SLIC's assignment and vote, the smoothness cache and scores, the
    # rasterization, the chain, the Lab conversion, the extent, the
    # cross-check's warp and vote or the edge snap; index_add_ computes the
    # update's sums.  The kernels after the first three replace XLA
    # functions of the JAX package, not Pallas; the last three run only
    # under the CLI's --cross-check and edge_enable (5a, 5c), so their
    # launches are those runs'; compute_edges (:261) and apply_edge_snap
    # (:300) are the edge snap's two
    rows = (
        ("cost_volume", "cost_volume", "cl_multiview_stereo_tpu/ops/cost_volume.py:46", cv_launches, cv),
        ("sweep", "sweep", "cl_multiview_stereo_tpu/ops/pallas/sweep.py:93", sw_launches, sw),
        ("consistency", "consistency", "cl_multiview_stereo_tpu/ops/pallas/consistency.py:95", cons_launches,
         cons),
        ("slic_assign", "slic", "cl_multiview_stereo_tpu/ops/slic.py:102", slic_launches["slic_assign"],
         sl["slic_assign"]),
        ("slic_update", "slic", "cl_multiview_stereo_tpu/ops/slic.py:178", slic_launches["slic_update"],
         sl["slic_update"]),
        ("slic_vote", "slic", "cl_multiview_stereo_tpu/ops/slic.py:340", slic_launches["slic_vote"],
         sl["slic_vote"]),
        ("smooth_cache", "smoothness", "cl_multiview_stereo_tpu/ops/refine.py:221", refine_launches["smooth_cache"],
         sm["smooth_cache"]),
        ("smooth_moves", "smoothness", "cl_multiview_stereo_tpu/ops/refine.py:359", refine_launches["smooth_moves"],
         sm["smooth_moves"]),
        ("raster_planes", "raster", "cl_multiview_stereo_tpu/ops/refine.py:187",
         refine_launches["raster_planes"], ch["raster_planes"]),
        ("chain_moves", "chain", "cl_multiview_stereo_tpu/ops/refine.py:778", refine_launches["chain_moves"],
         ch["chain_moves"]),
        ("chain_update", "chain", "cl_multiview_stereo_tpu/ops/refine.py:963", refine_launches["chain_update"],
         ch["chain_update"]),
        ("chain_refit", "chain", "cl_multiview_stereo_tpu/ops/refine.py:1023", refine_launches["chain_refit"],
         ch["chain_refit"]),
        ("lab_convert", "color", "cl_multiview_stereo_tpu/ops/color.py:46", refine_launches["lab_convert"],
         le["lab_convert"]),
        ("extent_walk", "extent", "cl_multiview_stereo_tpu/ops/superpixel.py:111", refine_launches["extent_walk"],
         le["extent_walk"]),
        ("fuse_warp", "crosscheck", "cl_multiview_stereo_tpu/ops/fusion.py:150", off_launches["fuse_warp"],
         cs["fuse_warp"]),
        ("fuse_vote", "crosscheck", "cl_multiview_stereo_tpu/ops/fusion.py:186", off_launches["fuse_vote"],
         cs["fuse_vote"]),
        ("edge_snap", "slic", "cl_multiview_stereo_tpu/ops/slic.py:261", off_launches["edge_snap"], cs["edge_snap"]),
    )
    if [r[0] for r in rows] != list(KERNELS):
        raise AssertionError("the kernels' record does not list every kernel")
    record = {"kernels": [
        {"name": name, "route": "cuda", "source": src(source), "replaces": replaces,
         "launches": launches, "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
         "library_ms": r.get("library_ms"),
         **{k: r[k] for k in ("map_ms", "map_bound_ms", "view_order_bound_ms", "round_ms") if k in r}}
        for name, source, replaces, launches, r in rows
    ]}
    print(card)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
