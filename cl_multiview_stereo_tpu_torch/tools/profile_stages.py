"""Stage-by-stage device times of one scene, and what the device spends its
time on (port of the JAX package's ``tools/profile_stages.py``).

Usage:

  python -m cl_multiview_stereo_tpu_torch.tools.profile_stages [--cell slice|strips] \\
      [--hw 1080x1920] [--set key=val ...] [--cross-check] [--device cuda|cpu]

On ``bench.py``'s scene (:func:`scene`: the synthetic fronto-parallel
plane at disparity 40 over the settings' camera grid), after one warm-up
run:

1. one eager run with a ``StageTimer``: each stage's device ms in run order
   (``lab``, ``slic``, ``extent``, ``depth_init``, ``context``,
   ``init_state``, ``propagate``, ``fusion``), their total and MP/s;
2. one more run under ``torch.profiler`` (:func:`profiled`,
   :func:`breakdown`): the traced wall ms, the device busy share (self
   CUDA time over wall), the 10 device ops with the most self time with
   their launch counts, and the 5 longest idle gaps on the device, each
   named by the innermost ``StageTimer`` range and the innermost host op
   open when it began (gaps within the traced call and its synchronize),
   and each stage's device ms (``stage_device_ms``): every device op's time
   added to the innermost ``StageTimer`` range open when the host made the
   CUDA runtime call that launched it (the call and the op share their
   correlation id in the trace), not when the device ran it, so a stage's
   queued work counts as the stage's.  The trace is taken again while its
   kernels fall short of its launch calls (:func:`whole_profile`: the
   profiler now and then drops device events), and the tool raises after
   PROFILE_TRIES such traces.  A trace with no device
   events gives ``"not measured: ..."``, never zeros.

``--cell slice`` is ``MVSPipeline.run`` at its defaults; ``--cell strips``
is :func:`strips_scene`, the same stages with the strips consistency
engine.  ``--cross-check`` creates the pipeline with ``cross_check=True``,
as ``cli run --cross-check`` does (the slice cell's fusion then warps and
votes).  The last line is one JSON object: ``cell``, ``stage_ms``,
``total_ms``, ``mp_per_s``, ``breakdown``, ``card``, ``settings``,
``cross_check``, ``hw``.
With ``--device cpu`` the stages run once and every device field is null.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

CELLS = ("slice", "strips")
SCENE_DISP = 40.0  # bench.py's scene
TOP_OPS, TOP_GAPS = 10, 5
# traces of one call taken before whole_profile gives up on a whole one
PROFILE_TRIES = 3
CALL = "profile_stages.profiled"  # the host range around the traced call
NAME_CHARS = 120  # device op names are cut to this length in the records


def parse_hw(text: str) -> tuple[int, int]:
    """``"HxW"`` -> (H, W)."""
    h, w = text.lower().split("x")
    return int(h), int(w)


def scene(settings, h: int, w: int) -> np.ndarray:
    """``bench.py``'s scene: the fronto-parallel plane at disparity 40 over
    the settings' camera grid, (V, H, W, 3) uint8."""
    from cl_multiview_stereo_tpu_torch.testing.synthetic import fronto_parallel_scene

    s = settings
    return fronto_parallel_scene(h, w, s.array_width, s.array_height, disp=SCENE_DISP, bl_ratio=s.bl_ratio)[0]


def strips_scene(pipe, rgb, timer=None):
    """The slice's stages with the strips consistency engine in the
    propagation sweeps (composed as ``tools/probe_cons_strips.py``
    composes the JAX stages).  Returns (refined state, disp_full)."""
    from cl_multiview_stereo_tpu_torch.config import (
        RefinementSchedule,
        SlicParams,
        build_disp_levels,
        build_view_subsets,
    )
    from cl_multiview_stereo_tpu_torch.ops import cost_volume, fusion, refine, slic, superpixel
    from cl_multiview_stereo_tpu_torch.ops.color import rgb_to_lab
    from cl_multiview_stereo_tpu_torch.utils.timing import maybe_stage

    s, geom, dev = pipe.settings, pipe.geom, pipe.device
    sched = RefinementSchedule.create(s)
    subset, counts = build_view_subsets(s)
    with maybe_stage(timer, "lab"):
        lab = rgb_to_lab(torch.as_tensor(rgb, device=dev))
    with maybe_stage(timer, "slic"):
        labels, spmap = slic.segment(lab, geom, SlicParams.create(s))
    with maybe_stage(timer, "extent"):
        extent = superpixel.superpixel_extent(labels, spmap.center, geom)
    with maybe_stage(timer, "depth_init"):
        disp_init = cost_volume.initial_depth_estimation(
            lab, spmap.center, extent, build_disp_levels(s), subset,
            torch.as_tensor(counts, dtype=torch.int32, device=dev), s.array_width, s.bl_ratio,
            method="strips", neib_hor=s.neib_hor, neib_ver=s.neib_ver,
        )
    with maybe_stage(timer, "context"):
        flatness = refine.compute_flatness(spmap.color, sched.gamma_eff)
        ctx = refine.make_context(spmap.center, spmap.color, disp_init, labels, extent, flatness)
    state = refine.refine(
        ctx, sched, pairs=refine.pairs_from_subsets(subset, s.array_width),
        cons_engine="strips", timer=timer,
    )
    with maybe_stage(timer, "fusion"):
        disp_full = fusion.fuse_views(labels, spmap.center, state.d, state.n)
    return state, disp_full


def eager(cell: str, pipe, rgb) -> Callable:
    """The cell's eager run as ``fn(timer)``, ``timer`` a ``StageTimer`` or
    None."""
    if cell == "slice":
        return lambda timer: pipe.run(rgb, timer=timer)
    if cell == "strips":
        return lambda timer: strips_scene(pipe, rgb, timer)
    raise ValueError(f"cell must be one of {CELLS}, got {cell!r}")


def stage_ms(fn: Callable) -> dict[str, float]:
    """Device ms per stage, in run order, of one ``fn(timer)``."""
    from cl_multiview_stereo_tpu_torch.utils.timing import StageTimer

    timer = StageTimer()
    fn(timer)
    return timer.ms()


class Profile(NamedTuple):
    """One traced call: spans in the trace's microseconds, ``*_ms`` in ms."""

    wall_ms: float  # host clock, the call and a synchronize
    device_ms: float  # self device time of every device op ("Self CUDA time total")
    device_ops: dict  # device op name -> (self device ms, launches)
    host_calls: dict  # host op name -> calls
    busy: list  # (start, end) of each device op
    ranges: list  # (name, start, end) of each record_function range
    ops: list  # (name, start, end) of each other host op
    window: tuple  # (start, end) of the traced call and its synchronize
    # (device ms, start of the runtime call that launched it, None if the
    # trace holds no such call) of each device op
    launched: tuple = ()


# stage_device_ms's names for device time outside every range, and for an
# op whose launching host event the trace does not hold
OUTSIDE, UNLINKED = "outside stages", "unlinked"


def profiled(fn: Callable) -> Profile:
    """One ``fn()`` under torch.profiler, the device time summed as the
    profiler's "Self CUDA time total" sums it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with torch.profiler.record_function(CALL):
            fn()
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    averages = prof.key_averages()
    device_ops = {e.key: (e.self_device_time_total / 1e3, e.count) for e in averages
                  if e.device_type == DeviceType.CUDA and not e.is_user_annotation}
    host_calls = {e.key: e.count for e in averages if e.device_type == DeviceType.CPU}
    busy, ranges, ops, window, device, runtime = [], [], [], None, [], {}
    for e in prof.events():
        span = (e.time_range.start, e.time_range.end)
        if e.device_type == DeviceType.CUDA:
            if not e.is_user_annotation:
                busy.append(span)
                device.append(((span[1] - span[0]) / 1e3, e.id))
            continue
        if e.name.startswith("cuda"):  # a runtime call: its id is its device op's
            runtime[e.id] = span[0]
        if e.is_user_annotation:
            if e.name == CALL:
                window = span
            else:
                ranges.append((e.name, *span))
        else:
            ops.append((e.name, *span))
    device_ms = sum(ms for ms, _ in device_ops.values())
    launched = tuple((ms, runtime.get(i)) for ms, i in device)
    return Profile(wall, device_ms, device_ops, host_calls, busy, ranges, ops, window, launched)


def trace_launches(p: Profile) -> tuple[int, int]:
    """(kernels, runtime launch calls) of a trace: its device ops but
    copies and fills, and its host calls that launch a kernel."""
    kernels = sum(n for name, (_, n) in p.device_ops.items() if not name.startswith(("Memcpy", "Memset")))
    calls = sum(n for name, n in p.host_calls.items() if "LaunchKernel" in name)
    return kernels, calls


def whole_profile(fn: Callable) -> Profile:
    """:func:`profiled` of ``fn()``, from a whole trace: torch.profiler now
    and then drops a session's device events, so a trace whose kernels fall
    short of its launch calls is taken again, up to PROFILE_TRIES times,
    and then this raises."""
    for _ in range(PROFILE_TRIES):
        p = profiled(fn)
        kernels, calls = trace_launches(p)
        if kernels >= calls:
            return p
        print(f"[profile] {calls} launch calls but {kernels} kernels in the trace: taken again", flush=True)
    raise RuntimeError(f"no whole trace in {PROFILE_TRIES} tries")


def innermost(ranges, t: float) -> str | None:
    """The name of the innermost of ``ranges`` ((name, start, end)) open at
    ``t``: the latest to start, the shortest of those; None if none is."""
    open_at = [(start, start - end, name) for name, start, end in ranges if start <= t < end]
    return max(open_at)[2] if open_at else None


def idle_gaps(busy, ranges, window: tuple[float, float], n: int = TOP_GAPS) -> list[tuple[float, float, str | None]]:
    """The ``n`` longest stretches of ``window`` that no ``busy`` interval
    covers, longest first, as (start, end, the innermost of ``ranges`` open
    at the start)."""
    gaps, edge = [], window[0]
    for start, end in sorted(busy):
        if start > edge:
            gaps.append((edge, start))
        edge = max(edge, end)
    if window[1] > edge:
        gaps.append((edge, window[1]))
    gaps.sort(key=lambda g: g[0] - g[1])
    return [(a, b, innermost(ranges, a)) for a, b in gaps[:n]]


def stage_device_ms(p: Profile) -> dict[str, float]:
    """Device ms of each range by which the host launched the work: each
    op of ``p.launched`` added to the innermost of ``p.ranges`` open at its
    launch (OUTSIDE if none is, UNLINKED if its launch is unknown)."""
    out: dict[str, float] = {}
    for ms, t in p.launched:
        name = UNLINKED if t is None else (innermost(p.ranges, t) or OUTSIDE)
        out[name] = out.get(name, 0.0) + ms
    return out


def breakdown(p: Profile) -> dict | str:
    """The busy share, top device ops and longest idle gaps of a trace."""
    if not p.busy:
        return "not measured: torch.profiler recorded no device events"
    top = sorted(p.device_ops.items(), key=lambda kv: -kv[1][0])[:TOP_OPS]
    gaps = idle_gaps(p.busy, p.ranges, p.window)
    return {
        "wall_ms": p.wall_ms,
        "device_ms": p.device_ms,
        "busy_share": p.device_ms / p.wall_ms,
        "top_ops": [{"name": name[:NAME_CHARS], "ms": ms, "share": ms / p.device_ms, "launches": count}
                    for name, (ms, count) in top],
        "idle_gaps": [{"ms": (b - a) / 1e3, "at_ms": (a - p.window[0]) / 1e3, "range": name,
                       "op": innermost(p.ops, a)} for a, b, name in gaps],
        "stage_device_ms": stage_device_ms(p),
    }


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="profile_stages")
    ap.add_argument("--cell", default="slice", choices=CELLS)
    ap.add_argument("--hw", default="1080x1920", help="image height x width")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VAL",
                    help="override a SystemSettings field")
    ap.add_argument("--cross-check", action="store_true", help="the pipeline with cross_check=True")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu (runs, measures nothing)")
    return ap


def main(argv: list[str] | None = None) -> dict:
    args = build_parser().parse_args(argv)

    from cl_multiview_stereo_tpu_torch.cli import _parse_overrides, resolve_device
    from cl_multiview_stereo_tpu_torch.config import SystemSettings
    from cl_multiview_stereo_tpu_torch.device import card_name
    from cl_multiview_stereo_tpu_torch.models.mvs_pipeline import MVSPipeline
    from cl_multiview_stereo_tpu_torch.utils.timing import StageTimer

    dev = resolve_device(args.device)
    overrides = _parse_overrides(args.set)
    s = SystemSettings().replace(**overrides)
    h, w = parse_hw(args.hw)
    rgb = torch.as_tensor(scene(s, h, w), device=dev)
    fn = eager(args.cell, MVSPipeline.create(w, h, s, device=dev, cross_check=args.cross_check), rgb)
    rec = {"cell": args.cell, "stage_ms": None, "total_ms": None, "mp_per_s": None, "breakdown": None,
           "card": "cpu", "settings": overrides, "cross_check": args.cross_check, "hw": f"{h}x{w}"}
    fn(None)  # warm-up (kernel builds, device tables)
    if dev.type == "cuda":
        ms = stage_ms(fn)
        for name, t in ms.items():
            print(f"{name:24s} {t:9.1f} ms")
        total = sum(ms.values())
        mp_s = s.view_num * h * w / total / 1e3
        print(f"{'TOTAL':24s} {total:9.1f} ms -> {mp_s:.2f} MP/s")
        rec.update(stage_ms=ms, total_ms=total, mp_per_s=mp_s, card=card_name(),
                   breakdown=breakdown(whole_profile(lambda: fn(StageTimer()))))
        if isinstance(rec["breakdown"], dict):
            for name, t in rec["breakdown"]["stage_device_ms"].items():
                print(f"{name:24s} {t:9.1f} ms of device ops launched")
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
