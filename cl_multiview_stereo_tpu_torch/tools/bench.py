"""The port's benchmark harness (port of the JAX package's ``bench.py``,
which stays the JAX round's harness).

Usage:

  python -m cl_multiview_stereo_tpu_torch.tools.bench [--cell slice|strips|sweep|cli|stream|sfm] \\
      [--runs 5] [--hw 1080x1920] [--set key=val ...] [--stages] [--profile] [--device cuda|cpu]

The scene is ``bench.py``'s: the synthetic fronto-parallel plane at
disparity 40 over the settings' camera grid (9 views of 1080x1920 at
``SystemSettings()``, 31 hypotheses).  Each cell is one way users drive the
system, with its own metric:

- ``slice`` (default): ``pipe.jitted()`` at the defaults (dense depth init,
  gather engine, packed layout); ``depth_mp_per_s``.
- ``strips``: ``profile_stages.strips_scene``, the strips consistency
  engine; ``depth_mp_per_s``.
- ``sweep``: ``plane_sweep_depth`` on the scene's Lab; ``depth_mp_per_s``.
- ``cli``: ``cli.main(["run", ..., "--cross-check", "--checkpoint",
  "--ply"])`` on the scene written as PNGs; ``cli_s_per_scene``, with the
  CLI's decode and host-output seconds apart in ``host_s``.
- ``stream``: ``run_scenes`` over scenes A, B, A, B from PNGs at prefetch
  depth 2 (B: disparity 36, seed 7); ``stream_views_per_s`` over the
  scenes after the first, whose time holds the graph's capture.
- ``sfm``: ``cli.main(["sfm", ...])`` on the PNGs; ``sfm_s_per_scene``,
  with ``n_matches``, ``rms_after`` and ``ate``.

One warm-up run (for ``slice`` the graph's capture), then ``--runs`` timed
runs, each a host clock around work that ends in a synchronize; the peak
device memory is reset before them and read after.  ``--stages`` adds one
eager run's stage ms, ``--profile`` ``profile_stages``' breakdown of one
more run; both run after the timed runs.  The last line is one JSON
object: ``metric``, ``value``, ``unit``, ``cell``, ``median_s``,
``min_s``, ``max_s``, ``runs_s``, ``peak_mem_gib``, ``stage_ms``,
``breakdown``, ``card``, ``settings``, ``hw``, ``launches`` (each kernel's
launches in the timed runs, graph replays included) and the cell's own
fields.  With ``--device cpu`` the runs are on the CPU and ``card`` is
"cpu"; ``peak_mem_gib``, ``stage_ms`` and ``breakdown`` are null.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import statistics
import tempfile
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

CELLS = ("slice", "strips", "sweep", "cli", "stream", "sfm")
# the stream's scene B: the scene generator at another disparity and seed
STREAM_B_DISP, STREAM_B_SEED = 36.0, 7
STREAM_DEPTH = 2
GIB = 2.0**30


class Cell(NamedTuple):
    metric: str
    unit: str
    run: Callable[[], tuple]  # one timed run: (its seconds, what it returned)
    value: Callable[[float], float]  # the metric from the median seconds
    stages: Callable[[], dict] | None  # one run's stage ms; None: the cell has no stages
    trace: Callable[[], object]  # one run to profile
    extras: Callable[[int], dict]  # the cell's own fields over the last n runs


def write_scene(root: str, rgb: np.ndarray) -> str:
    """The views as PNGs and a list file (the reference's data.txt format)
    in ``root``; returns the list's path."""
    from PIL import Image

    names = []
    for i, im in enumerate(rgb):
        names.append(f"view_{i}.png")
        Image.fromarray(im).save(os.path.join(root, names[-1]))
    lst = os.path.join(root, "data.txt")
    with open(lst, "w") as f:
        f.write("".join(n + "\n" for n in names))
    return lst


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timed(fn: Callable, dev: torch.device) -> tuple[float, object]:
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    return time.perf_counter() - t0, out


def _cli(argv: list[str], dev: torch.device) -> tuple[float, list[str]]:
    """One ``cli.main(argv)``: its seconds and its lines."""
    from cl_multiview_stereo_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        dt, _ = _timed(lambda: cli.main(argv), dev)
    return dt, buf.getvalue().splitlines()


def _json_after(lines: list[str], marker: str) -> dict | None:
    """The JSON after ``marker`` on the first line that holds it."""
    return next((json.loads(ln.split(marker, 1)[1]) for ln in lines if marker in ln), None)


def _mp_cell(metric_mp: float, fn: Callable, eager: Callable, dev: torch.device) -> Cell:
    """A cell rated in depth MP/s: ``fn()`` timed, ``eager(timer)`` for the
    stages and the trace."""
    from cl_multiview_stereo_tpu_torch.tools.profile_stages import stage_ms
    from cl_multiview_stereo_tpu_torch.utils.timing import StageTimer

    return Cell("depth_mp_per_s", "MP/s", lambda: _timed(fn, dev), lambda t: metric_mp / t / 1e6,
                lambda: stage_ms(eager), lambda: eager(StageTimer()), lambda n: {})


def make_cell(name: str, s, h: int, w: int, dev: torch.device, root: str, overrides: list[str]) -> Cell:
    """Cell ``name`` on the scene at settings ``s``; PNG scenes go to
    ``root``; ``overrides`` are the ``--set`` words, passed to the CLI."""
    from cl_multiview_stereo_tpu_torch.models.mvs_pipeline import MVSPipeline
    from cl_multiview_stereo_tpu_torch.tools.profile_stages import eager, scene

    rgb = scene(s, h, w)
    pixels = s.view_num * h * w
    pipe = MVSPipeline.create(w, h, s, device=dev)
    if name in ("slice", "strips"):
        rgb_dev = torch.as_tensor(rgb, device=dev)
        run_eager = eager(name, pipe, rgb_dev)
        if name == "strips":
            return _mp_cell(pixels, lambda: run_eager(None), run_eager, dev)
        fwd = pipe.jitted()
        return _mp_cell(pixels, lambda: fwd(rgb_dev), run_eager, dev)
    if name == "sweep":
        from cl_multiview_stereo_tpu_torch.models.plane_sweep import plane_sweep_depth, sweep_args
        from cl_multiview_stereo_tpu_torch.ops.color import rgb_to_lab
        from cl_multiview_stereo_tpu_torch.utils.timing import maybe_stage

        lab = rgb_to_lab(torch.as_tensor(rgb, device=dev)).contiguous()
        ladder, pairs = sweep_args(s)

        def sweep_stage(timer):
            with maybe_stage(timer, "sweep"):
                return plane_sweep_depth(lab, ladder, pairs, s.bl_ratio)

        return _mp_cell(pixels, lambda: sweep_stage(None), sweep_stage, dev)

    lst = write_scene(root, rgb)
    sets = [word for o in overrides for word in ("--set", o)]
    if name == "cli":
        argv = ["run", lst, "--device", str(dev), "--out", os.path.join(root, "out"),
                "--cross-check", "--checkpoint", "--ply"] + sets
        host = []

        def run() -> tuple[float, list[str]]:
            dt, lines = _cli(argv, dev)
            decode = float(re.search(r"loaded \d+ views of \d+x\d+ in ([\d.]+)s", "\n".join(lines)).group(1))
            host.append({"decode": decode} | _json_after(lines, "; host s: "))
            return dt, lines

        def extras(n: int) -> dict:
            return {"host_s": {k: statistics.median(r[k] for r in host[-n:]) for k in host[-1]}}

        return Cell("cli_s_per_scene", "s", run, lambda t: t,
                    lambda: _json_after(_cli(argv, dev)[1], "stage ms: "), lambda: _cli(argv, dev), extras)
    if name == "sfm":
        out = os.path.join(root, "sfm")
        argv = ["sfm", lst, "--device", str(dev), "--out", out] + sets
        matches = []

        def run() -> tuple[float, list[str]]:
            dt, lines = _cli(argv, dev)
            matches.append(int(re.search(r"sfm done in [\d.]+s: (\d+) pairwise", "\n".join(lines)).group(1)))
            return dt, lines

        def extras(n: int) -> dict:
            with np.load(os.path.join(out, "sfm_poses.npz")) as z:
                return {"n_matches": matches[-1], "rms_after": float(z["rms_after"]), "ate": float(z["ate_vs_grid"])}

        return Cell("sfm_s_per_scene", "s", run, lambda t: t,
                    lambda: _json_after(_cli(argv, dev)[1], "stage ms: "), lambda: _cli(argv, dev), extras)
    if name == "stream":
        from cl_multiview_stereo_tpu_torch.io.prefetcher import run_scenes
        from cl_multiview_stereo_tpu_torch.testing.synthetic import fronto_parallel_scene

        root_b = os.path.join(root, "scene_b")
        os.makedirs(root_b)
        rgb_b, _ = fronto_parallel_scene(h, w, s.array_width, s.array_height, disp=STREAM_B_DISP,
                                         bl_ratio=s.bl_ratio, seed=STREAM_B_SEED)
        order = [lst, write_scene(root_b, rgb_b)] * 2

        def run() -> tuple[float, object]:
            done = []
            t0 = time.perf_counter()
            for _, art in run_scenes(pipe, order, depth=STREAM_DEPTH):
                _sync(dev)
                done.append(time.perf_counter() - t0)
            return done[-1] - done[0], art

        return Cell("stream_views_per_s", "views/s", run, lambda t: (len(order) - 1) * s.view_num / t,
                    None, run, lambda n: {"scenes": len(order), "prefetch_depth": STREAM_DEPTH})
    raise ValueError(f"cell must be one of {CELLS}, got {name!r}")


def kernel_launches() -> dict[str, int]:
    """Each kernel's launches since :func:`reset_launches`, graph replays
    included."""
    from cl_multiview_stereo_tpu_torch.models.mvs_pipeline import REPLAYED_LAUNCHES, launch_counts
    from cl_multiview_stereo_tpu_torch.ops import sweep

    counts = {"sweep": sweep.LAUNCHES, **launch_counts()}
    return {k: n + REPLAYED_LAUNCHES.get(k, 0) for k, n in counts.items()}


def reset_launches() -> None:
    from cl_multiview_stereo_tpu_torch.models.mvs_pipeline import REPLAYED_LAUNCHES
    from cl_multiview_stereo_tpu_torch.ops import consistency, cost_volume, slic, sweep

    cost_volume.LAUNCHES = sweep.LAUNCHES = consistency.LAUNCHES = 0
    slic.LAUNCHES.update(dict.fromkeys(slic.LAUNCHES, 0))
    REPLAYED_LAUNCHES.clear()


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="bench")
    ap.add_argument("--cell", default="slice", choices=CELLS)
    ap.add_argument("--runs", type=int, default=5, help="timed runs after the warm-up")
    ap.add_argument("--hw", default="1080x1920", help="image height x width")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VAL",
                    help="override a SystemSettings field")
    ap.add_argument("--stages", action="store_true", help="add one eager run's stage ms")
    ap.add_argument("--profile", action="store_true", help="add profile_stages' breakdown of one more run")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu (device fields null)")
    return ap


def main(argv: list[str] | None = None) -> dict:
    args = build_parser().parse_args(argv)

    from cl_multiview_stereo_tpu_torch.cli import _parse_overrides, resolve_device
    from cl_multiview_stereo_tpu_torch.config import SystemSettings
    from cl_multiview_stereo_tpu_torch.device import card_name
    from cl_multiview_stereo_tpu_torch.tools.profile_stages import breakdown, parse_hw, profiled

    dev = resolve_device(args.device)
    overrides = _parse_overrides(args.set)
    s = SystemSettings().replace(**overrides)
    h, w = parse_hw(args.hw)
    cuda = dev.type == "cuda"
    with tempfile.TemporaryDirectory() as root:
        cell = make_cell(args.cell, s, h, w, dev, root, args.set)
        if args.stages and cell.stages is None:
            raise SystemExit(f"the {args.cell} cell has no stages")
        cell.run()  # warm-up
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        reset_launches()
        runs = [cell.run()[0] for _ in range(args.runs)]
        launches = kernel_launches()
        peak = torch.cuda.max_memory_allocated(dev) / GIB if cuda else None
        median = statistics.median(runs)
        rec = {
            "metric": cell.metric, "value": cell.value(median), "unit": cell.unit, "cell": args.cell,
            "median_s": median, "min_s": min(runs), "max_s": max(runs), "runs_s": runs,
            "peak_mem_gib": peak, "stage_ms": None, "breakdown": None,
            "card": card_name() if cuda else "cpu", "settings": overrides, "hw": f"{h}x{w}",
            "launches": launches,
        }
        rec.update(cell.extras(args.runs))
        if cuda and args.stages:
            rec["stage_ms"] = cell.stages()
        if cuda and args.profile:
            rec["breakdown"] = breakdown(profiled(cell.trace))
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
