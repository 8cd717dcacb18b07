"""The smoothness kernels on the card, this checkout against another tree
(an unpacked parent commit), each tree in its own processes, in turns.

Usage:

  python -m cl_multiview_stereo_tpu_torch.tools.smooth_turns [--parent DIR] \\
      [--turns 2] [--out FILE]

On ``bench.py``'s scene (``profile_stages.scene``: 9 views of 1080x1920 at
``SystemSettings()``), each tree's worker measures:

- ``calls``: each smoothness kernel's device ms on each call of the
  refinement that ``tools.roofline.smooth_calls`` records over the init and
  every sweep (each sweep run from the initial state), the mean of two
  windows of 10 launches between CUDA events, the device first spinning
  while the host queues them, and each call's shapes;
- ``launches``: the device ms of each smoothness kernel launch of one eager
  ``MVSPipeline.run``, in launch order, from ``torch.profiler``;
- ``stages``: that traced run's device ms by ``StageTimer`` stage
  (``profile_stages.stage_device_ms``; the trace is taken again while its
  kernels fall short of its launch calls, up to three times);
- ``replay``: ``tools.bench --cell slice --runs 5``'s seconds per replay of
  ``MVSPipeline.jitted()``'s graph (median, min, max);
- ``off_map`` (where the tree's ``ops/refine`` has ``tap_on_map``): the
  share of (cell, tap) pairs off the map at the init's and each sweep's
  reach, by the plain form's rule on the scene's flatness.

The workers run in the order parent, this, this, parent (``--turns``
pairs; without ``--parent`` this tree alone, ``--turns`` times).  This
process adds each call's bound from its shapes with this checkout's
``tools.roofline`` counts, the same for both trees, prints one line per
worker and ends with one JSON object (``card``, ``order``, ``workers``,
``bounds``), also written to ``--out``.  Needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve()
THIS_TREE = HERE.parents[2]
SMOOTH_KERNELS = ("smooth_cache_kernel", "smooth_moves_kernel")
WORKER_TIMEOUT_S = 900
QUEUE_CYCLES = 10_000_000  # tools.roofline's


def _cuda_ms(fn, iters: int = 10) -> float:
    """``tools.roofline.cuda_ms``'s two windows, written out (a parent tree
    may time otherwise): the device spins while the host queues the calls."""
    import torch

    fn()
    windows = []
    for _ in range(2):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(QUEUE_CYCLES)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        windows.append(start.elapsed_time(end) / iters)
    return sum(windows) / 2


def _call_shape(kernel: str, a, k, steps: int) -> dict:
    """The shapes a call's bound reads: the map (V, Mh, Mw), the cells
    scored, the taps, the moves and whether ``d_c`` is one broadcast row."""
    if kernel == "smooth_cache":
        v, mh, mw = a[1].shape
        rows = (k.get("rows") or (0, mh))[1]
        return {"map": [v, mh, mw], "rows": rows, "taps": 8 + 4 * steps}
    d_c = a[1]
    m, v, rows, mw = d_c.shape
    return {"moves": m, "rows": rows, "taps": 8 + 4 * steps, "broadcast_d": bool(m > 1 and d_c.stride(0) == 0)}


def _trace_smooth_launches(pipe, rgb) -> list[dict]:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    want = 2 + 3 * pipe.settings.no_prop
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            pipe.run(rgb)
            torch.cuda.synchronize()
        evs = sorted((e.time_range.start, e.name, (e.time_range.end - e.time_range.start) / 1e3)
                     for e in prof.events()
                     if e.device_type == DeviceType.CUDA and any(n in e.name for n in SMOOTH_KERNELS))
        if len(evs) == want:
            return [{"kernel": next(n for n in SMOOTH_KERNELS if n in name)[:-len("_kernel")], "ms": ms}
                    for _, name, ms in evs]
    raise RuntimeError(f"no trace held the run's {want} smoothness launches in 3 tries")


def _stage_device_ms(pipe, rgb) -> dict:
    # profile_stages.whole_profile's rule, written out: a parent tree may
    # predate it
    from cl_multiview_stereo_tpu_torch.tools import profile_stages as ps
    from cl_multiview_stereo_tpu_torch.utils.timing import StageTimer

    for _ in range(3):
        p = ps.profiled(lambda: pipe.run(rgb, timer=StageTimer()))
        kernels = sum(n for name, (_, n) in p.device_ops.items() if not name.startswith(("Memcpy", "Memset")))
        calls = sum(n for name, n in p.host_calls.items() if "LaunchKernel" in name)
        if kernels >= calls:
            return {"stage_device_ms": ps.stage_device_ms(p), "device_ms": p.device_ms, "wall_ms": p.wall_ms}
    raise RuntimeError("no whole trace of the run in 3 tries")


def worker(out: str) -> None:
    """Measures the tree on ``PYTHONPATH`` and writes its record to ``out``."""
    import torch

    from cl_multiview_stereo_tpu_torch.config import RefinementSchedule, SystemSettings
    from cl_multiview_stereo_tpu_torch.models.mvs_pipeline import MVSPipeline
    from cl_multiview_stereo_tpu_torch.ops import refine
    from cl_multiview_stereo_tpu_torch.tools import bench, roofline
    from cl_multiview_stereo_tpu_torch.tools.profile_stages import scene

    dev = torch.device("cuda")
    s, h, w = SystemSettings(), 1080, 1920
    sched = RefinementSchedule.create(s)
    rgb = torch.as_tensor(scene(s, h, w), device=dev)
    pipe = MVSPipeline.create(w, h, s, device=dev)
    pipe.run(rgb)  # builds the kernels
    rec = {"tree": str(Path(refine.__file__).resolve().parents[2])}
    rec["launches"] = _trace_smooth_launches(pipe, rgb)
    rec["stages"] = _stage_device_ms(pipe, rgb)
    sweeps = tuple(range(sched.no_prop))
    calls = roofline.smooth_calls(s, rgb, dev, sweeps=sweeps)
    steps = {"init": sched.kernel_steps} | {f"sweep {it}": sched.steps_per_iter[it] for it in sweeps}
    rec["calls"] = []
    for tag, c in calls.items():  # (kernel, args, keywords[, plain args]), by the tree's own smooth_calls
        kernel, a, k = c[:3]
        phase = "init" if tag.startswith("init") else tag.rsplit(" ", 1)[0]
        rec["calls"].append({"tag": tag, "kernel": kernel, "ms": _cuda_ms(roofline.smooth_case(*c)[0]),
                             "shape": _call_shape(kernel, a, k, steps[phase])})
    del calls
    if hasattr(refine, "tap_on_map"):
        ctx = roofline.sweep0_state(s, rgb, dev)[0]
        reach = {"init": (sched.kernel_steps, sched.sp_kernel_step)} | {
            f"sweep {it}": (sched.steps_per_iter[it], sched.step_size_per_iter[it]) for it in sweeps}
        rec["off_map"] = {tag: 1.0 - float(refine.tap_on_map(refine.tap_step(ctx.fl, size), n).float().mean())
                          for tag, (n, size) in reach.items()}
    r = bench.main(["--cell", "slice", "--runs", "5"])
    rec["replay"] = {"median_s": r["median_s"], "min_s": r["min_s"], "max_s": r["max_s"]}
    Path(out).write_text(json.dumps(rec))


def _bounds(calls: list[dict]) -> dict:
    """Each call's (bound ms, bound by) from its shapes, by this checkout's
    ``tools.roofline`` counts on meta tensors."""
    from types import SimpleNamespace

    import torch

    from cl_multiview_stereo_tpu_torch.tools import roofline

    meta = lambda *shape, dtype=torch.float32: torch.empty(shape, dtype=dtype, device="meta")  # noqa: E731
    out, map_shape = {}, None
    for c in calls:
        sh = c["shape"]
        if c["kernel"] == "smooth_cache":
            map_shape = sh["map"]
            v, mh, mw = map_shape
            ring = [meta(v, sh["rows"], mw, 8) for _ in range(3)] + [meta(v, sh["rows"], mw, 8, dtype=torch.bool)]
            cache = SimpleNamespace(ring_dcx=ring[0], ring_dcy=ring[1], ring_d=ring[2], ring_ok=ring[3])
            work = roofline.smooth_cache_work(None, meta(v, mh, mw), cache)
        else:
            v, mh, mw = map_shape
            m, rows = sh["moves"], sh["rows"]
            cache = SimpleNamespace(cell_table=meta(v, mh, mw, 8), gammas=meta(sh["taps"]))
            d_c = meta(v, rows, mw)[None].expand(m, v, rows, mw) if sh["broadcast_d"] else meta(m, v, rows, mw)
            work = roofline.smooth_moves_work(cache, d_c, meta(m, v, rows, mw, 3))
        out[c["tag"]] = roofline.bound(*work)
    return out


def _summary(rec: dict) -> str:
    calls = {c["tag"]: c["ms"] for c in rec["calls"]}
    sweep0 = sum(calls[f"sweep 0 {p}"] for p in ("cache", "update", "refit"))
    st = rec["stages"]["stage_device_ms"]
    return (f"smoothness a scene {sum(c['ms'] for c in rec['launches']):.4f} ms traced "
            f"({len(rec['launches'])} launches), {sum(calls.values()):.4f} ms timed; sweep 0's {sweep0:.4f} ms; "
            f"init_state {st.get('init_state', 0.0):.3f}, propagate {st.get('propagate', 0.0):.3f} device ms; "
            f"replay median {rec['replay']['median_s']:.6f} s")


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(prog="smooth_turns")
    ap.add_argument("--parent", type=Path, help="another tree (e.g. an unpacked parent commit)")
    ap.add_argument("--turns", type=int, default=2, help="pairs of worker runs")
    ap.add_argument("--out", type=Path, help="also write the JSON record here")
    ap.add_argument("--worker", metavar="OUT", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        # run as a file: its own directory must not shadow the tree's modules
        sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE.parent]
        worker(args.worker)
        return {}

    from cl_multiview_stereo_tpu_torch.device import card_name, require_cuda

    require_cuda()
    trees = {"this": THIS_TREE} | ({"parent": args.parent.resolve()} if args.parent else {})
    order = []
    for _ in range(args.turns):
        order += ["parent", "this", "this", "parent"] if args.parent else ["this"]
    workers = []
    with tempfile.TemporaryDirectory() as tmp:
        for i, name in enumerate(order):
            out = Path(tmp) / f"{i}.json"
            env = dict(os.environ, PYTHONPATH=str(trees[name]))
            proc = subprocess.run([sys.executable, str(HERE), "--worker", str(out)], cwd=trees[name], env=env,
                                  capture_output=True, text=True, timeout=WORKER_TIMEOUT_S)
            if proc.returncode != 0:
                raise RuntimeError(f"the {name} worker failed (exit {proc.returncode}):\n{proc.stderr[-4000:]}")
            rec = json.loads(out.read_text()) | {"name": name}
            workers.append(rec)
            print(f"[turns] {i} {name}: {_summary(rec)}", flush=True)
    result = {"card": card_name(), "order": order, "workers": workers, "bounds": _bounds(workers[0]["calls"])}
    print(json.dumps(result), flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    return result


if __name__ == "__main__":
    main()
