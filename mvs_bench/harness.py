"""One run of one cell: captures from the seed, set-up, the measured
window, the traced stretch, the check against the plain reference, and the
numbers.

Everything that belongs to a configuration, a traffic mix, a cell's check
limits or a metric is found by name under the data root:
``configs/<config>.json``, ``traffic/<traffic>.json``,
``limits/<workload>.json`` and ``metrics/<metric>.py`` (for a dotted name
``a.b`` without a file of its own, ``metrics/a.py`` read with the part
``b``).  The loop drives the port's one-program forward,
``MVSPipeline.jitted()`` (``run`` replayed as one CUDA graph), at the
configuration's defaults, and copies each scene's fused maps to pinned host
memory, as a user of a capture rig needs them.
"""

from __future__ import annotations

import collections
import concurrent.futures
import gc
import importlib.util
import json
import random
import sys
import time
from pathlib import Path
from typing import NamedTuple

import torch

from mvs_bench import judge, reference, scenes
from mvs_bench import trace as tracing

PKG = Path(__file__).resolve().parent
# top-level module names that may not be loaded once the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "cl_multiview_stereo_tpu")
SPIN_S = 0.002  # the open loop sleeps until this long before a due time, then spins


def now() -> float:
    return time.perf_counter()


def say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class Cell(NamedTuple):
    name: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def load_cell(spec_path: Path, root: Path, workload: str) -> Cell:
    """The cell ``workload`` of the benchmark file ``spec_path``, with its
    configuration, traffic and limits from the data root ``root``, and the
    metrics it reports: the end-to-end ones that name it or name no cells,
    and the per-layer ones that name it, or that name no cells and move an
    end-to-end metric it reports."""
    spec = json.loads(Path(spec_path).read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise ValueError(f"no workload {workload!r}; the benchmark has {sorted(cells)}")
    wl = cells[workload]
    read = lambda *parts: json.loads(root.joinpath(*parts).read_text())  # noqa: E731
    e2e = [m for m in spec["end_to_end"] if workload in m.get("workloads", [workload])]
    names = {m["name"] for m in e2e}
    per = [m for m in spec["per_layer"]
           if (workload in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return Cell(workload, read("configs", f"{wl['config']}.json"), read("traffic", f"{wl['traffic']}.json"),
                read("limits", f"{workload}.json"), e2e, per)


def run_settings(cell: Cell) -> dict:
    """The configuration's settings with the traffic's disparity ladder,
    as a user sets ``min_disp``/``max_disp`` for a recording."""
    return {**cell.config["settings"], **cell.traffic.get("ladder", {})}


# ---------------------------------------------------------------------------
# The system under test
# ---------------------------------------------------------------------------


class Port:
    """``MVSPipeline.jitted()`` at the configuration's defaults: dense depth
    init, packed pairs, the gather consistency engine, no cross-check."""

    def __init__(self, settings: dict, w: int, h: int, dev: torch.device):
        from cl_multiview_stereo_tpu_torch.config import SystemSettings
        from cl_multiview_stereo_tpu_torch.models.mvs_pipeline import MVSPipeline

        self.pipe = MVSPipeline.create(w, h, SystemSettings.from_dict(settings), device=dev,
                                       depth_method="dense", pair_layout="packed", cross_check=False)
        self.forward = self.pipe.jitted()

    def eager(self, capture, timer):
        return self.pipe.run(capture, timer=timer)


def load_kernels() -> bool:
    """Build (all at once) and load every kernel library of the port;
    whether any had to be compiled."""
    from cl_multiview_stereo_tpu_torch.kernels import build

    names = sorted(p.stem for p in build.CSRC.glob("*.cu"))
    with concurrent.futures.ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        logs = [f.result()[1] for f in [pool.submit(build.build, n) for n in names]]
    for n in names:
        build.load(n)
    return any(logs)


def make_pool(cell: Cell, seed: int, dev: torch.device) -> list:
    """The traffic's pool of captures of seed ``seed``, rendered on ``dev``
    and held in (on a card, pinned) host memory, as a rig's capture software hands
    frames over."""
    st, tr = run_settings(cell), cell.traffic
    w, h = cell.config["image"]["width"], cell.config["image"]["height"]
    pool = []
    for i in range(tr["pool"]):
        cap = scenes.render(seed, i, (st["array_width"], st["array_height"]), h, w, st["bl_ratio"], tr["scene"],
                            tr["disparity"]["lo"], tr["disparity"]["hi"], dev)
        host = torch.empty(cap.shape, dtype=torch.uint8, pin_memory=dev.type == "cuda")
        host.copy_(cap)
        pool.append(host)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return pool


def artifacts(art, disp_full) -> dict:
    """The layers of the program's artifacts ``art`` that the check holds to
    the reference, with the maps as the host received them."""
    return dict(lab=art.lab, labels=art.labels, center=art.spmap.center, color=art.spmap.color, extent=art.extent,
                disp_init=art.disp_init, d=art.state.d, n=art.state.n, disp_full=disp_full)


# ---------------------------------------------------------------------------
# The loop
# ---------------------------------------------------------------------------


class Reservoir:
    """A uniform sample, drawn from the seed, of ``k`` scenes of a window
    of unknown length: scene ``i`` takes a slot with probability k/(i+1)."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng = k, random.Random(seed)

    def pick(self, i: int) -> int | None:
        if i < self.k:
            return i
        j = self.rng.randrange(i + 1)
        return j if j < self.k else None


class Loop:
    """Scenes through the forward: a capture in (the forward copies it on
    the replay's stream), the replay, its maps out to pinned host memory.
    The host waits for a scene's maps once ``in_flight`` scenes are
    enqueued; the open loop takes one scene at a time."""

    def __init__(self, forward, pool: list, check: int, seed: int, dev: torch.device):
        self.forward, self.pool = forward, pool
        v, h, w = pool[0].shape[:3]
        self.pin = dev.type == "cuda"
        self.roll = torch.empty((v, h, w), dtype=torch.float32, pin_memory=self.pin)
        self.slots = [torch.empty((v, h, w), dtype=torch.float32, pin_memory=self.pin) for _ in range(check)]
        self.kept: list = [None] * check  # (scene, capture, artifacts) of each slot
        self.reservoir = Reservoir(check, seed)
        self.spans: list = []  # (begin, end) CUDA events of each scene of the window
        self.count = 0  # scenes of the window so far

    def issue(self, j: int, sample: bool):
        """Enqueue capture ``j`` and its maps' copy to the host; the event
        that marks the maps on the host (None on the CPU, where the copy has
        ended on return)."""
        slot = self.reservoir.pick(self.count) if sample else None
        out = self.roll if slot is None else self.slots[slot]
        begin = end = None
        if self.pin:
            begin, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            begin.record()
        with torch.profiler.record_function("bench.forward"):
            art = self.forward(self.pool[j])
        with torch.profiler.record_function("bench.maps_out"):
            out.copy_(art.disp_full, non_blocking=self.pin)
        if self.pin:
            end.record()
        if slot is not None:
            self.kept[slot] = (self.count, j, art)
        if sample:
            self.count += 1
            if self.pin:
                self.spans.append((begin, end))
        return end

    @staticmethod
    def wait(end) -> None:
        if end is not None:
            with torch.profiler.record_function("bench.wait_maps"):
                end.synchronize()

    def scene(self, j: int, sample: bool) -> None:
        self.wait(self.issue(j, sample))

    def closed(self, seconds: float | None, scenes_n: int | None = None, sample: bool = True,
               in_flight: int = 1) -> list:
        """Back to back for ``seconds`` (or ``scenes_n`` scenes), the next
        scene enqueued before the host waits for the oldest one's maps while
        fewer than ``in_flight`` are enqueued: (due, start, done) host times
        of each, due = start = when it was enqueued."""
        recs, pending, t0, i = [], collections.deque(), now(), 0
        while True:
            more = (now() < t0 + seconds) if seconds is not None else (i < scenes_n)
            if more:
                start = now()
                pending.append((start, self.issue(i % len(self.pool), sample)))
                i += 1
            if pending and (len(pending) >= in_flight or not more):
                start, end = pending.popleft()
                self.wait(end)
                recs.append((start, start, now()))
            elif not more:
                return recs

    def open(self, rate: float, seconds: float | None, scenes_n: int | None = None,
             sample: bool = True) -> tuple[list, list]:
        """Captures due every 1/``rate`` s for ``seconds`` (or ``scenes_n``
        captures), each started once it is due and the previous scene's maps
        are on the host: (due, start, done) of each, and how late the loop
        started each capture that found it idle."""
        period, recs, late, k = 1.0 / rate, [], [], 0
        t0 = now()
        done = t0
        while True:
            due = t0 + k * period
            if (due >= t0 + seconds) if seconds is not None else (k >= scenes_n):
                return recs, late
            with torch.profiler.record_function("bench.wait_due"):
                while (left := due - now() - SPIN_S) > 0:
                    time.sleep(min(left, 0.05))
                while now() < due:
                    pass
            start = now()
            if done <= due:
                late.append(start - due)
            self.scene(k % len(self.pool), sample)
            done = now()
            recs.append((due, start, done))
            k += 1


# ---------------------------------------------------------------------------
# A run
# ---------------------------------------------------------------------------


class Run:
    """What the metric readers read: set-up, the window's host times, the
    traced stretch, the eager stage trace and the operation counts."""

    def __init__(self):
        self.setup_s = 0.0
        self.setup_parts: dict = {}
        self.scene_mp = 0.0  # megapixels of a capture, V·H·W / 1e6
        self.window: list = []  # (due, start, done) of each scene of the window
        self.late: list = []  # the open loop's lateness on captures that found it idle
        self.stretch: tracing.Trace | None = None
        self.stretch_scenes = 0
        self.eager: tracing.Trace | None = None
        self.eager_runs = 0
        self.work: dict | None = None  # operation -> (bytes, operations) a scene


def _reader(name: str, dirs: list):
    """The metric's reader: ``read(run)`` of ``metrics/<name>.py``, or
    ``read(run, part)`` of ``metrics/<prefix>.py`` for ``<prefix>.<part>``."""
    prefix, _, part = name.partition(".")
    for stem, args in ((name, ()), (prefix, (part,))):
        for d in dirs:
            path = Path(d) / "metrics" / f"{stem}.py"
            if path.is_file() and (stem == name or part):
                spec = importlib.util.spec_from_file_location(f"mvs_bench_metric_{stem.replace('.', '_')}", path)
                mod = importlib.util.module_from_spec(spec)
                spec.loader.exec_module(mod)
                return lambda run, mod=mod, args=args: mod.read(run, *args)
    raise FileNotFoundError(f"no reader for metric {name!r} under {dirs}")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared whole."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def run_cell(cell: Cell, *, seed: int, seconds: float, trace: bool, dev: torch.device, root: Path,
             t_start: float) -> dict:
    """One run of ``cell``: returns the result line's object."""
    run = Run()
    parts = run.setup_parts
    t = now()
    import cl_multiview_stereo_tpu_torch  # noqa: F401  (the port's import, counted as set-up)

    parts["import_s"] = now() - t_start
    t = now()
    parts["compiled"] = load_kernels() if dev.type == "cuda" else False
    parts["kernel_libraries_s"] = now() - t

    t = now()
    st = run_settings(cell)
    w, h = cell.config["image"]["width"], cell.config["image"]["height"]
    tr = cell.traffic
    pool = make_pool(cell, seed, dev)
    parts["capture_pool_s"] = now() - t

    t = now()
    port = Port(st, w, h, dev)
    loop = Loop(port.forward, pool, tr["check_scenes"], seed, dev)
    for j in range(len(pool)):  # the capture (an eager run, then the graph), then a replay of each capture
        loop.scene(j, sample=False)
    parts["warm_up_and_capture_s"] = now() - t
    run.setup_s = now() - t_start
    run.scene_mp = pool[0][..., 0].numel() / 1e6
    say("setup_s parts: " + json.dumps(parts))

    gc.collect()
    gc.disable()  # no collector pause of the harness's own in the window
    if tr["loop"] == "closed":
        run.window = loop.closed(seconds, in_flight=tr["in_flight"])
    else:
        run.window, run.late = loop.open(tr["rate_per_s"], seconds)
    gc.enable()
    service = sorted(1e3 * (done - start) for _, start, done in run.window) or [float("nan")]
    say(f"window: {len(run.window)} scenes; enqueued to maps on the host {service[len(service) // 2]:.4f} ms at the "
        f"median, {service[-1]:.4f} ms at most")
    if loop.spans:  # where the host's time went: the device's own time a scene, and its share of the window
        spans = sorted(b.elapsed_time(e) for b, e in loop.spans)
        say(f"device time a scene, capture in to maps out (CUDA events): {spans[len(spans) // 2]:.4f} ms at the median, "
            f"{spans[int(0.95 * (len(spans) - 1))]:.4f} ms at the 95th percentile, {spans[-1]:.4f} ms at most; "
            f"{1e3 * (run.window[-1][2] - run.window[0][1]) - sum(spans):.1f} ms of the window without a scene on the "
            f"device")
    if run.late:
        say(f"open loop: captures due {len(run.window)}, {len(run.late)} found the loop idle; the loop "
            f"started those late by {1e3 * max(run.late):.4f} ms at most, {1e3 * sum(run.late) / len(run.late):.4f} ms "
            f"on average")

    if trace and dev.type == "cuda":
        from cl_multiview_stereo_tpu_torch.utils.timing import StageTimer

        out: list = []
        with tracing.recording(out):
            if tr["loop"] == "closed":
                loop.closed(None, tr["trace_scenes"], sample=False, in_flight=tr["in_flight"])
            else:
                loop.open(tr["rate_per_s"], None, tr["trace_scenes"], sample=False)
        run.stretch, run.stretch_scenes = out[0], tr["trace_scenes"]
        eager_caps = [pool[j].to(dev) for j in range(tr["eager_runs"])]
        run.eager = tracing.whole(lambda: [port.eager(c, StageTimer()) for c in eager_caps])
        run.eager_runs = len(eager_caps)
        del eager_caps

    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
              "count": 1,
              "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0}
    if run.stretch is not None:
        device["busy_s"] = tracing.busy_us(run.stretch.ops, run.stretch.window) / 1e6
        device["window_s"] = (run.stretch.window[1] - run.stretch.window[0]) / 1e6

    # the check: the program's state goes, then the reference of each
    # sampled scene's capture, on the same device
    kept = [k for k in loop.kept if k is not None]
    host_maps = [loop.slots[s] for s, k in enumerate(loop.kept) if k is not None]
    del port, loop
    ref_st = reference.Settings.from_dict(st)
    refs, readings = {}, []
    for (_, j, art), host_map in zip(kept, host_maps):
        if j not in refs:
            refs[j] = reference.run(pool[j].to(dev), ref_st)
        readings.append(judge.compare(artifacts(art, host_map), refs[j]))
    numbers = judge.worst(readings) if readings else {}
    failed = sum(any(r[k] > cell.limits[k] for k in judge.NUMBERS) for r in readings)
    correct = bool(readings) and failed == 0 and len(run.window) > 0

    if run.stretch is not None:
        from mvs_bench import counts

        works = [counts.scene_work(ref_st, r) for r in refs.values()]
        run.work = {op: tuple(sum(wk[op][i] for wk in works) / len(works) for i in range(2)) for op in works[0]}

    dirs = [root, PKG]
    entries = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in entries:
        value = _reader(m["name"], dirs)(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": len(run.window), "failed": failed, "metrics": metrics,
              "device": device}
    if run.stretch is not None:
        result["breakdown"] = breakdown(run.stretch)
    result["checks"] = {k: {"value": numbers.get(k), "limit": cell.limits[k]} for k in judge.NUMBERS}
    for k in judge.NUMBERS:
        say(f"check {k}: {numbers.get(k)} (limit {cell.limits[k]})")
    return result


def breakdown(t: tracing.Trace, n: int = 10) -> dict:
    """The device operations that took most time in the stretch, and its
    longest idle gaps, each named by the harness span and host operation
    open at its middle: what the host was doing while the device waited."""
    totals: dict[str, float] = {}
    for op in t.ops:
        totals[op.name] = totals.get(op.name, 0.0) + (op.end - op.start) / 1e6
    top = sorted(totals.items(), key=lambda kv: -kv[1])[:n]
    named = []
    for a, b in tracing.idle_gaps(t.ops, t.window)[:n]:
        mid = (a + b) / 2
        named.append([f"{tracing.innermost(t.ranges, mid) or 'no span'} / {tracing.innermost(t.host, mid) or 'no host op'}",
                      (b - a) / 1e6])
    return {"device_ops": [[name[:160], s] for name, s in top], "idle_gaps": named}
