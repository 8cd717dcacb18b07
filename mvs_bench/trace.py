"""What a ``torch.profiler`` trace says about the device: its operations,
the union of their busy intervals, the idle gaps between them, and each
operation's device time by the harness span or program range that launched
it.  The arithmetic is a copy of the port's ``tools/profile_stages.py``
(``idle_gaps``, ``innermost``, ``stage_device_ms``), with the busy share
taken from the union of the intervals rather than the sum of their
lengths, so overlapping operations count once.
"""

from __future__ import annotations

import contextlib
from typing import Callable, NamedTuple

import torch

# the profiler range around a traced stretch; its span is the window
WINDOW = "bench.window"


class Op(NamedTuple):
    name: str
    start: float  # trace microseconds
    end: float
    launched: float | None  # start of the host call that launched it


class Trace(NamedTuple):
    ops: list  # Op of every device operation
    ranges: list  # (name, start, end) of every record_function range
    host: list  # (name, start, end) of every other host operation
    window: tuple  # (start, end) of the WINDOW range


@contextlib.contextmanager
def recording(out: list):
    """Profile the body on the host and the card; append its :class:`Trace`
    to ``out``.  The body's span is the WINDOW range."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(WINDOW):
            yield
            torch.cuda.synchronize()
    ops, ranges, host, runtime, window = [], [], [], {}, (0.0, 0.0)
    device = []
    for e in prof.events():
        span = (e.time_range.start, e.time_range.end)
        if e.device_type == DeviceType.CUDA:
            if not e.is_user_annotation:
                device.append((e.name, *span, e.id))
            continue
        if e.name.startswith("cuda"):
            runtime[e.id] = span[0]
        if e.is_user_annotation:
            if e.name == WINDOW:
                window = span
            else:
                ranges.append((e.name, *span))
        else:
            host.append((e.name, *span))
    ops = [Op(name, a, b, runtime.get(i)) for name, a, b, i in device]
    out.append(Trace(ops, ranges, host, window))


def busy_us(ops, window: tuple) -> float:
    """Microseconds of ``window`` in which some operation ran."""
    total, edge = 0.0, window[0]
    for op in sorted(ops, key=lambda o: o.start):
        a, b = max(op.start, edge), min(op.end, window[1])
        if b > a:
            total += b - a
        edge = max(edge, op.end)
    return total


def innermost(ranges, t: float) -> str | None:
    """The innermost of ``ranges`` ((name, start, end)) open at ``t``."""
    open_at = [(start, start - end, name) for name, start, end in ranges if start <= t < end]
    return max(open_at)[2] if open_at else None


def idle_gaps(ops, window: tuple) -> list[tuple[float, float]]:
    """Every stretch of ``window`` that no operation covers, longest first."""
    gaps, edge = [], window[0]
    for op in sorted(ops, key=lambda o: o.start):
        if op.start > edge:
            gaps.append((edge, min(op.start, window[1])))
        edge = max(edge, op.end)
    if window[1] > edge:
        gaps.append((edge, window[1]))
    return sorted((g for g in gaps if g[1] > g[0]), key=lambda g: g[0] - g[1])


def by_launch_range(t: Trace) -> dict[str, float]:
    """Device ms of each range by which the host launched the work: each
    operation added to the innermost range open at its launch."""
    out: dict[str, float] = {}
    for op in t.ops:
        name = "unlinked" if op.launched is None else (innermost(t.ranges, op.launched) or "outside stages")
        out[name] = out.get(name, 0.0) + (op.end - op.start) / 1e3
    return out


def kernel_ms(ops, names: tuple) -> float | None:
    """Device ms of the operations whose kernel name (before any template
    arguments or parameter list) is one of ``names``; None when none ran."""
    hits = [op for op in ops if _kernel(op.name) in names]
    return sum(op.end - op.start for op in hits) / 1e3 if hits else None


def _kernel(name: str) -> str:
    """``void (anonymous namespace)::raster_kernel<4, 1, true>(int const*, ...)``
    -> ``raster_kernel``."""
    head = name.replace("(anonymous namespace)::", "").split("(")[0].split("<")[0].split("::")[-1].strip()
    return head.split()[-1] if head else head


def launches_match(t: Trace) -> bool:
    """Whether every kernel launch call of the trace has its kernel (the
    profiler now and then drops a profiling run's device events)."""
    kernels = sum(1 for op in t.ops if not op.name.startswith(("Memcpy", "Memset")))
    calls = sum(1 for name, _, _ in t.host if "LaunchKernel" in name)
    return kernels >= calls


def whole(fn: Callable[[], None], tries: int = 3) -> Trace:
    """A trace of ``fn()`` whose kernels are all there, taken again up to
    ``tries`` times."""
    for _ in range(tries):
        out: list = []
        with recording(out):
            fn()
        if launches_match(out[0]):
            return out[0]
    raise RuntimeError(f"no whole trace in {tries} tries")
