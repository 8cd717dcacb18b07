"""Per-stage device timing with CUDA events.

A :class:`StageTimer` records an event pair around each stage on the
current stream; nothing synchronises until :meth:`StageTimer.ms` reads the
times, so timing does not change how the stages overlap with the host.
Host-only stages (``host=True``) are timed on the host clock instead, into
:attr:`StageTimer.host_s`.  Every stage is also a
``torch.profiler.record_function`` range of its name, by which
``tools/profile_stages`` names the device's idle gaps.
"""

from __future__ import annotations

import contextlib
import time

import torch

from cl_multiview_stereo_tpu_torch.device import require_cuda


class StageTimer:
    """Collects (name, start event, end event) per stage, in run order."""

    def __init__(self) -> None:
        require_cuda()
        self._events: list[tuple[str, torch.cuda.Event, torch.cuda.Event]] = []
        self.host_s: dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        try:
            with torch.profiler.record_function(name):
                yield
        finally:
            end.record()
            self._events.append((name, start, end))

    def ms(self) -> dict[str, float]:
        """Synchronise and return milliseconds per stage name (a name used
        more than once is summed)."""
        torch.cuda.synchronize()
        out: dict[str, float] = {}
        for name, start, end in self._events:
            out[name] = out.get(name, 0.0) + start.elapsed_time(end)
        return out

    @contextlib.contextmanager
    def host(self, name: str):
        """Host seconds of a stage that runs no device work (summed per name)."""
        t0 = time.perf_counter()
        try:
            with torch.profiler.record_function(name):
                yield
        finally:
            self.host_s[name] = self.host_s.get(name, 0.0) + time.perf_counter() - t0


@contextlib.contextmanager
def maybe_stage(timer: StageTimer | None, name: str, host: bool = False):
    """``timer.stage(name)`` (``timer.host(name)`` with ``host``) when a
    timer is given, else nothing."""
    if timer is None:
        yield
    else:
        with (timer.host(name) if host else timer.stage(name)):
            yield
