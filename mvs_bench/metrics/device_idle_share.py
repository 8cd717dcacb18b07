"""``device_idle_share``: the share of the traced stretch in which no
operation ran on the device, 100·(1 - union of the busy intervals /
stretch)."""

from mvs_bench import trace


def read(run):
    if run.stretch is None or not run.stretch.ops:
        return None
    a, b = run.stretch.window
    return 100.0 * (1.0 - trace.busy_us(run.stretch.ops, run.stretch.window) / (b - a))
