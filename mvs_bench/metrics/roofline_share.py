"""``roofline_share.<op>``: the least time the operation ``<op>`` takes a
scene on an H100 (``counts``, from its own inputs and outputs at the cell's
shapes and data) over its kernels' device ms a scene in the traced
stretch, in percent.  Nothing when none of its kernels ran."""

from mvs_bench import counts, trace


def read(run, op):
    if run.stretch is None or run.work is None:
        return None
    ms = trace.kernel_ms(run.stretch.ops, counts.KERNELS[op])
    if ms is None:
        return None
    return 100.0 * counts.least_ms(*run.work[op]) / (ms / run.stretch_scenes)
