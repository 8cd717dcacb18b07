"""``stage_ms.<stage>``: device ms a scene of the operations the host
launched inside the program's ``StageTimer`` range ``<stage>``, from eager
``run(timer)`` calls on the pool's captures after the traced stretch (a
replayed graph has no ranges)."""

from mvs_bench import trace


def read(run, stage):
    if run.eager is None:
        return None
    ms = trace.by_launch_range(run.eager).get(stage)
    return None if ms is None else ms / run.eager_runs
