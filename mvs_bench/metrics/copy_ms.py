"""``copy_ms``: device ms a scene of the capture's copy in and the maps'
copy out, the profiler's ``Memcpy HtoD`` and ``Memcpy DtoH`` operations of
the traced stretch over its scenes."""


def read(run):
    if run.stretch is None:
        return None
    ops = [op for op in run.stretch.ops if op.name.startswith(("Memcpy HtoD", "Memcpy DtoH"))]
    if not ops:
        return None
    return sum(op.end - op.start for op in ops) / 1e3 / run.stretch_scenes
