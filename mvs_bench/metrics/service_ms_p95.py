"""``service_ms_p95``: the 95th percentile over every scene of the window of
the time from the start of its forward (capture in, replay) to its maps on
the host (host clock)."""

import numpy as np


def read(run):
    if not run.window:
        return None
    return float(np.percentile([1e3 * (done - start) for _, start, done in run.window], 95))
