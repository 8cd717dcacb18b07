"""``queue_ms_p95``: the 95th percentile over every scene of the window of
the time from its due time to the start of its forward (host clock): the
wait in the queue in front of the one static input."""

import numpy as np


def read(run):
    if not run.window:
        return None
    return float(np.percentile([1e3 * (start - due) for due, start, _ in run.window], 95))
