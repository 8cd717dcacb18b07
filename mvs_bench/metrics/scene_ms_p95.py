"""``scene_ms_p95``: the 95th percentile over every scene of the window of
the time from its capture's due time on the open-loop schedule to its maps
in host memory (host clock)."""

import numpy as np


def read(run):
    if not run.window:
        return None
    return float(np.percentile([1e3 * (done - due) for due, _, done in run.window], 95))
