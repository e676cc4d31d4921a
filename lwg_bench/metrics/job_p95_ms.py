"""job_p95_ms: the 95th percentile (linear between order statistics)
over every job of the window of its start (the personalise call) to its
last frame on the host."""

import numpy as np


def read(rec):
    if "jobs" not in rec or not rec["jobs"]:
        return None
    lat = [1e3 * (end - start) for _, _, start, end in rec["jobs"]]
    return float(np.percentile(lat, 95))
