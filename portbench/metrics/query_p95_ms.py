"""query_p95_ms (ms, host clock): the 95th percentile of the latency of all
requests in the window, from send to the answer on the host (numpy's
linear interpolation between order statistics)."""

import numpy as np


def read(run):
    lat = run.record.get("latencies_s")
    if not lat:
        return None
    return float(np.percentile(np.asarray(lat), 95)) * 1e3
