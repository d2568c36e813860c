"""query_batch_p95_ms: the 95th percentile over the window's batches,
each from its call to its answers on the host, leaving out the batches
run under the profiler (the first ``trace_requests`` of a traced run)."""

import numpy as np


def read(run):
    lat = run.window.get("latencies_s") if "pairs" in run.window else None
    lat = lat[run.window.get("traced", 0):] if lat else None
    if not lat:
        return None
    return float(np.percentile(np.asarray(lat), 95)) * 1e3
