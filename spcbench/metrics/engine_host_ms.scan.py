"""engine_host_ms.scan: median over the traced batches of each batch's
wall time less the device's busy time inside it (service, engine and
copies on the host)."""

import numpy as np


def read(run):
    tr, spans = run.trace, run.tracer.spans if run.tracer else []
    if tr is None or not tr.has_device or not spans:
        return None
    wall = np.array([(t1 - t0) * 1e-9 for t0, t1 in spans])
    return float(np.median(wall - tr.busy_in(spans))) * 1e3
