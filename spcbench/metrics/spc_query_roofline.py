"""spc_query_roofline: the least time the traced batches' pairs need at
the card's HBM bandwidth (spcbench.roofline) over the query kernel's
device time in them, in percent."""

from spcbench import roofline


def read(run):
    tr, spans = run.trace, run.tracer.spans if run.tracer else []
    sizes = run.state.get("row_sizes")
    if tr is None or not spans or sizes is None:
        return None
    k1 = tr.kernel_in(spans, "spc_query").sum()
    if k1 <= 0:
        return None
    batches = run.kind.batches
    need = sum(roofline.least_seconds(
        roofline.k1_bytes(sizes, *batches[i % len(batches)]))
        for i in range(len(spans)))
    return 100.0 * need / k1
