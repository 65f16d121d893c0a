"""The 90th percentile (nearest rank) of a request's wait in FluxServer's
queue, from the encoded lane queued to its admission by the worker
(``request_trace``), over the completed requests due before the traced
sub-window, s."""

from benchmark.harness import records
from benchmark.harness.main import percentile


def read(run):
    recs = records.requests(run)
    if not recs:
        return None
    return percentile([r["admitted"] - r["queued"] for r in recs], 90.0)
