"""Mean time from a request's arrival at ``FluxServer.submit`` to its
encoded lane in the queue: the submitting thread's tokenize, T5 + CLIP
enqueue and prompt-LRU wait (``request_trace``), over the completed
requests due before the traced sub-window, ms."""

from benchmark.harness import records


def read(run):
    recs = records.requests(run)
    if not recs:
        return None
    return 1e3 * sum(r["queued"] - r["arrive"] for r in recs) / len(recs)
