"""Mean time from the enqueue of a request's last step to its image: the
device finishing the lane, the one decode thread's queue, the VAE decode
and the copy to the host (``request_trace``), over the completed requests
due before the traced sub-window, ms."""

from benchmark.harness import records


def read(run):
    recs = records.requests(run)
    if not recs:
        return None
    return 1e3 * sum(r["done"] - r["last_step"] for r in recs) / len(recs)
