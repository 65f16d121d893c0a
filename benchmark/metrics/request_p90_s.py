"""The 90th percentile (nearest rank) of request latency over every request
due in the window, from its due time to its u8 image; a failed or missing
request counts as infinitely late."""

import math

from benchmark.harness.main import percentile


def read(run):
    lat = run.out.get("latencies")
    if not lat:
        return None
    p = percentile(lat, 90.0)
    return p if math.isfinite(p) else None
