"""Median over FluxServer's batched forwards started before the traced
sub-window of the device's completion of the forward's Euler update (its
CUDA event, ``trace_snapshot``'s ``device_end``) minus the host's end of
enqueueing it, ms: about 0 where the worker's launches set the pace, many
ms where the device does."""

import statistics

from benchmark.harness import records


def read(run):
    got = records.log(run, "serve.forward")
    if got is None:
        return None
    backlog = [e["device_end"] - e["end"] for e in got[0] if e.get("device_end") is not None]
    return 1e3 * statistics.median(backlog) if backlog else None
