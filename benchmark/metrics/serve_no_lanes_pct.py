"""Share of the window before the traced sub-window in which FluxServer's
worker had no lane in flight (its ``serve.idle`` log entries, clipped to
that stretch), %: idle time the arrivals leave, not the program."""

from benchmark.harness import records


def read(run):
    got = records.log(run, "serve.idle")
    if got is None:
        return None
    idle, (t0, t_open) = got
    if t_open <= t0:
        return None
    covered = sum(max(0.0, min(e["end"], t_open) - max(e["start"], t0)) for e in idle)
    return 100.0 * covered / (t_open - t0)
