"""Share of the profiled window in which no device operation ran (the union
of kernel, copy and fill intervals), %."""


def read(run):
    t = run.trace
    if t is None or t.window_s() <= 0 or not t.ops:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s())
