"""Requests' lanes per batched forward over the window (stats() deltas)."""


def read(run):
    st = run.out.get("stats")
    if not st or not st["forwards"]:
        return None
    return st["lane_steps"] / st["forwards"]
