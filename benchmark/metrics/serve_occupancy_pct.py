"""FluxServer's lane occupancy over the window: lane steps over lane steps
plus padded lane steps (stats() deltas), %."""


def read(run):
    st = run.out.get("stats")
    if not st or st["lane_steps"] + st["padded_lane_steps"] == 0:
        return None
    return 100.0 * st["lane_steps"] / (st["lane_steps"] + st["padded_lane_steps"])
