"""Whole-image latency: the total time of the window's images over their
count (prompt in, u8 image on the host; closed loop)."""


def read(run):
    done = run.out.get("completed", [])
    if not done or "start" not in done[0]:
        return None
    return sum(d["end"] - d["start"] for d in done) / len(done)
