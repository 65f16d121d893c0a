"""Images completed inside the window over the window's length."""


def read(run):
    if "latencies" not in run.out:
        return None
    return len(run.out["completed"]) / run.out["window_s"]
