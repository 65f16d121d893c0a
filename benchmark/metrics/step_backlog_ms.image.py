"""Mean over the window's denoise steps of the step's wall time ending in a
device sync minus its host time until the Euler update returned
(FluxPipeline.timings ``steps_s`` - ``steps_host_s``), ms: the work the
device still had queued when the host had launched the step; about 0 where
the host sets the pace."""


def read(run):
    backlog = []
    for d in run.out.get("completed", []):
        t = d["timings"]
        if "steps_host_s" not in t:
            return None
        backlog += [s - h for s, h in zip(t["steps_s"], t["steps_host_s"])]
    return 1e3 * sum(backlog) / len(backlog) if backlog else None
