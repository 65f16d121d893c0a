"""Denoise time per step of the window's images (FluxPipeline.timings
["denoise_s"], host clock ending in a device sync), ms."""


def read(run):
    done = run.out.get("completed", [])
    steps = len(done) * run.steps_per_image()
    if not steps:
        return None
    return 1e3 * sum(d["timings"]["denoise_s"] for d in done) / steps
