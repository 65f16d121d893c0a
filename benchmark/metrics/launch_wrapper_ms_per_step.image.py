"""Host time of the hand-written kernels' launch wrapper outside the entry
calls (ops/_cuda.launch_wrapper_ns: the grad check, the device context, the
stream lookup) over the window's denoise steps (FluxPipeline.timings
``launch_wrapper_s``), ms per step."""


def read(run):
    done = run.out.get("completed", [])
    steps = len(done) * run.steps_per_image()
    if not steps or any("launch_wrapper_s" not in d["timings"] for d in done):
        return None
    return 1e3 * sum(d["timings"]["launch_wrapper_s"] for d in done) / steps
