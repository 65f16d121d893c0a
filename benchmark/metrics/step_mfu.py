"""The step's share of the chip's peak: the step's matmul and attention
operations, each at the published dense peak of the precision the
configuration computes it in (work/), over the measured step time (the
window's denoise_s per step), %."""


def read(run):
    done = run.out.get("completed", [])
    steps = len(done) * run.steps_per_image()
    if not steps or run.traced is None:
        return None
    step_s = sum(d["timings"]["denoise_s"] for d in done) / steps
    return 100.0 * run.step_work()["peak_s"] / step_s
