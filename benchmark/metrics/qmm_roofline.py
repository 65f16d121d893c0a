"""The qmm family's share of its roofline in a denoise step: the work
model's bound for the step's products that family computes (work/) over the
family's device time per step (kernels/qmm.json), %. From the traced image."""


def read(run):
    ops = run.denoise_ops()
    if not ops or not run.traced_steps():
        return None
    dev_s = sum(dur for name, _, dur, _ in ops if run.family_of(name) == "qmm") * 1e-6
    if dev_s <= 0:
        return None
    return 100.0 * run.step_work()["qmm"]["bound_s"] / (dev_s / run.traced_steps())
