"""Device kernels launched per denoise step, all kinds. From the traced image."""


def read(run):
    ops = run.denoise_ops()
    if not ops or not run.traced_steps():
        return None
    return sum(1 for _, _, _, cat in ops if cat == "kernel") / run.traced_steps()
