"""Device time per denoise step of every operation outside the hand-written
kernel families (kernels/*.json): PyTorch's elementwise, copy, reduce and
GEMM kernels, ms. From the traced image."""


def read(run):
    ops = run.denoise_ops()
    if not ops or not run.traced_steps():
        return None
    rest = sum(dur for name, _, dur, _ in ops if run.family_of(name) is None)
    return rest * 1e-3 / run.traced_steps()
