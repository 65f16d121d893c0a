"""Device time per denoise step of the plain-torch ops launched inside the
model step's ``flux.qk_rope`` spans (models/flux.py: the q/k/v head split,
QK-RMSNorm, the joint cat, RoPE and the contiguous operands), the
hand-written kernel families (kernels/*.json) left out, ms. From the traced
image."""

from benchmark.harness import records


def read(run):
    return records.family_ms_per_step(run, "flux.qk_rope")
