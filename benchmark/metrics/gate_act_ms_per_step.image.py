"""Device time per denoise step of the plain-torch ops launched inside the
model step's ``flux.gate_act`` spans (models/flux.py: GELU, the gated
residual adds, the single block's cat), the hand-written kernel families
(kernels/*.json) left out, ms. From the traced image."""

from benchmark.harness import records


def read(run):
    return records.family_ms_per_step(run, "flux.gate_act")
