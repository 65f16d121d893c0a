"""Device time per denoise step of the plain-torch ops launched inside the
model step's ``flux.norm_mod`` spans (models/flux.py: the AdaLN modulation
with its chunks, LayerNorm, scale/shift), the hand-written kernel families
(kernels/*.json) left out, ms. From the traced image."""

from benchmark.harness import records


def read(run):
    return records.family_ms_per_step(run, "flux.norm_mod")
