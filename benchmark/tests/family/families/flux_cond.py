"""The route of the test-only family ``flux_cond``: the ``flux`` route with
one more per-request input, the conditioning plane of
``reference/flux_cond.py``, which the route adds to the initial noise of
the timed entry and of the reference alike. Closed loop only."""

from __future__ import annotations

import contextlib

from benchmark.families import flux
from benchmark.reference import flux_cond as reference

build_kernels, planes, build, decode_u8 = (flux.build_kernels, flux.planes, flux.build,
                                           flux.decode_u8)


@contextlib.contextmanager
def _conditioned(cond):
    """The program's noise draw, plus ``cond``, for the duration."""
    from diffusion_rs_tpu_torch.pipelines import flux_pipeline

    draw = flux_pipeline.get_noise
    flux_pipeline.get_noise = lambda *a, **k: draw(*a, **k) + cond
    try:
        yield
    finally:
        flux_pipeline.get_noise = draw


def image(pipe, cfg: dict, req, num_steps=None):
    with _conditioned(reference.condition(cfg, req, pipe.device)):
        return flux.image(pipe, cfg, req, num_steps)


def reference_latent(cfg: dict, planes: dict, req, device, prec=None):
    return reference.latent(cfg, planes, req, device, prec)[0]
