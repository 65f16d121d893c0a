"""The reference of the test-only family ``flux_cond``: FLUX.1 text-to-image
whose initial noise carries one more per-request input, a conditioning
plane drawn from the request's own seed."""

from __future__ import annotations

import torch

from benchmark.reference import pipeline


def condition(cfg: dict, req, device) -> torch.Tensor:
    """[1, 16, h, w] f32: ``condition_scale`` times a standard normal draw of
    a CPU generator seeded with the request's seed + 1 (its noise has the
    seed itself)."""
    h, w = (req.height + 15) // 16 * 2, (req.width + 15) // 16 * 2
    gen = torch.Generator().manual_seed(int(req.seed) + 1)
    z = torch.randn((1, 16, h, w), generator=gen, dtype=torch.float32)
    return (cfg["condition_scale"] * z).to(device)


def latent(cfg: dict, planes: dict, req, device, prec=None) -> torch.Tensor:
    """The packed latent [1, S_img, 64] from the seed's noise plus the
    request's conditioning."""
    z = pipeline.noise(req.seed, req.height, req.width, device) + condition(cfg, req, device)
    return pipeline.latent(cfg, planes, req.prompt, req.seed, req.height, req.width, device,
                           prec, z=z)
