"""FLUX latent plumbing and the Euler denoise loop (port of
``pipelines/sampling.py``).

Noise contract: the JAX package draws its noise with ``jax.random``, which
PyTorch cannot reproduce. The port draws ``torch.randn`` from a
``torch.Generator`` on the target device, seeded with the request's seed, so
one seed gives one image on one device type; tests that compare the two
packages inject the same noise array into both.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch


def latent_hw(height: int, width: int) -> Tuple[int, int]:
    """Latent spatial dims: 2*ceil(px/16)."""
    return (height + 15) // 16 * 2, (width + 15) // 16 * 2


def get_noise(seed: int, num_samples: int, height: int, width: int,
              device) -> torch.Tensor:
    h, w = latent_hw(height, width)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    return torch.randn((num_samples, 16, h, w), generator=gen,
                       dtype=torch.float32, device=device)


def pack_latents(img: torch.Tensor) -> torch.Tensor:
    """BCHW -> [B, (h/2)(w/2), C*4] 2x2 patchify."""
    b, c, h, w = img.shape
    x = img.reshape(b, c, h // 2, 2, w // 2, 2).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(b, h // 2 * (w // 2), c * 4)


def unpack_latents(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """[B, hw, C*4] -> BCHW."""
    b, _, cphpw = x.shape
    h = (height + 15) // 16
    w = (width + 15) // 16
    c = cphpw // 4
    x = x.reshape(b, h, w, c, 2, 2).permute(0, 3, 1, 4, 2, 5)
    return x.reshape(b, c, h * 2, w * 2)


def make_img_ids(bs: int, h2: int, w2: int, device) -> torch.Tensor:
    """3-axis ids (0, row, col) per latent patch."""
    rows = torch.arange(h2, dtype=torch.float32, device=device)[:, None].expand(h2, w2)
    cols = torch.arange(w2, dtype=torch.float32, device=device)[None, :].expand(h2, w2)
    ids = torch.stack([torch.zeros_like(rows), rows, cols], dim=-1)
    return ids.reshape(1, h2 * w2, 3).expand(bs, h2 * w2, 3)


def make_txt_ids(bs: int, txt_len: int, device) -> torch.Tensor:
    return torch.zeros((bs, txt_len, 3), dtype=torch.float32, device=device)


def denoise(step_fn: Callable[[torch.Tensor, float], torch.Tensor],
            img: torch.Tensor, sigmas: np.ndarray,
            on_step: Optional[Callable[[int], None]] = None) -> torch.Tensor:
    """Euler flow-match loop: per window (t_curr, t_prev),
    img += pred(img, t_curr) * (t_prev - t_curr), with an f32 carry.
    ``sigmas`` holds num_steps+1 f32 values; ``on_step(i)`` runs after
    each step."""
    sig = np.asarray(sigmas, np.float32)
    x = img.float()
    for i in range(len(sig) - 1):
        tc, tp = sig[i], sig[i + 1]
        pred = step_fn(x, float(tc))
        x = x + pred.float() * float(tp - tc)  # f32 difference, as in JAX
        if on_step is not None:
            on_step(i)
    return x
