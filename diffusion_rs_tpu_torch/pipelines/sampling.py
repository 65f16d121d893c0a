"""FLUX latent plumbing and the Euler denoise loop (port of
``pipelines/sampling.py``).

Noise contract: the JAX package draws its noise with ``jax.random``, which
PyTorch cannot reproduce. The port draws ``torch.randn`` from a
``torch.Generator`` on the target device, seeded with the request's seed, so
one seed gives one image on one device type; tests that compare the two
packages inject the same noise array into both. The same holds for the VAE
encoder's sample of img2img and inpainting (:func:`get_encode_noise`).
"""

from __future__ import annotations

import os
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


def get_encode_noise(seed: int, shape: Tuple[int, ...], dtype: torch.dtype,
                     device) -> torch.Tensor:
    """The standard-normal draw of the VAE encoder's Gaussian sample for a
    request's init images, ``shape`` the whole batch's NHWC latent, in the
    latent's ``dtype``. It comes from a generator seeded with
    ``seed + 1``, the port's stand-in for JAX's ``fold_in(key, 1)``, so it
    differs from the seed's denoise noise."""
    gen = torch.Generator(device=device).manual_seed(int(seed) + 1)
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=device).to(dtype)


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
            on_step: Optional[Callable[[int], None]] = None,
            inpaint: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
            progress: Optional[bool] = None) -> torch.Tensor:
    """Euler flow-match loop: per window (t_curr, t_prev),
    img += pred(img, t_curr) * (t_prev - t_curr), with an f32 carry.
    ``sigmas`` holds num_steps+1 f32 values; ``on_step(i)`` runs after
    each step.

    ``inpaint``: packed f32 ``(mask, init, noise)`` ([B, S, 1 or C], [B, S,
    C], [B, S, C]). After every update the carry becomes
    ``mask * x + (1 - mask) * (tp * noise + (1 - tp) * init)``: the unmasked
    tokens follow the init latent renoised to t_prev, and equal it exactly
    after the last step (t_prev = 0). ``progress`` prints ``denoise step
    i/n (t=...)`` after each prediction; None reads DIFFUSION_RS_TPU_PROGRESS,
    as in JAX."""
    report = (progress if progress is not None
              else bool(os.environ.get("DIFFUSION_RS_TPU_PROGRESS")))
    sig = np.asarray(sigmas, np.float32)
    n = len(sig) - 1
    x = img.float()
    for i in range(n):
        tc, tp = sig[i], sig[i + 1]
        pred = step_fn(x, float(tc))
        if report:
            print(f"denoise step {i + 1}/{n} (t={float(tc):.3f})")
        x = x + pred.float() * float(tp - tc)  # f32 difference, as in JAX
        if inpaint is not None:
            mask, init, noise = inpaint
            renoised = float(tp) * noise + float(1.0 - tp) * init  # f32 1 - tp
            x = mask * x + (1.0 - mask) * renoised
        if on_step is not None:
            on_step(i)
    return x
