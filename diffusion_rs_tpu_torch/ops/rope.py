"""FLUX multi-axis rotary position embedding (port of ``ops/rope.py``):
per-axis (cos, sin) tables concatenated along the frequency axis, applied to
interleaved pairs of the head dim, all in f32."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def rope_tables(ids: torch.Tensor, axes_dim: Sequence[int],
                theta: int = 10000) -> Tuple[torch.Tensor, torch.Tensor]:
    """ids [B, n, n_axes] -> cos, sin [B, n, sum(axes_dim)/2] float32."""
    ids = ids.float()
    coss, sins = [], []
    for ax, dim in enumerate(axes_dim):
        half = dim // 2
        exponent = torch.arange(half, dtype=torch.float32, device=ids.device) * (2.0 / dim)
        inv_freq = torch.pow(torch.tensor(float(theta), dtype=torch.float32,
                                          device=ids.device), -exponent)
        freqs = ids[..., ax:ax + 1] * inv_freq
        coss.append(torch.cos(freqs))
        sins.append(torch.sin(freqs))
    return torch.cat(coss, dim=-1), torch.cat(sins, dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [B, H, S, D]; cos/sin [B, S, D/2], broadcast over heads.
    out_2i = cos*x_2i - sin*x_2i+1; out_2i+1 = sin*x_2i + cos*x_2i+1."""
    b, h, s, d = x.shape
    xf = x.float().reshape(b, h, s, d // 2, 2)
    x0, x1 = xf[..., 0], xf[..., 1]
    c = cos[:, None]
    sn = sin[:, None]
    out = torch.stack([c * x0 - sn * x1, sn * x0 + c * x1], dim=-1)
    return out.reshape(b, h, s, d).to(x.dtype)
