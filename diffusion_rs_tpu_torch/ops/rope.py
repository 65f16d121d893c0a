"""FLUX multi-axis rotary position embedding (port of ``ops/rope.py``):
per-axis (cos, sin) tables concatenated along the frequency axis, applied to
interleaved pairs of the head dim, all in f32; and the half-split form
(pairs ``(i, i + D/2)``) that runs on q/k projections re-laid by
``models/optimize.rope_halfsplit_permute``, with the expanded tables the
fused-RoPE flash kernel reads."""

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


def apply_rope_halfsplit(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                         seq_axis: int = 2) -> torch.Tensor:
    """Rotate half-split pairs ``(i, i + D/2)`` of the last dim:
    ``[c*x1 - s*x2, s*x1 + c*x2]`` in f32, each product and sum rounded on
    its own, cast back to x.dtype. x: [B, H, S, D] (``seq_axis=2``) or
    [B, S, H, D] (``seq_axis=1``); cos/sin: [B, S, D/2]."""
    d = x.shape[-1]
    xf = x.float()
    x1, x2 = xf[..., : d // 2], xf[..., d // 2:]
    if seq_axis == 2:
        c, sn = cos[:, None], sin[:, None]
    else:
        c, sn = cos[:, :, None], sin[:, :, None]
    return torch.cat([c * x1 - sn * x2, sn * x1 + c * x2], dim=-1).to(x.dtype)


def expand_rope_tables(cos: torch.Tensor, sin: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) [B, S, D/2] -> f32 (ce, se) [B, S, D] with ce = [cos | cos]
    and se = [-sin | sin], so that the rotation is ``ce*x + se*halfroll(x)``."""
    ce = torch.cat([cos, cos], dim=-1).float()
    se = torch.cat([-sin, sin], dim=-1).float()
    return ce, se
