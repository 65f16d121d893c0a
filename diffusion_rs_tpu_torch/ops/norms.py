"""Normalization ops with the f32 contract of ``ops/norms.py``: statistics
in f32 whatever the activation dtype, the result cast back before the affine
weights are applied."""

from __future__ import annotations

from typing import Optional

import torch


def layer_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last axis; ``weight=None`` is the parameter-free
    form FLUX blocks use."""
    dt = x.dtype
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = ((xf - mean) * (1.0 / torch.sqrt(var + eps))).to(dt)
    if weight is not None:
        y = y * weight
    if bias is not None:
        y = y + bias
    return y


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm (T5LayerNorm, FLUX QK-norm)."""
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * (1.0 / torch.sqrt(var + eps))).to(dt) * weight


def group_norm(x_nhwc: torch.Tensor, num_groups: int, weight: torch.Tensor,
               bias: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """GroupNorm over NHWC; statistics over (H, W, C/G) in f32."""
    b, h, w, c = x_nhwc.shape
    g = num_groups
    dt = x_nhwc.dtype
    xf = x_nhwc.float().reshape(b, h * w, g, c // g)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = (xf - mean).square().mean(dim=(1, 3), keepdim=True)
    y = ((xf - mean) * (1.0 / torch.sqrt(var + eps))).reshape(b, h, w, c).to(dt)
    return y * weight + bias
