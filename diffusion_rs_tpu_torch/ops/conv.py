"""Convolution helpers for the VAE, port of ``ops/conv.py``. Activations are
NHWC and filters HWIO, as in the JAX package; the convolution itself is
PyTorch's (the JAX package leaves it to XLA)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F


@dataclass
class Conv:
    """Filter HWIO + optional bias."""

    w: torch.Tensor
    b: Optional[torch.Tensor] = None


def conv2d(x: torch.Tensor, conv: Conv, stride: int = 1,
           padding: Tuple[Tuple[int, int], Tuple[int, int]] = ((0, 0), (0, 0))
           ) -> torch.Tensor:
    """NHWC conv; ``padding`` is ((top, bottom), (left, right)). The bias is
    added in the activation dtype after the output cast, as in JAX."""
    (pt, pb), (pl, pr) = padding
    xc = x.permute(0, 3, 1, 2)
    if pt == pb and pl == pr:
        pad = (pt, pl)
    else:
        xc = F.pad(xc, (pl, pr, pt, pb))
        pad = (0, 0)
    # NHWC viewed as NCHW has channels_last strides; keep the filter in the
    # same memory format so the convolution runs channels-last throughout.
    w = conv.w.to(x.dtype).permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)  # HWIO -> OIHW
    y = F.conv2d(xc, w, stride=stride, padding=pad).permute(0, 2, 3, 1)
    if conv.b is not None:
        y = y + conv.b.to(x.dtype)
    return y


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """NHWC nearest-neighbour 2x."""
    b, h, w, c = x.shape
    x = x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c)
    return x.reshape(b, h * 2, w * 2, c)
