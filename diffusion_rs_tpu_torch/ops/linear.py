"""Linear layer over dense or quantized weights (port of ``ops/linear.py``).

The weight's type selects the path: a dense tensor runs a plain matmul with
f32 accumulation; a :class:`QuantizedTensor` runs the fused quantized matmul
(ops/qmatmul.py), or dequantize + matmul where the kernels do not tile it.
:func:`linear_grouped` runs several linears of one weight format as one
grouped launch (FLUX double blocks with ``fuse="grouped"``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from ..quant.qtensor import QuantizedTensor, dequantize
from .qmatmul import dense_matmul, quantized_matmul, quantized_matmul_grouped, supports


@dataclasses.dataclass
class Linear:
    """Weight ``[K, N]`` (K-major) + optional bias + optional runtime LoRA
    ``(a [.., K, r], bl [.., r, N])`` applied as ``y += (x @ a) @ bl``."""

    w: Union[torch.Tensor, QuantizedTensor]
    b: Optional[torch.Tensor] = None
    lora: Optional[tuple] = None


def linear(x: torch.Tensor, lin: Linear) -> torch.Tensor:
    """``y = x @ w + b``; x: [..., K]. The bias is added in the activation
    dtype after the product's output cast, as in JAX."""
    w = lin.w
    if isinstance(w, QuantizedTensor):
        if supports(w):
            y = quantized_matmul(x, w)
        else:
            y = dense_matmul(x, dequantize(w, x.dtype))
    else:
        y = dense_matmul(x, w)
    if lin.lora is not None:
        a, bl = lin.lora
        y = y + dense_matmul(torch.matmul(x, a.to(x.dtype)), bl.to(x.dtype))
    if lin.b is not None:
        y = y + lin.b
    return y


def linear_grouped(xs, lins):
    """``[linear(x_g, lin_g) for g]`` with the products as one grouped call
    when every weight is a :class:`QuantizedTensor` and no group carries
    LoRA terms (ops/qmatmul.quantized_matmul_grouped, which itself runs per
    group on a format mismatch); otherwise per-group :func:`linear`. The
    bias is added after the grouped product, as in :func:`linear`."""
    ws = [l.w for l in lins]
    if (not all(isinstance(w, QuantizedTensor) for w in ws)
            or any(l.lora is not None for l in lins)):
        return [linear(x, l) for x, l in zip(xs, lins)]
    ys = quantized_matmul_grouped(xs, ws)
    return [y if l.b is None else y + l.b for y, l in zip(ys, lins)]
