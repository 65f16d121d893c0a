"""Linear layer over dense or quantized weights (port of ``ops/linear.py``).

The weight's type selects the path: a dense tensor runs a plain matmul with
f32 accumulation; a :class:`QuantizedTensor` runs the fused quantized matmul
(ops/qmatmul.py), or dequantize + matmul where the kernels do not tile it.
:func:`linear_grouped` runs several linears of one weight format as one
grouped launch (FLUX double blocks with ``fuse="grouped"``).

Under tensor parallelism (parallel/sharding.py) a ``Linear`` carries its
:class:`TensorParallel` cut. A column-parallel one holds this rank's output
columns and runs as any other. A row-parallel one that holds this rank's
input rows runs ops/partitioned.row_parallel_linear: the partial product in
f32, one all-reduce over the tp group, one cast, then the bias.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import torch

from ..quant.qtensor import QuantizedTensor, dequantize
from .qmatmul import dense_matmul, quantized_matmul, quantized_matmul_grouped, supports


def cut_segments(t: torch.Tensor, dim: int, segments: Sequence[int], rank: int, size: int,
                 div: int = 1) -> torch.Tensor:
    """Rank ``rank``'s share (of ``size`` even shares) of every segment of
    ``t`` along ``dim``, in segment order, as a contiguous tensor; a
    segment of n features is n / ``div`` entries of ``t`` (packed 4-bit
    codes: 2; a scale plane: the group)."""
    parts, start = [], 0
    for n in segments:
        m = n // div
        step = m // size
        parts.append(t.narrow(dim, start + rank * step, step))
        start += m
    out = parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim)
    return out.contiguous()


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """How a ``Linear`` is cut over the ``size`` ranks of a tp ``group``
    (this one is ``rank``). ``role`` "col" cuts the output features N,
    "row" the input features K; ``segments`` are the lengths of the cut
    dimension's parts in the whole weight (q | k | v of a fused projection,
    attn | mlp of ``linear2``; one part otherwise), each cut evenly, so that
    a rank holds its share of every part, in order. ``sharded`` False: a
    row-parallel weight kept whole (its quantization groups do not split),
    which then takes the whole input."""

    role: str
    group: object
    size: int
    rank: int
    segments: Tuple[int, ...]
    sharded: bool = True

    def local_features(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's share of every segment of ``x``'s last dim (whole)."""
        return cut_segments(x, -1, self.segments, self.rank, self.size)

    def gather_features(self, x: torch.Tensor) -> torch.Tensor:
        """The whole last dim from every rank's :meth:`local_features`."""
        from ..parallel.mesh import all_gather_rows

        local = [n // self.size for n in self.segments]
        full = all_gather_rows(x, self.group, [sum(local)] * self.size, dim=-1)
        ranks = torch.split(full, sum(local), dim=-1)
        segs = [torch.split(r, local, dim=-1) for r in ranks]
        return torch.cat([segs[r][i] for i in range(len(local)) for r in range(self.size)],
                         dim=-1)


@dataclasses.dataclass
class Linear:
    """Weight ``[K, N]`` (K-major) + optional bias + optional runtime LoRA
    ``(a [.., K, r], bl [.., r, N])`` applied as ``y += (x @ a) @ bl``;
    ``tp``: its tensor-parallel cut (None: whole)."""

    w: Union[torch.Tensor, QuantizedTensor]
    b: Optional[torch.Tensor] = None
    lora: Optional[tuple] = None
    tp: Optional[TensorParallel] = None


def tp_size(lin: Linear) -> int:
    """The tp group size ``lin`` is cut over (1: whole)."""
    return 1 if lin.tp is None else lin.tp.size


def linear(x: torch.Tensor, lin: Linear) -> torch.Tensor:
    """``y = x @ w + b``; x: [..., K]. The bias is added in the activation
    dtype after the product's output cast, as in JAX.

    A row-parallel ``lin`` takes either this rank's input features or the
    whole input, told apart by their count (the two differ whenever tp > 1):
    a sharded weight cuts a whole input to its rows, and a weight kept whole
    gathers a rank's features from the group, in segment order."""
    tp = lin.tp
    if tp is not None and tp.role == "row" and tp.size > 1:
        k = lin.w.shape[-2]
        if tp.sharded:
            from .partitioned import row_parallel_linear

            if x.shape[-1] != k:
                x = tp.local_features(x)
            return row_parallel_linear(x, lin)
        if x.shape[-1] != k:
            x = tp.gather_features(x)
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
