"""Canonical quantized-tensor representation (PyTorch port).

Same layout contract as the JAX package's ``quant/qtensor.py``, so the two
packages exchange weights without repacking:

* weights are K-major ``[K, N]`` (input features x output features);
* 4-bit carriers are nibble-packed split-block style: in each ``split``-long
  run of k, packed row ``r`` holds k-row ``r`` in its low nibble and k-row
  ``r + split/2`` in its high nibble;
* per-group scale/bias are dense f32 ``[K // group, N]`` planes;
* codebook formats (nf4/fp4) carry their 16-entry f32 table.

Stacked block weights carry leading ``[L, ...]`` dims on every data field;
``util/tree.take_layer`` takes per-layer views.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

SPLIT_MAX = 256


def choose_split(k: int) -> int:
    for s in (SPLIT_MAX, 128, 64, 32, 16, 8, 4, 2):
        if k % s == 0:
            return s
    return k


@dataclasses.dataclass(frozen=True)
class QuantizedTensor:
    """A quantized 2-D weight ``[K, N]`` in the canonical layout."""

    packed: torch.Tensor  # u8 [..., K//2, N] (4-bit) or i8 [..., K, N] (8-bit)
    scale: torch.Tensor  # f32 [..., K//group, N]
    bias: Optional[torch.Tensor]  # f32 [..., K//group, N] or None (=> 0)
    codebook: Optional[torch.Tensor]  # f32 [..., 16] for nf4/fp4, else None
    kind: str  # source format tag, e.g. "nf4", "q8t"
    bits: int  # 4 or 8
    group: int  # scale group size along K
    split: int  # nibble split-block length along K (4-bit only)
    shape: tuple  # logical (K, N)
    out_dtype: str  # dtype name the dequantized weight is produced in

    @property
    def k(self) -> int:
        return self.shape[0]

    @property
    def n(self) -> int:
        return self.shape[1]

    def map(self, fn) -> "QuantizedTensor":
        """Apply ``fn`` to every data field (indexing, device moves)."""
        return dataclasses.replace(
            self,
            packed=fn(self.packed),
            scale=fn(self.scale),
            bias=None if self.bias is None else fn(self.bias),
            codebook=None if self.codebook is None else fn(self.codebook),
        )


# ---------------------------------------------------------------------------
# Packing helpers (numpy, load time)
# ---------------------------------------------------------------------------


def pack4(q: np.ndarray, split: int) -> np.ndarray:
    """Nibble-pack uint4 values ``q [K, N]`` into ``[K//2, N]`` split-block layout."""
    k, n = q.shape
    if split % 2 != 0 or k % split != 0:
        raise ValueError(f"K={k} not divisible by even split={split}")
    q = q.reshape(k // split, split, n)
    lo = q[:, : split // 2, :]
    hi = q[:, split // 2 :, :]
    packed = (lo.astype(np.uint8) & 0xF) | ((hi.astype(np.uint8) & 0xF) << 4)
    return packed.reshape(k // 2, n)


def pack4_tensor(q: torch.Tensor, split: int) -> torch.Tensor:
    """:func:`pack4` on a tensor's own device (u8 codes 0..15 ``[K, N]``)."""
    k, n = q.shape
    if split % 2 != 0 or k % split != 0:
        raise ValueError(f"K={k} not divisible by even split={split}")
    q = q.to(torch.uint8).reshape(k // split, split, n)
    lo = q[:, : split // 2, :] & 0xF
    hi = q[:, split // 2:, :] & 0xF
    return (lo | (hi << 4)).reshape(k // 2, n)


def unpack4(packed: torch.Tensor, split: int) -> torch.Tensor:
    """Inverse of :func:`pack4` on tensors; keeps leading stack dims."""
    k2, n = packed.shape[-2:]
    lead = tuple(packed.shape[:-2])
    k = k2 * 2
    p = packed.reshape(lead + (k // split, split // 2, n))
    lo = p & 0xF
    hi = p >> 4
    return torch.cat([lo, hi], dim=-2).reshape(lead + (k, n))


# ---------------------------------------------------------------------------
# Dequantize (reference path; the kernels fuse the same math)
# ---------------------------------------------------------------------------


def dequantize(qt: QuantizedTensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Materialize the full weight ``[..., K, N]`` (f32 math, then ``dtype``)."""
    dtype = dtype or getattr(torch, qt.out_dtype)
    k, n = qt.shape
    q = unpack4(qt.packed, qt.split) if qt.bits == 4 else qt.packed
    lead = tuple(q.shape[:-2])
    if qt.codebook is not None:
        idx = q.long()
        if qt.codebook.dim() == 1:
            w = qt.codebook[idx]
        else:  # stacked codebook [L, 16]
            w = torch.gather(
                qt.codebook.reshape(lead + (1, 16)).expand(lead + (k, 16)), -1, idx
            )
    else:
        w = q.float()
    groups = k // qt.group
    w = w.reshape(lead + (groups, qt.group, n))
    w = w * qt.scale.reshape(lead + (groups, 1, n))
    if qt.bias is not None:
        w = w + qt.bias.reshape(lead + (groups, 1, n))
    return w.reshape(lead + (k, n)).to(dtype)


# ---------------------------------------------------------------------------
# Quantizer (numpy; tests and random-weight benches)
# ---------------------------------------------------------------------------


def quantize_q8_tile(w: np.ndarray, tile: int = SPLIT_MAX) -> QuantizedTensor:
    """"q8t": symmetric int8 with ONE scale per (K-tile, column); the scale
    group equals the kernel's K-tile, so the product runs s8 x s8 -> s32 with
    one rescale per tile (ops/qmatmul.py)."""
    k, n = w.shape
    g = min(tile, k)
    if k % g:
        raise ValueError(f"K={k} not divisible by tile={g}")
    wf = w.astype(np.float32).reshape(k // g, g, n)
    amax = np.abs(wf).max(axis=1, keepdims=True)
    d = amax / 127.0
    inv_d = np.where(d != 0.0, 1.0 / np.where(d == 0.0, 1.0, d), 0.0)
    q = np.clip(np.round(wf * inv_d), -127, 127).astype(np.int8)
    return QuantizedTensor(
        packed=torch.from_numpy(q.reshape(k, n)),
        scale=torch.from_numpy(d.reshape(k // g, n).astype(np.float32)),
        bias=None,
        codebook=None,
        kind="q8t",
        bits=8,
        group=g,
        split=choose_split(k),
        shape=(k, n),
        out_dtype="bfloat16",
    )


def quantize_q8_tile_tensor(w: torch.Tensor, tile: int = SPLIT_MAX) -> QuantizedTensor:
    """:func:`quantize_q8_tile` on the weight's own device, with the same f32
    operations (IEEE quotients: divided by tensors, not by Python scalars)."""
    k, n = w.shape
    g = min(tile, k)
    if k % g:
        raise ValueError(f"K={k} not divisible by tile={g}")
    wf = w.float().reshape(k // g, g, n)
    amax = wf.abs().amax(dim=1, keepdim=True)
    d = amax / torch.full_like(amax, 127.0)
    one = torch.ones_like(d)
    inv_d = torch.where(d != 0.0, one / torch.where(d == 0.0, one, d), torch.zeros_like(d))
    q = torch.clamp(torch.round(wf * inv_d), -127, 127).to(torch.int8)
    return QuantizedTensor(
        packed=q.reshape(k, n),
        scale=d.reshape(k // g, n),
        bias=None,
        codebook=None,
        kind="q8t",
        bits=8,
        group=g,
        split=choose_split(k),
        shape=(k, n),
        out_dtype="bfloat16",
    )


def quantize_q4_0(w: np.ndarray) -> QuantizedTensor:
    """GGUF Q4_0-equivalent: 32-wide groups, symmetric 4-bit, unsigned codes
    ``floor(w / d + 8.5)`` with ``d = signed absmax / -8``; the ``-8 d``
    offset is the bias plane."""
    k, n = w.shape
    g = 32
    wf = w.astype(np.float32).reshape(k // g, g, n)
    absmax_idx = np.abs(wf).argmax(axis=1, keepdims=True)
    maxval = np.take_along_axis(wf, absmax_idx, axis=1)  # signed value at absmax
    d = maxval / -8.0
    inv_d = np.where(d != 0.0, 1.0 / np.where(d == 0.0, 1.0, d), 0.0)
    q = np.clip(np.floor(wf * inv_d + 8.5), 0, 15).astype(np.uint8).reshape(k, n)
    split = choose_split(k)
    return QuantizedTensor(
        packed=torch.from_numpy(pack4(q, split)),
        scale=torch.from_numpy(d.reshape(k // g, n).astype(np.float32)),
        bias=torch.from_numpy((d.reshape(k // g, n) * -8.0).astype(np.float32)),
        codebook=None,
        kind="q4_0",
        bits=4,
        group=g,
        split=split,
        shape=(k, n),
        out_dtype="bfloat16",
    )


def quantize_q8_0(w: np.ndarray) -> QuantizedTensor:
    """GGUF Q8_0-equivalent: 32-wide groups, symmetric int8."""
    k, n = w.shape
    g = 32
    wf = w.astype(np.float32).reshape(k // g, g, n)
    amax = np.abs(wf).max(axis=1, keepdims=True)
    d = amax / 127.0
    inv_d = np.where(d != 0.0, 1.0 / np.where(d == 0.0, 1.0, d), 0.0)
    q = np.clip(np.round(wf * inv_d), -128, 127).astype(np.int8)
    return QuantizedTensor(
        packed=torch.from_numpy(q.reshape(k, n)),
        scale=torch.from_numpy(d.reshape(k // g, n).astype(np.float32)),
        bias=None,
        codebook=None,
        kind="q8_0",
        bits=8,
        group=g,
        split=choose_split(k),
        shape=(k, n),
        out_dtype="bfloat16",
    )


# ---------------------------------------------------------------------------
# Column (N) slicing and concatenation: exact, every plane is per column
# ---------------------------------------------------------------------------


def slice_n(qt: QuantizedTensor, start: int, end: int) -> QuantizedTensor:
    """Columns ``start:end`` of the OUT-feature axis (inverse of
    :func:`concat_n`); used to swap the BFL final-AdaLN halves."""
    return dataclasses.replace(
        qt,
        packed=qt.packed[..., start:end],
        scale=qt.scale[..., start:end],
        bias=None if qt.bias is None else qt.bias[..., start:end],
        shape=tuple(qt.shape[:-1]) + (end - start,),
    )


def permute_n(qt: QuantizedTensor, idx) -> QuantizedTensor:
    """Reorder the OUT-feature (N) columns by ``idx`` (``out[..., j] =
    old[..., idx[j]]``); exact like :func:`slice_n`. Stacked ``[L, K, N]``
    planes are permuted layer by layer alike. Used by the RoPE half-split
    re-layout (models/optimize.py)."""
    idx = torch.as_tensor(np.asarray(idx), dtype=torch.long, device=qt.packed.device)
    return dataclasses.replace(
        qt,
        packed=qt.packed[..., idx],
        scale=qt.scale[..., idx],
        bias=None if qt.bias is None else qt.bias[..., idx],
    )


def concat_n(tensors) -> QuantizedTensor:
    """Concatenate canonical tensors along the OUT-feature (N) axis; all
    quantization meta must agree."""
    first = tensors[0]
    for t in tensors[1:]:
        if (t.kind, t.bits, t.group, t.split, t.k, t.out_dtype) != (
                first.kind, first.bits, first.group, first.split, first.k,
                first.out_dtype):
            raise ValueError("concat_n requires identical quantization meta")
    return dataclasses.replace(
        first,
        packed=torch.cat([t.packed for t in tensors], dim=-1),
        scale=torch.cat([t.scale for t in tensors], dim=-1),
        bias=(torch.cat([t.bias for t in tensors], dim=-1)
              if first.bias is not None else None),
        shape=(first.k, sum(t.n for t in tensors)),
    )
