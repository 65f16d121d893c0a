"""bitsandbytes nf4 / fp4 / int8 checkpoints -> the canonical layout (the
port's own copy of ``diffusion_rs_tpu/quant/bnb.py``; load-time numpy).

* 4-bit: byte ``i`` holds element ``2i`` in the HIGH nibble and ``2i+1`` in
  the LOW nibble; element ``e`` uses ``absmax[e // blocksize]``; the absmax
  may itself be "nested" (double) quantized: u8 codes into a 256-entry
  codebook with its own blockwise absmax, plus a global offset. The codes
  index a 16-entry codebook (NF4 or FP4) and run through the nf4 kernel.
* int8: ``w[row, col] = q[row, col] * SCB[row] / 127``, a whole-column
  (group = K) scale in the K-major layout, through the affine kernel.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .qtensor import QuantizedTensor, choose_split, pack4, pack4_tensor

# 16-entry codebooks, indexed by the 4-bit code (bitsandbytes' NF4 normal
# map, and FP4 e2m1 with bit 3 the sign).
NF4_CODEBOOK = np.array(
    [
        -1.0,
        -0.6961928009986877,
        -0.5250730514526367,
        -0.39491748809814453,
        -0.28444138169288635,
        -0.18477343022823334,
        -0.09105003625154495,
        0.0,
        0.07958029955625534,
        0.16093020141124725,
        0.24611230194568634,
        0.33791524171829224,
        0.44070982933044434,
        0.5626170039176941,
        0.7229568362236023,
        1.0,
    ],
    dtype=np.float32,
)

_FP4_MAG = np.array(
    [0.0, 0.0052083333, 0.6666667, 1.0, 0.33333334, 0.5, 0.16666667, 0.25],
    dtype=np.float32,
)
FP4_CODEBOOK = np.concatenate([_FP4_MAG, -_FP4_MAG]).astype(np.float32)

CODEBOOKS = {"nf4": NF4_CODEBOOK, "fp4": FP4_CODEBOOK}


def unpack_bnb_nibbles(data: np.ndarray, n: int) -> np.ndarray:
    """u8 bytes -> flat u4 codes, element 2i = high nibble."""
    data = data.reshape(-1)
    out = np.empty(data.size * 2, dtype=np.uint8)
    out[0::2] = data >> 4
    out[1::2] = data & 0xF
    return out[:n]


def dequantize_blockwise_8bit(codes: np.ndarray, code: np.ndarray,
                              absmax: np.ndarray, blocksize: int) -> np.ndarray:
    """General 8-bit blockwise dequant: ``code[q[i]] * absmax[i // blocksize]``
    (the nested absmax of a double-quantized 4-bit tensor)."""
    codes = codes.reshape(-1)
    vals = code.astype(np.float32)[codes]
    idx = np.arange(codes.size) // blocksize
    return vals * absmax.astype(np.float32)[idx]


def resolve_absmax(absmax: np.ndarray, nested_absmax: Optional[np.ndarray] = None,
                   nested_code: Optional[np.ndarray] = None,
                   nested_blocksize: Optional[int] = None,
                   offset: Optional[float] = None) -> np.ndarray:
    """A possibly double-quantized absmax as plain f32:
    ``dequant_8bit(absmax) + offset``."""
    if nested_absmax is None:
        return absmax.astype(np.float32)
    out = dequantize_blockwise_8bit(absmax.astype(np.uint8), nested_code,
                                    nested_absmax, nested_blocksize)
    return out + np.float32(offset)


def bnb4bit_to_canonical(weight_bytes: np.ndarray, absmax: np.ndarray, shape: tuple,
                         blocksize: int, kind: str,
                         out_dtype: str = "bfloat16") -> QuantizedTensor:
    """Repack a bnb 4-bit tensor (torch layout ``[out, in]``, row-major) into
    the canonical K-major split-block layout. ``absmax`` must already be
    resolved (:func:`resolve_absmax`). The repack and the scale transpose
    run in the native library (io/native.py) where it is available, else in
    numpy, as in JAX."""
    from ..io.native import bnb_repack4, transpose_2d

    n_out, k_in = shape
    if k_in % blocksize != 0:
        raise ValueError(f"in_features {k_in} not divisible by blocksize {blocksize}")
    scale = absmax.astype(np.float32).reshape(n_out, k_in // blocksize)
    split = choose_split(k_in)
    packed = bnb_repack4(weight_bytes, n_out, k_in, split)
    if packed is None:
        q = unpack_bnb_nibbles(weight_bytes, n_out * k_in).reshape(n_out, k_in)
        packed = pack4(np.ascontiguousarray(q.T), split)
    return QuantizedTensor(
        packed=torch.from_numpy(packed),
        scale=torch.from_numpy(transpose_2d(scale)),
        bias=None,
        codebook=torch.from_numpy(CODEBOOKS[kind].copy()),
        kind=kind,
        bits=4,
        group=blocksize,
        split=split,
        shape=(k_in, n_out),
        out_dtype=out_dtype,
    )


def quantize_4bit_bnb_layout(w: np.ndarray, blocksize: int = 64,
                             kind: str = "nf4") -> tuple[np.ndarray, np.ndarray]:
    """Quantize a torch-layout ``[out, in]`` weight into bnb's byte layout:
    (packed bytes, absmax). Each code is the nearest codebook entry of
    ``w / absmax`` (the first on a tie), as bitsandbytes' quantize_4bit."""
    cb = CODEBOOKS[kind]
    flat = w.astype(np.float32).reshape(-1)
    pad = (-flat.size) % blocksize
    if pad:
        flat = np.concatenate([flat, np.zeros(pad, np.float32)])
    blocks = flat.reshape(-1, blocksize)
    absmax = np.abs(blocks).max(axis=1)
    safe = np.where(absmax == 0, 1.0, absmax)
    normed = blocks / safe[:, None]
    codes = np.abs(normed[..., None] - cb[None, None, :]).argmin(axis=-1)
    codes = codes.reshape(-1).astype(np.uint8)[: w.size]
    if codes.size % 2:
        codes = np.concatenate([codes, np.zeros(1, np.uint8)])
    packed = (codes[0::2] << 4) | codes[1::2]
    return packed, absmax[: (w.size + blocksize - 1) // blocksize]


def quantize_nf4(w: np.ndarray, blocksize: int = 64) -> QuantizedTensor:
    """A torch-layout ``[out, in]`` weight -> canonical nf4 (host numpy)."""
    packed, absmax = quantize_4bit_bnb_layout(w, blocksize, "nf4")
    return bnb4bit_to_canonical(packed, absmax, w.shape, blocksize, "nf4")


def quantize_fp4(w: np.ndarray, blocksize: int = 64) -> QuantizedTensor:
    """A torch-layout ``[out, in]`` weight -> canonical fp4 (host numpy)."""
    packed, absmax = quantize_4bit_bnb_layout(w, blocksize, "fp4")
    return bnb4bit_to_canonical(packed, absmax, w.shape, blocksize, "fp4")


def quantize_4bit_canonical(w_kmajor: torch.Tensor, kind: str = "nf4",
                            blocksize: int = 64) -> QuantizedTensor:
    """:func:`quantize_nf4` / :func:`quantize_fp4` of ``w_kmajor.T`` on the
    weight's own device, straight to the canonical planes: the same blocks
    (``blocksize`` along K per column), the same f32 operations and the
    first-minimum tie rule, so the codes and scales equal the host
    encoder's."""
    k, n = w_kmajor.shape
    if k % blocksize:
        raise ValueError(f"in_features {k} not divisible by blocksize {blocksize}")
    dev = w_kmajor.device
    blocks = w_kmajor.float().reshape(k // blocksize, blocksize, n)
    absmax = blocks.abs().amax(dim=1)
    safe = torch.where(absmax == 0, torch.ones_like(absmax), absmax)
    normed = blocks / safe[:, None, :]
    cb = torch.as_tensor(CODEBOOKS[kind], device=dev)
    best = (normed - cb[0]).abs()
    codes = torch.zeros(normed.shape, dtype=torch.uint8, device=dev)
    for i in range(1, 16):  # strict '<' keeps the first minimum, as argmin
        d = (normed - cb[i]).abs()
        closer = d < best
        best = torch.where(closer, d, best)
        codes.masked_fill_(closer, i)
        del d, closer
    split = choose_split(k)
    return QuantizedTensor(
        packed=pack4_tensor(codes.reshape(k, n), split),
        scale=absmax,
        bias=None,
        codebook=cb.clone(),
        kind=kind,
        bits=4,
        group=blocksize,
        split=split,
        shape=(k, n),
        out_dtype="bfloat16",
    )


def bnb_int8_to_canonical(weight_i8: np.ndarray, scb: np.ndarray,
                          out_dtype: str = "bfloat16") -> QuantizedTensor:
    """bnb int8: ``w = q * SCB[row] / 127``. The per-output-row scale becomes a
    whole-column (group == K) scale in the K-major layout."""
    n_out, k_in = weight_i8.shape
    scale = (scb.astype(np.float32) / 127.0).reshape(1, n_out)
    return QuantizedTensor(
        packed=torch.from_numpy(np.ascontiguousarray(weight_i8.T)),
        scale=torch.from_numpy(np.ascontiguousarray(scale)),
        bias=None,
        codebook=None,
        kind="int8",
        bits=8,
        group=k_in,
        split=choose_split(k_in),
        shape=(k_in, n_out),
        out_dtype=out_dtype,
    )
