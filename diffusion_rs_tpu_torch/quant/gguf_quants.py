"""GGUF/GGML quantized block formats -> the canonical layout (the port's own
copy of ``diffusion_rs_tpu/quant/gguf_quants.py``; pure numpy).

Every GGML format is decoded at load time into integer codes plus dense
per-group scale/bias planes, packed into the layout of
:class:`~diffusion_rs_tpu_torch.quant.qtensor.QuantizedTensor`:

=========  ======  =====  ==========================================
format     carrier group  value
=========  ======  =====  ==========================================
Q4_0       4-bit   32     q*d - 8d
Q4_1       4-bit   32     q*d + m
Q5_0       int8    32     (q-16)*d
Q5_1       int8    32     q*d + m
Q8_0       int8    32     q*d
Q2K        4-bit   16     q*(d*sc) - dmin*m
Q3K        4-bit   16     (q-4)*(d*(sc-32))
Q4K        4-bit   32     q*(d*sc) - dmin*m
Q5K        int8    32     q*(d*sc) - dmin*m
Q6K        int8    16     (q-32)*(d*sc)
Q8K        int8    256    q*d
=========  ======  =====  ==========================================

5/6-bit formats widen to an int8 carrier. All offsets (the ``-8d`` of Q4_0,
the ``-4``/``-32`` recentering of Q3K/Q6K) fold into the affine (scale, bias)
planes, so the runtime math is always ``w = q * scale + bias`` (the affine
kernel, ops/qmatmul.py). The decoders and the encoders match the JAX
package's byte for byte.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .qtensor import QuantizedTensor, choose_split, pack4, pack4_tensor

QK_K = 256
K_SCALE_SIZE = 12


@dataclass(frozen=True)
class GgmlFormat:
    name: str
    block_elems: int
    block_bytes: int


# sizes asserted in the reference (k_quants.rs:56-167)
GGML_FORMATS = {
    "q4_0": GgmlFormat("q4_0", 32, 18),
    "q4_1": GgmlFormat("q4_1", 32, 20),
    "q5_0": GgmlFormat("q5_0", 32, 22),
    "q5_1": GgmlFormat("q5_1", 32, 24),
    "q8_0": GgmlFormat("q8_0", 32, 34),
    "q8_1": GgmlFormat("q8_1", 32, 36),
    "q2_k": GgmlFormat("q2_k", QK_K, QK_K // 16 + QK_K // 4 + 4),  # 84
    "q3_k": GgmlFormat("q3_k", QK_K, QK_K // 8 + QK_K // 4 + 12 + 2),  # 110
    "q4_k": GgmlFormat("q4_k", QK_K, QK_K // 2 + K_SCALE_SIZE + 4),  # 144
    "q5_k": GgmlFormat("q5_k", QK_K, QK_K // 8 + QK_K // 2 + 4 + K_SCALE_SIZE),  # 176
    "q6_k": GgmlFormat("q6_k", QK_K, 3 * QK_K // 4 + QK_K // 16 + 2),  # 210
    "q8_k": GgmlFormat("q8_k", QK_K, 4 + QK_K + QK_K // 16 * 2),  # 292
}


def _f16(u8pair: np.ndarray) -> np.ndarray:
    return u8pair.view(np.float16).astype(np.float32)


# ---------------------------------------------------------------------------
# Per-format decoders: bytes [nb, block_bytes] -> (codes, scale, bias, meta)
# codes: int  [nb, block_elems]   (carrier values, unsigned for 4-bit)
# scale: f32  [nb, block_elems // group]
# bias:  f32  [nb, block_elems // group] or None
# meta:  (bits, group)
# ---------------------------------------------------------------------------


def _decode_q4_0(b: np.ndarray):
    d = _f16(b[:, 0:2])[:, 0]  # [nb]
    qs = b[:, 2:18]
    codes = np.concatenate([qs & 0xF, qs >> 4], axis=1)  # elem j / j+16
    return codes, d[:, None], (-8.0 * d)[:, None], (4, 32)


def _decode_q4_1(b: np.ndarray):
    d = _f16(b[:, 0:2])[:, 0]
    m = _f16(b[:, 2:4])[:, 0]
    qs = b[:, 4:20]
    codes = np.concatenate([qs & 0xF, qs >> 4], axis=1)
    return codes, d[:, None], m[:, None], (4, 32)


def _decode_q5_0(b: np.ndarray):
    d = _f16(b[:, 0:2])[:, 0]
    qh = b[:, 2:6].copy().view(np.uint32)[:, 0]  # [nb]
    qs = b[:, 6:22]
    j = np.arange(16)
    xh0 = ((qh[:, None] >> j) << 4) & 0x10
    xh1 = (qh[:, None] >> (j + 12)) & 0x10
    lo = (qs & 0xF) | xh0.astype(np.uint8)
    hi = (qs >> 4) | xh1.astype(np.uint8)
    codes = np.concatenate([lo, hi], axis=1).astype(np.int16) - 16
    return codes, d[:, None], None, (8, 32)


def _decode_q5_1(b: np.ndarray):
    d = _f16(b[:, 0:2])[:, 0]
    m = _f16(b[:, 2:4])[:, 0]
    qh = b[:, 4:8].copy().view(np.uint32)[:, 0]
    qs = b[:, 8:24]
    j = np.arange(16)
    xh0 = ((qh[:, None] >> j) << 4) & 0x10
    xh1 = (qh[:, None] >> (j + 12)) & 0x10
    lo = (qs & 0xF) | xh0.astype(np.uint8)
    hi = (qs >> 4) | xh1.astype(np.uint8)
    codes = np.concatenate([lo, hi], axis=1).astype(np.int16)
    return codes, d[:, None], m[:, None], (8, 32)


def _decode_q8_0(b: np.ndarray):
    d = _f16(b[:, 0:2])[:, 0]
    codes = b[:, 2:34].view(np.int8).astype(np.int16)
    return codes, d[:, None], None, (8, 32)


def _decode_q8_1(b: np.ndarray):
    d = _f16(b[:, 0:2])[:, 0]
    codes = b[:, 4:36].view(np.int8).astype(np.int16)
    return codes, d[:, None], None, (8, 32)


def _decode_q2_k(b: np.ndarray):
    scales = b[:, 0:16]  # u8: lo nibble=scale idx, hi=min idx
    qs = b[:, 16:80]
    d = _f16(b[:, 80:82])[:, 0]
    dmin = _f16(b[:, 82:84])[:, 0]
    e = np.arange(QK_K)
    half, r = e // 128, e % 128
    shift_i, pos = r // 32, r % 32
    byte_idx = 32 * half + pos
    codes = (qs[:, byte_idx] >> (2 * shift_i)[None, :]) & 3
    sc = scales.astype(np.float32)
    scale = d[:, None] * (scales & 0xF)  # [nb, 16] in `is` order == e//16 order
    bias = -(dmin[:, None] * (scales >> 4).astype(np.float32))
    del sc
    return codes, scale.astype(np.float32), bias.astype(np.float32), (4, 16)


def _unpack_q3k_scales(scales: np.ndarray) -> np.ndarray:
    """12 bytes -> 16 signed 6-bit scales (k_quants.rs:1281-1295)."""
    aux = scales.copy().view(np.uint32)  # [nb, 3]
    KMASK1, KMASK2 = 0x03030303, 0x0F0F0F0F
    tmp = aux[:, 2].copy()
    out = np.empty((scales.shape[0], 4), dtype=np.uint32)
    out[:, 2] = ((aux[:, 0] >> 4) & KMASK2) | (((tmp >> 4) & KMASK1) << 4)
    out[:, 3] = ((aux[:, 1] >> 4) & KMASK2) | (((tmp >> 6) & KMASK1) << 4)
    out[:, 0] = (aux[:, 0] & KMASK2) | ((tmp & KMASK1) << 4)
    out[:, 1] = (aux[:, 1] & KMASK2) | (((tmp >> 2) & KMASK1) << 4)
    return out.view(np.int8).astype(np.float32)  # [nb, 16]


def _decode_q3_k(b: np.ndarray):
    hmask = b[:, 0:32]
    qs = b[:, 32:96]
    scales = b[:, 96:108]
    d = _f16(b[:, 108:110])[:, 0]
    sc16 = _unpack_q3k_scales(scales)  # [nb, 16] (is order == e//16 order)
    e = np.arange(QK_K)
    half, r = e // 128, e % 128
    shift_i, pos = r // 32, r % 32
    low2 = (qs[:, 32 * half + pos] >> (2 * shift_i)[None, :]) & 3
    mbit = (half * 4 + shift_i).astype(np.uint8)
    hi = (hmask[:, pos] >> mbit[None, :]) & 1  # 1 => no -4 offset
    codes = low2 + 4 * hi  # q in [0,7]; value = scale*(q-4)
    scale = d[:, None] * (sc16 - 32.0)
    bias = -4.0 * scale
    return codes, scale.astype(np.float32), bias.astype(np.float32), (4, 16)


def _k4_scale_min(scales: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """get_scale_min_k4 for is=0..7, vectorized (utils.rs:49-60)."""
    q = scales.astype(np.uint8)
    sc = np.empty((q.shape[0], 8), np.float32)
    mn = np.empty((q.shape[0], 8), np.float32)
    for j in range(4):
        sc[:, j] = (q[:, j] & 63).astype(np.float32)
        mn[:, j] = (q[:, j + 4] & 63).astype(np.float32)
    for j in range(4, 8):
        sc[:, j] = ((q[:, j + 4] & 0xF) | ((q[:, j - 4] >> 6) << 4)).astype(np.float32)
        mn[:, j] = ((q[:, j + 4] >> 4) | ((q[:, j] >> 6) << 4)).astype(np.float32)
    return sc, mn


def _decode_q4_k(b: np.ndarray):
    d = _f16(b[:, 0:2])[:, 0]
    dmin = _f16(b[:, 2:4])[:, 0]
    sc, mn = _k4_scale_min(b[:, 4:16])
    qs = b[:, 16:144]
    e = np.arange(QK_K)
    j64, r = e // 64, e % 64
    byte_idx = 32 * j64 + r % 32
    codes = np.where(r < 32, qs[:, byte_idx] & 0xF, qs[:, byte_idx] >> 4)
    scale = d[:, None] * sc  # [nb, 8], group=32, is order == e//32
    bias = -(dmin[:, None] * mn)
    return codes, scale.astype(np.float32), bias.astype(np.float32), (4, 32)


def _decode_q5_k(b: np.ndarray):
    d = _f16(b[:, 0:2])[:, 0]
    dmin = _f16(b[:, 2:4])[:, 0]
    sc, mn = _k4_scale_min(b[:, 4:16])
    qh = b[:, 16:48]
    qs = b[:, 48:176]
    e = np.arange(QK_K)
    j64, r = e // 64, e % 64
    byte_idx = 32 * j64 + r % 32
    nib = np.where(r < 32, qs[:, byte_idx] & 0xF, qs[:, byte_idx] >> 4)
    ubit = (2 * j64 + (r >= 32)).astype(np.uint8)
    hi = (qh[:, r % 32] >> ubit[None, :]) & 1
    codes = (nib + 16 * hi).astype(np.int16)
    scale = d[:, None] * sc
    bias = -(dmin[:, None] * mn)
    return codes, scale.astype(np.float32), bias.astype(np.float32), (8, 32)


def _decode_q6_k(b: np.ndarray):
    ql = b[:, 0:128]
    qh = b[:, 128:192]
    scales = b[:, 192:208].view(np.int8).astype(np.float32)  # [nb, 16]
    d = _f16(b[:, 208:210])[:, 0]
    e = np.arange(QK_K)
    idx128, r = e // 128, e % 128
    quarter, l = r // 32, r % 32
    ql_idx = 64 * idx128 + np.where(quarter % 2 == 0, l, l + 32)
    nib = np.where(quarter < 2, ql[:, ql_idx] & 0xF, ql[:, ql_idx] >> 4)
    hshift = (2 * quarter).astype(np.uint8)
    hi2 = (qh[:, 32 * idx128 + l] >> hshift[None, :]) & 3
    codes = (nib + 16 * hi2).astype(np.int16) - 32
    scale = d[:, None] * scales  # group=16, is order == e//16
    return codes, scale.astype(np.float32), None, (8, 16)


def _decode_q8_k(b: np.ndarray):
    d = b[:, 0:4].copy().view(np.float32)[:, 0]
    codes = b[:, 4 : 4 + QK_K].view(np.int8).astype(np.int16)
    return codes, d[:, None], None, (8, QK_K)


_DECODERS = {
    "q4_0": _decode_q4_0,
    "q4_1": _decode_q4_1,
    "q5_0": _decode_q5_0,
    "q5_1": _decode_q5_1,
    "q8_0": _decode_q8_0,
    "q8_1": _decode_q8_1,
    "q2_k": _decode_q2_k,
    "q3_k": _decode_q3_k,
    "q4_k": _decode_q4_k,
    "q5_k": _decode_q5_k,
    "q6_k": _decode_q6_k,
    "q8_k": _decode_q8_k,
}


def decode_blocks(fmt: str, raw: bytes | np.ndarray, nblocks: int):
    """Decode raw GGML blocks into (codes, scale, bias, (bits, group))."""
    f = GGML_FORMATS[fmt]
    b = np.frombuffer(raw, dtype=np.uint8, count=nblocks * f.block_bytes) if not isinstance(raw, np.ndarray) else raw
    b = np.ascontiguousarray(b.reshape(nblocks, f.block_bytes))
    return _DECODERS[fmt](b)


def dequantize_rows(fmt: str, raw, shape: tuple) -> np.ndarray:
    """Full f32 dequantization (reference `to_float` semantics), for tests and
    the dequantize-on-load path. ``shape`` is the logical [rows, k]."""
    rows, k = shape
    f = GGML_FORMATS[fmt]
    nb = rows * k // f.block_elems
    codes, scale, bias, (bits, group) = decode_blocks(fmt, raw, nb)
    vals = codes.astype(np.float32).reshape(nb, f.block_elems // group, group)
    vals = vals * scale[..., None]
    if bias is not None:
        vals = vals + bias[..., None]
    return vals.reshape(rows, k)


def gguf_to_canonical(
    fmt: str, raw, shape: tuple, out_dtype: str = "bfloat16"
) -> QuantizedTensor:
    """Repack GGML blocks of a ``[out, in]`` weight into the canonical K-major
    QuantizedTensor of host tensors (integer codes preserved); ``kind`` is
    the format name."""
    n_out, k_in = shape
    f = GGML_FORMATS[fmt]
    if k_in % f.block_elems != 0:
        raise ValueError(f"{fmt}: in_features {k_in} not divisible by {f.block_elems}")
    nb = n_out * k_in // f.block_elems
    codes, scale, bias, (bits, group) = decode_blocks(fmt, raw, nb)
    codes = codes.reshape(n_out, k_in)
    groups_per_row = k_in // group
    scale = scale.reshape(n_out, groups_per_row)
    if bias is not None:
        bias = bias.reshape(n_out, groups_per_row)
    # -> K-major
    codesT = np.ascontiguousarray(codes.T)
    scaleT = np.ascontiguousarray(scale.T)
    biasT = np.ascontiguousarray(bias.T) if bias is not None else None
    split = choose_split(k_in)
    if bits == 4:
        packed = torch.from_numpy(pack4(codesT.astype(np.uint8), split))
    else:
        packed = torch.from_numpy(codesT.astype(np.int8))
    return QuantizedTensor(
        packed=packed,
        scale=torch.from_numpy(scaleT),
        bias=torch.from_numpy(biasT) if biasT is not None else None,
        codebook=None,
        kind=fmt,
        bits=bits,
        group=group,
        split=split,
        shape=(k_in, n_out),
        out_dtype=out_dtype,
    )


# ---------------------------------------------------------------------------
# Encoders (tests and synthetic checkpoints). Simpler than llama.cpp's
# error-minimizing search but the same formats.
# ---------------------------------------------------------------------------


def encode_q4_0(w: np.ndarray) -> bytes:
    """quantize_row_q4_0 (k_quants.rs:197-230): d = signed_max / -8."""
    k = w.size
    wf = w.astype(np.float32).reshape(-1, 32)
    amax_idx = np.abs(wf).argmax(axis=1)
    maxv = wf[np.arange(wf.shape[0]), amax_idx]
    d = maxv / -8.0
    inv = np.where(d != 0, 1.0 / np.where(d == 0, 1, d), 0.0)
    q = np.clip(wf * inv[:, None] + 8.5, 0, 15.0).astype(np.uint8)
    lo, hi = q[:, :16], q[:, 16:]
    out = np.empty((wf.shape[0], 18), np.uint8)
    out[:, 0:2] = d.astype(np.float16)[:, None].view(np.uint8)
    out[:, 2:18] = lo | (hi << 4)
    assert k % 32 == 0
    return out.tobytes()


def encode_q4_1(w: np.ndarray) -> bytes:
    """quantize_row_q4_1: affine per 32-block, d=(max-min)/15, m=min."""
    wf = w.astype(np.float32).reshape(-1, 32)
    mn = wf.min(axis=1)
    mx = wf.max(axis=1)
    d = (mx - mn) / 15.0
    inv = np.where(d != 0, 1.0 / np.where(d == 0, 1, d), 0.0)
    q = np.clip((wf - mn[:, None]) * inv[:, None] + 0.5, 0, 15.0).astype(np.uint8)
    out = np.empty((wf.shape[0], 20), np.uint8)
    out[:, 0:2] = d.astype(np.float16)[:, None].view(np.uint8)
    out[:, 2:4] = mn.astype(np.float16)[:, None].view(np.uint8)
    out[:, 4:20] = q[:, :16] | (q[:, 16:] << 4)
    return out.tobytes()


def _pack_qh5(q: np.ndarray) -> np.ndarray:
    """5th bits of 32 codes -> u32 (bit e = element e; see _decode_q5_0)."""
    hi = (q >> 4).astype(np.uint32)  # [nb, 32]
    return (hi << np.arange(32, dtype=np.uint32)[None, :]).sum(
        axis=1, dtype=np.uint32
    )


def encode_q5_0(w: np.ndarray) -> bytes:
    """quantize_row_q5_0: symmetric 5-bit, d = signed_max / -16."""
    wf = w.astype(np.float32).reshape(-1, 32)
    amax_idx = np.abs(wf).argmax(axis=1)
    maxv = wf[np.arange(wf.shape[0]), amax_idx]
    d = maxv / -16.0
    inv = np.where(d != 0, 1.0 / np.where(d == 0, 1, d), 0.0)
    q = np.clip(wf * inv[:, None] + 16.5, 0, 31.0).astype(np.uint8)
    out = np.empty((wf.shape[0], 22), np.uint8)
    out[:, 0:2] = d.astype(np.float16)[:, None].view(np.uint8)
    out[:, 2:6] = _pack_qh5(q)[:, None].view(np.uint8)
    out[:, 6:22] = (q[:, :16] & 0xF) | ((q[:, 16:] & 0xF) << 4)
    return out.tobytes()


def encode_q5_1(w: np.ndarray) -> bytes:
    """quantize_row_q5_1: affine 5-bit, d=(max-min)/31, m=min."""
    wf = w.astype(np.float32).reshape(-1, 32)
    mn = wf.min(axis=1)
    mx = wf.max(axis=1)
    d = (mx - mn) / 31.0
    inv = np.where(d != 0, 1.0 / np.where(d == 0, 1, d), 0.0)
    q = np.clip((wf - mn[:, None]) * inv[:, None] + 0.5, 0, 31.0).astype(np.uint8)
    out = np.empty((wf.shape[0], 24), np.uint8)
    out[:, 0:2] = d.astype(np.float16)[:, None].view(np.uint8)
    out[:, 2:4] = mn.astype(np.float16)[:, None].view(np.uint8)
    out[:, 4:8] = _pack_qh5(q)[:, None].view(np.uint8)
    out[:, 8:24] = (q[:, :16] & 0xF) | ((q[:, 16:] & 0xF) << 4)
    return out.tobytes()


def encode_q8_0(w: np.ndarray) -> bytes:
    wf = w.astype(np.float32).reshape(-1, 32)
    amax = np.abs(wf).max(axis=1)
    d = amax / 127.0
    inv = np.where(d != 0, 1.0 / np.where(d == 0, 1, d), 0.0)
    q = np.round(wf * inv[:, None]).clip(-128, 127).astype(np.int8)
    out = np.empty((wf.shape[0], 34), np.uint8)
    out[:, 0:2] = d.astype(np.float16)[:, None].view(np.uint8)
    out[:, 2:34] = q.view(np.uint8)
    return out.tobytes()


def encode_q6_k(w: np.ndarray) -> bytes:
    """Q6K with per-16 absmax scales quantized to int8 via a per-block d."""
    wf = w.astype(np.float32).reshape(-1, QK_K)
    nb = wf.shape[0]
    sub = wf.reshape(nb, 16, 16)
    smax = np.abs(sub).max(axis=2)  # [nb, 16] target scale*d per sub-block
    raw_scale = smax / 31.0  # q in [-32, 31]
    d = raw_scale.max(axis=1) / 127.0
    d = np.where(d == 0, 1e-12, d)
    sc = np.round(raw_scale / d[:, None]).clip(-128, 127).astype(np.int8)
    eff = d[:, None] * sc.astype(np.float32)
    eff_safe = np.where(eff == 0, 1, eff)
    q = np.round(sub / eff_safe[..., None]).clip(-32, 31).astype(np.int32) + 32
    q = q.reshape(nb, QK_K)
    # pack into ql/qh with the layout of _decode_q6_k
    out = np.zeros((nb, 210), np.uint8)
    ql = np.zeros((nb, 128), np.uint8)
    qh = np.zeros((nb, 64), np.uint8)
    e = np.arange(QK_K)
    idx128, r = e // 128, e % 128
    quarter, l = r // 32, r % 32
    ql_idx = 64 * idx128 + np.where(quarter % 2 == 0, l, l + 32)
    nib = (q & 0xF).astype(np.uint8)
    hi2 = ((q >> 4) & 3).astype(np.uint8)
    for qq in range(4):
        m = quarter == qq
        col = ql_idx[m]
        if qq < 2:
            ql[:, col] |= nib[:, m]
        else:
            ql[:, col] |= nib[:, m] << 4
        qh[:, 32 * idx128[m] + l[m]] |= hi2[:, m] << (2 * qq)
    out[:, 0:128] = ql
    out[:, 128:192] = qh
    out[:, 192:208] = sc.view(np.uint8)
    out[:, 208:210] = d.astype(np.float16)[:, None].view(np.uint8)
    return out.tobytes()


def encode_q4_k(w: np.ndarray) -> bytes:
    """Q4K: 8 sub-blocks of 32, affine (min/scale), 6-bit super-quantized."""
    wf = w.astype(np.float32).reshape(-1, QK_K)
    nb = wf.shape[0]
    sub = wf.reshape(nb, 8, 32)
    mn = np.minimum(sub.min(axis=2), 0.0)  # bias must be -dmin*m <= 0
    mx = np.maximum(sub.max(axis=2), 0.0)
    scale = (mx - mn) / 15.0
    d = scale.max(axis=1) / 63.0
    d = np.where(d == 0, 1e-12, d)
    dmin = np.maximum(-mn, 0.0).max(axis=1) / 63.0
    dmin = np.where(dmin == 0, 1e-12, dmin)
    sc6 = np.round(scale / d[:, None]).clip(0, 63).astype(np.uint8)
    mn6 = np.round(-mn / dmin[:, None]).clip(0, 63).astype(np.uint8)
    eff_scale = d[:, None] * sc6
    eff_min = dmin[:, None] * mn6
    eff_safe = np.where(eff_scale == 0, 1, eff_scale)
    q = np.round((sub + eff_min[..., None]) / eff_safe[..., None]).clip(0, 15)
    q = q.astype(np.uint8).reshape(nb, QK_K)
    scales = np.zeros((nb, 12), np.uint8)
    for j in range(4):
        scales[:, j] = sc6[:, j]
        scales[:, j + 4] = mn6[:, j]
    for j in range(4, 8):
        scales[:, j + 4] = (sc6[:, j] & 0xF) | ((mn6[:, j] & 0xF) << 4)
        scales[:, j - 4] |= (sc6[:, j] >> 4) << 6
        scales[:, j] |= (mn6[:, j] >> 4) << 6
    qs = np.zeros((nb, 128), np.uint8)
    e = np.arange(QK_K)
    j64, r = e // 64, e % 64
    byte_idx = 32 * j64 + r % 32
    lo_m = r < 32
    qs[:, byte_idx[lo_m]] |= q[:, lo_m]
    qs[:, byte_idx[~lo_m]] |= q[:, ~lo_m] << 4
    out = np.empty((nb, 144), np.uint8)
    out[:, 0:2] = d.astype(np.float16)[:, None].view(np.uint8)
    out[:, 2:4] = dmin.astype(np.float16)[:, None].view(np.uint8)
    out[:, 4:16] = scales
    out[:, 16:144] = qs
    return out.tobytes()


def encode_q2_k(w: np.ndarray) -> bytes:
    """Q2K: 16 sub-blocks of 16, 2-bit affine; 4-bit super-quantized
    scale/min pairs (layout of _decode_q2_k)."""
    wf = w.astype(np.float32).reshape(-1, QK_K)
    nb = wf.shape[0]
    sub = wf.reshape(nb, 16, 16)
    mn = np.minimum(sub.min(axis=2), 0.0)
    mx = np.maximum(sub.max(axis=2), 0.0)
    ls = (mx - mn) / 3.0                       # local scale, q in [0,3]
    lm = -mn                                   # local (negated) min, >= 0
    d = ls.max(axis=1) / 15.0
    d = np.where(d == 0, 1e-12, d)
    dmin = lm.max(axis=1) / 15.0
    dmin = np.where(dmin == 0, 1e-12, dmin)
    sc4 = np.round(ls / d[:, None]).clip(0, 15).astype(np.uint8)
    m4 = np.round(lm / dmin[:, None]).clip(0, 15).astype(np.uint8)
    eff_s = d[:, None] * sc4
    eff_m = dmin[:, None] * m4
    eff_safe = np.where(eff_s == 0, 1, eff_s)
    q = np.round((sub + eff_m[..., None]) / eff_safe[..., None]).clip(0, 3)
    q = q.astype(np.uint8).reshape(nb, QK_K)
    qs = np.zeros((nb, 64), np.uint8)
    e = np.arange(QK_K)
    half, r = e // 128, e % 128
    shift_i, pos = r // 32, r % 32
    byte_idx = 32 * half + pos
    for s in range(4):
        m = shift_i == s
        qs[:, byte_idx[m]] |= q[:, m] << (2 * s)
    out = np.empty((nb, 84), np.uint8)
    out[:, 0:16] = sc4 | (m4 << 4)
    out[:, 16:80] = qs
    out[:, 80:82] = d.astype(np.float16)[:, None].view(np.uint8)
    out[:, 82:84] = dmin.astype(np.float16)[:, None].view(np.uint8)
    return out.tobytes()


def _pack_q3k_scales(u: np.ndarray) -> np.ndarray:
    """16 6-bit values (0..63) -> 12 bytes (inverse of _unpack_q3k_scales)."""
    nb = u.shape[0]
    out = np.zeros((nb, 12), np.uint8)
    for j in range(4):
        out[:, j] = (u[:, j] & 0xF) | ((u[:, j + 8] & 0xF) << 4)
        out[:, j + 4] = (u[:, j + 4] & 0xF) | ((u[:, j + 12] & 0xF) << 4)
        out[:, j + 8] = (
            (u[:, j] >> 4) | ((u[:, j + 4] >> 4) << 2)
            | ((u[:, j + 8] >> 4) << 4) | ((u[:, j + 12] >> 4) << 6)
        )
    return out


def encode_q3_k(w: np.ndarray) -> bytes:
    """Q3K: 16 sub-blocks of 16, symmetric 3-bit (q' in [-4,3]); signed
    6-bit super-quantized scales (layout of _decode_q3_k)."""
    wf = w.astype(np.float32).reshape(-1, QK_K)
    nb = wf.shape[0]
    sub = wf.reshape(nb, 16, 16)
    amax_idx = np.abs(sub).argmax(axis=2)
    ii, jj = np.meshgrid(np.arange(nb), np.arange(16), indexing="ij")
    maxv = sub[ii, jj, amax_idx]
    ls = maxv / -4.0                           # q' = x/ls in [-4, 3]
    d = np.abs(ls).max(axis=1) / 31.0
    d = np.where(d == 0, 1e-12, d)
    sc = np.round(ls / d[:, None]).clip(-32, 31).astype(np.int32)
    eff = d[:, None] * sc
    eff_safe = np.where(eff == 0, 1, eff)
    qp = np.round(sub / eff_safe[..., None]).clip(-4, 3).astype(np.int32)
    codes = (qp + 4).astype(np.uint8).reshape(nb, QK_K)   # [0, 7]
    qs = np.zeros((nb, 64), np.uint8)
    hmask = np.zeros((nb, 32), np.uint8)
    e = np.arange(QK_K)
    half, r = e // 128, e % 128
    shift_i, pos = r // 32, r % 32
    byte_idx = 32 * half + pos
    mbit = half * 4 + shift_i
    for s in range(4):
        m = shift_i == s
        qs[:, byte_idx[m]] |= (codes[:, m] & 3) << (2 * s)
    for b in range(8):
        m = mbit == b
        hmask[:, pos[m]] |= (codes[:, m] >> 2) << b
    out = np.empty((nb, 110), np.uint8)
    out[:, 0:32] = hmask
    out[:, 32:96] = qs
    out[:, 96:108] = _pack_q3k_scales((sc + 32).astype(np.uint8))
    out[:, 108:110] = d.astype(np.float16)[:, None].view(np.uint8)
    return out.tobytes()


def encode_q5_k(w: np.ndarray) -> bytes:
    """Q5K: 8 sub-blocks of 32, affine 5-bit, 6-bit super-quantized
    scale/min (encode_q4_k with 31 levels + high-bit plane)."""
    wf = w.astype(np.float32).reshape(-1, QK_K)
    nb = wf.shape[0]
    sub = wf.reshape(nb, 8, 32)
    mn = np.minimum(sub.min(axis=2), 0.0)
    mx = np.maximum(sub.max(axis=2), 0.0)
    scale = (mx - mn) / 31.0
    d = scale.max(axis=1) / 63.0
    d = np.where(d == 0, 1e-12, d)
    dmin = np.maximum(-mn, 0.0).max(axis=1) / 63.0
    dmin = np.where(dmin == 0, 1e-12, dmin)
    sc6 = np.round(scale / d[:, None]).clip(0, 63).astype(np.uint8)
    mn6 = np.round(-mn / dmin[:, None]).clip(0, 63).astype(np.uint8)
    eff_scale = d[:, None] * sc6
    eff_min = dmin[:, None] * mn6
    eff_safe = np.where(eff_scale == 0, 1, eff_scale)
    q = np.round((sub + eff_min[..., None]) / eff_safe[..., None]).clip(0, 31)
    q = q.astype(np.uint8).reshape(nb, QK_K)
    scales = np.zeros((nb, 12), np.uint8)
    for j in range(4):
        scales[:, j] = sc6[:, j]
        scales[:, j + 4] = mn6[:, j]
    for j in range(4, 8):
        scales[:, j + 4] = (sc6[:, j] & 0xF) | ((mn6[:, j] & 0xF) << 4)
        scales[:, j - 4] |= (sc6[:, j] >> 4) << 6
        scales[:, j] |= (mn6[:, j] >> 4) << 6
    qs = np.zeros((nb, 128), np.uint8)
    qh = np.zeros((nb, 32), np.uint8)
    e = np.arange(QK_K)
    j64, r = e // 64, e % 64
    byte_idx = 32 * j64 + r % 32
    lo_m = r < 32
    qs[:, byte_idx[lo_m]] |= q[:, lo_m] & 0xF
    qs[:, byte_idx[~lo_m]] |= (q[:, ~lo_m] & 0xF) << 4
    ubit = 2 * j64 + (r >= 32)
    for b in range(8):
        m = ubit == b
        qh[:, (r % 32)[m]] |= (q[:, m] >> 4) << b
    out = np.empty((nb, 176), np.uint8)
    out[:, 0:2] = d.astype(np.float16)[:, None].view(np.uint8)
    out[:, 2:4] = dmin.astype(np.float16)[:, None].view(np.uint8)
    out[:, 4:16] = scales
    out[:, 16:48] = qh
    out[:, 48:176] = qs
    return out.tobytes()


ENCODERS = {
    "q4_0": encode_q4_0,
    "q4_1": encode_q4_1,
    "q5_0": encode_q5_0,
    "q5_1": encode_q5_1,
    "q8_0": encode_q8_0,
    "q2_k": encode_q2_k,
    "q3_k": encode_q3_k,
    "q4_k": encode_q4_k,
    "q5_k": encode_q5_k,
    "q6_k": encode_q6_k,
}


# ---------------------------------------------------------------------------
# Quantizers on the weight's device (ISQ). Each gives what
# ``gguf_to_canonical(fmt, ENCODERS[fmt](w.T), (N, K))`` gives, without GGML
# bytes: the same f32 operations in the same order (f64 where numpy promotes,
# in Q3K), the codes chosen with the unrounded d / dmin as the encoders
# choose them, and the scale and bias planes decoded from the f16-rounded d /
# dmin times the integer sub-scales as the decoders do. Quotients divide by
# tensors: PyTorch's CUDA division by a Python scalar multiplies by its
# reciprocal, which is not the IEEE quotient numpy computes.
# ---------------------------------------------------------------------------


def _div(a: torch.Tensor, c: float) -> torch.Tensor:
    return a / torch.full_like(a, c)


def _inv(d: torch.Tensor) -> torch.Tensor:
    """``where(d != 0, 1 / where(d == 0, 1, d), 0)``."""
    one = torch.ones_like(d)
    return torch.where(d != 0, one / torch.where(d == 0, one, d), torch.zeros_like(d))


def _nonzero(d: torch.Tensor) -> torch.Tensor:
    """``where(d == 0, 1e-12, d)`` (the k-quant encoders' guard)."""
    return torch.where(d == 0, torch.full_like(d, 1e-12), d)


def _safe(e: torch.Tensor) -> torch.Tensor:
    return torch.where(e == 0, torch.ones_like(e), e)


def _f16_round(d: torch.Tensor) -> torch.Tensor:
    """The f16 round trip of a stored block scale (nearest even, subnormals
    kept, 1e-12 -> 0)."""
    return d.half().float()


def _first_absmax(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The signed element of largest magnitude along ``dim`` (the first one on
    a tie, as numpy's argmax), with ``dim`` kept."""
    a = x.abs()
    m = a.amax(dim=dim, keepdim=True)
    shape = [1] * x.dim()
    shape[dim] = x.shape[dim]
    pos = torch.arange(x.shape[dim], device=x.device).reshape(shape)
    first = torch.where(a == m, pos, x.shape[dim]).amin(dim=dim, keepdim=True)
    return torch.gather(x, dim, first)


def _symmetric(b, levels: float, offset: float, hi: float):
    """Q4_0 / Q5_0 codes: ``d = signed absmax / -levels``, ``q = trunc(clip(
    w * (1/d) + offset, 0, hi))``."""
    d = _div(_first_absmax(b, 1), -levels)
    q = torch.clamp(b * _inv(d) + offset, 0, hi).to(torch.uint8)
    return q, d


def _minmax(b, levels: float):
    """Q4_1 / Q5_1 codes: ``d = (max - min) / levels``, ``q = trunc(clip(
    (w - min) * (1/d) + 0.5, 0, levels))``."""
    mn = b.amin(dim=1, keepdim=True)
    mx = b.amax(dim=1, keepdim=True)
    d = _div(mx - mn, levels)
    q = torch.clamp((b - mn) * _inv(d) + 0.5, 0, levels).to(torch.uint8)
    return q, d, mn


def _kquant_affine(sub, levels: float, sub_levels: float):
    """Q2K / Q4K / Q5K on ``sub [nb, n_sub, sub_len, N]``: per sub-block an
    affine range of ``levels`` steps, its scale and negated min quantized
    against the super-block's d / dmin (``sub_levels`` = 15 for Q2K's 4-bit
    sub-scales, 63 for the 6-bit ones); codes from the unrounded d / dmin."""
    mn = torch.clamp(sub.amin(dim=2), max=0.0)
    mx = torch.clamp(sub.amax(dim=2), min=0.0)
    ls = _div(mx - mn, levels)
    lm = -mn
    d = _nonzero(_div(ls.amax(dim=1), sub_levels))
    dmin = _nonzero(_div(torch.clamp(lm, min=0.0).amax(dim=1), sub_levels))
    sc = torch.clamp(torch.round(ls / d[:, None]), 0, sub_levels).to(torch.uint8)
    mq = torch.clamp(torch.round(lm / dmin[:, None]), 0, sub_levels).to(torch.uint8)
    eff_s = d[:, None] * sc
    eff_m = dmin[:, None] * mq
    q = torch.clamp(torch.round((sub + eff_m[:, :, None]) / _safe(eff_s)[:, :, None]), 0,
                    levels)
    scale = _f16_round(d)[:, None] * sc
    bias = -(_f16_round(dmin)[:, None] * mq)
    return q.to(torch.uint8), scale, bias


def _q3_k(sub):
    """Q3K on ``sub [nb, 16, 16, N]``: symmetric 3-bit (codes 0..7 for
    q' + 4), signed 6-bit sub-scales; numpy takes the codes' quotient in f64
    (f32 d times int32 sub-scales), and so does this."""
    ls = _div(_first_absmax(sub, 2).squeeze(2), -4.0)
    d = _nonzero(_div(ls.abs().amax(dim=1), 31.0))
    sc = torch.clamp(torch.round(ls / d[:, None]), -32, 31)
    eff = d.double()[:, None] * sc.double()
    qp = torch.clamp(torch.round(sub.double() / _safe(eff)[:, :, None]), -4, 3)
    scale = _f16_round(d)[:, None] * sc
    return (qp + 4).to(torch.uint8), scale, -4.0 * scale


def _q6_k(sub):
    """Q6K on ``sub [nb, 16, 16, N]``: symmetric 6-bit codes, int8
    sub-scales against one d per super-block."""
    raw = _div(sub.abs().amax(dim=2), 31.0)
    d = _nonzero(_div(raw.amax(dim=1), 127.0))
    sc = torch.clamp(torch.round(raw / d[:, None]), -128, 127)
    eff = d[:, None] * sc
    q = torch.clamp(torch.round(sub / _safe(eff)[:, :, None]), -32, 31)
    return q.to(torch.int8), _f16_round(d)[:, None] * sc


# format -> (bits of the carrier, scale group)
CANONICAL_LAYOUT = {
    "q4_0": (4, 32), "q4_1": (4, 32), "q5_0": (8, 32), "q5_1": (8, 32),
    "q8_0": (8, 32), "q2_k": (4, 16), "q3_k": (4, 16), "q4_k": (4, 32),
    "q5_k": (8, 32), "q6_k": (8, 16),
}


def quantize_canonical(w_kmajor: torch.Tensor, fmt: str,
                       out_dtype: str = "bfloat16") -> QuantizedTensor:
    """A K-major ``[K, N]`` weight -> the canonical ``fmt`` tensor on the
    weight's device, equal (codes, scale plane, bias plane) to
    ``gguf_to_canonical(fmt, ENCODERS[fmt](w.T), (N, K))``."""
    if fmt not in CANONICAL_LAYOUT:
        raise ValueError(f"no device quantizer for {fmt!r}")
    k, n = w_kmajor.shape
    block = GGML_FORMATS[fmt].block_elems
    if k % block:
        raise ValueError(f"{fmt}: in_features {k} not divisible by {block}")
    bits, group = CANONICAL_LAYOUT[fmt]
    w = w_kmajor.float()
    bias = None
    if fmt in ("q4_0", "q5_0"):
        levels, offset, hi = (8.0, 8.5, 15.0) if fmt == "q4_0" else (16.0, 16.5, 31.0)
        q, d = _symmetric(w.reshape(k // 32, 32, n), levels, offset, hi)
        scale = _f16_round(d)
        if fmt == "q4_0":
            bias = -8.0 * scale
        else:
            q = (q.to(torch.int16) - 16).to(torch.int8)
    elif fmt in ("q4_1", "q5_1"):
        q, d, mn = _minmax(w.reshape(k // 32, 32, n), 15.0 if fmt == "q4_1" else 31.0)
        scale, bias = _f16_round(d), _f16_round(mn)
        if fmt == "q5_1":
            q = q.to(torch.int8)
    elif fmt == "q8_0":
        b = w.reshape(k // 32, 32, n)
        d = _div(b.abs().amax(dim=1, keepdim=True), 127.0)
        q = torch.clamp(torch.round(b * _inv(d)), -128, 127).to(torch.int8)
        scale = _f16_round(d)
    elif fmt == "q2_k":
        q, scale, bias = _kquant_affine(w.reshape(k // QK_K, 16, 16, n), 3.0, 15.0)
    elif fmt == "q3_k":
        q, scale, bias = _q3_k(w.reshape(k // QK_K, 16, 16, n))
    elif fmt in ("q4_k", "q5_k"):
        levels = 15.0 if fmt == "q4_k" else 31.0
        q, scale, bias = _kquant_affine(w.reshape(k // QK_K, 8, 32, n), levels, 63.0)
        if fmt == "q5_k":
            q = q.to(torch.int8)
    else:  # q6_k
        q, scale = _q6_k(w.reshape(k // QK_K, 16, 16, n))
    q = q.reshape(k, n)
    split = choose_split(k)
    return QuantizedTensor(
        packed=pack4_tensor(q, split) if bits == 4 else q,
        scale=scale.reshape(k // group, n).contiguous(),
        bias=None if bias is None else bias.reshape(k // group, n).contiguous(),
        codebook=None,
        kind=fmt,
        bits=bits,
        group=group,
        split=split,
        shape=(k, n),
        out_dtype=out_dtype,
    )
