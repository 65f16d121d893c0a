"""Blockwise flash attention (forward), port of ``ops/flash_pallas.py``.

Three Pallas kernels are replaced by entry points of the hand-written Hopper
kernel ``csrc/flash_fwd.cu`` (one body: online softmax with f32 running
max/sum/accumulator, QK^T and P.V on bf16 tensor cores, ragged kv masked to
-1e30, each head's output written straight into its column slice of
``[B, S, H*D]``):

* K3 ``flash_fwd`` (``_flash_kernel``, bf16, ``seq_out``): q/k/v [B, H, S, D];
* K6 ``flash_sm`` (``_flash_sm_kernel``): seq-major q/k/v [B, S, H*D], each
  head a column slice;
* K7 ``flash_rope`` (``_flash_rope_kernel``): K6 with the half-split RoPE of
  q and k done inside the kernel from the expanded tables.

Beside them are the plain PyTorch versions, which follow the same
per-kv-block online softmax: ``l`` sums the f32 ``p`` while P.V uses ``p``
cast to the value dtype. A CPU tensor takes the plain version; a CUDA tensor
takes the kernel or raises. The TPU tiling machinery (``DEFAULT_BLOCK_Q/K``,
VMEM planning) and the diagnostic ablation knobs are not ported.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import torch

from . import _cuda
from .rope import apply_rope_halfsplit

_NEG_INF = -1e30
# kv rows per block of the CUDA kernel; the plain version uses the same
# blocking by default so the two accumulate in the same order of blocks.
BLOCK_K = 64
HEAD_DIM = 128


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float, block_k: int = BLOCK_K) -> torch.Tensor:
    """[B, H, Sq, D] x3 -> [B, H, Sq, D], kv block by kv block."""
    b, h, sq, d = q.shape
    skv = k.shape[2]
    qf = q.float()
    m = torch.full((b, h, sq, 1), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, sq, v.shape[-1]), dtype=torch.float32, device=q.device)
    for j in range(0, skv, block_k):
        kb = k[:, :, j:j + block_k].float()
        vb = v[:, :, j:j + block_k]
        s = (qf @ kb.transpose(-1, -2)) * scale
        m_next = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_next)
        p = torch.exp(s - m_next)
        pv = p.to(v.dtype).float() @ vb.float()
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + pv
        m = m_next
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    return (acc * (1.0 / l_safe)).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None,
                    out_seqmajor: bool = False) -> torch.Tensor:
    """q, k, v: [B, H, S, D] -> [B, H, Sq, D], or [B, Sq, H*D] with
    ``out_seqmajor`` (the layout the kernel writes)."""
    b, h, sq, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        o = flash_attention_plain(q, k, v, scale)
        return o.transpose(1, 2).reshape(b, sq, h * d) if out_seqmajor else o
    out = flash_fwd(q, k, v, scale)
    if out_seqmajor:
        return out
    return out.view(b, sq, h, d).transpose(1, 2)


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: float) -> torch.Tensor:
    """Launch ``csrc/flash_fwd.cu``: bf16 [B, H, S, 128] -> bf16 [B, Sq, H*128]."""
    b, h, sq, d = q.shape
    skv = k.shape[2]
    if d != HEAD_DIM:
        raise NotImplementedError(f"flash kernel takes head_dim {HEAD_DIM}, got {d}")
    for name, t, shape in (("q", q, (b, h, sq, d)), ("k", k, (b, h, skv, d)),
                           ("v", v, (b, h, skv, d))):
        if t.device != q.device or t.device.type != "cuda":
            raise ValueError(f"{name} must be on the CUDA device of q, got {t.device}")
        if t.dtype != torch.bfloat16 or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected bf16 {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if skv == 0:
        raise ValueError("flash kernel needs at least one kv row")
    out = torch.empty((b, sq, h * d), dtype=torch.bfloat16, device=q.device)
    _cuda.launch("flash_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 out.data_ptr(), b, h, sq, skv, float(scale))
    return out


# ---------------------------------------------------------------------------
# K6 / K7: seq-major attention, RoPE outside or inside the kernel
# ---------------------------------------------------------------------------


def flash_sm_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   head_dim: int, scale: float) -> torch.Tensor:
    """Plain version of K6: :func:`flash_attention_plain` on head-split
    views of [B, S, H*D] q/k/v, merged back to [B, Sq, H*D]."""
    b, sq, n = q.shape
    h = n // head_dim

    def split(t):
        return t.reshape(b, t.shape[1], h, head_dim).transpose(1, 2)

    o = flash_attention_plain(split(q), split(k), split(v), scale)
    return o.transpose(1, 2).reshape(b, sq, n)


def rope_halfsplit_seqmajor(x: torch.Tensor, ce: torch.Tensor, se: torch.Tensor,
                            head_dim: int) -> torch.Tensor:
    """Half-split RoPE of seq-major [B, S, H*D] from the expanded tables
    (cos = ce[..., :D/2], sin = se[..., D/2:]), as the JAX package's
    rope-outside path does it."""
    b, s, n = x.shape
    x4 = x.reshape(b, s, n // head_dim, head_dim)
    return apply_rope_halfsplit(x4, ce[..., : head_dim // 2], se[..., head_dim // 2:],
                                seq_axis=1).reshape(b, s, n)


def flash_rope_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     ce_q: torch.Tensor, se_q: torch.Tensor, ce_k: torch.Tensor,
                     se_k: torch.Tensor, head_dim: int, scale: float) -> torch.Tensor:
    """Plain version of K7: the plain half-split RoPE of q and k, then K6's
    plain version."""
    return flash_sm_plain(rope_halfsplit_seqmajor(q, ce_q, se_q, head_dim),
                          rope_halfsplit_seqmajor(k, ce_k, se_k, head_dim), v,
                          head_dim, scale)


def _seqmajor_args(q, k, v):
    """Shape, device and layout checks of K6/K7's q/k/v; returns (b, h, sq,
    skv) and the batch/row strides the kernel takes."""
    b, sq, n = q.shape
    if n % HEAD_DIM != 0:
        raise NotImplementedError(f"seq-major flash kernel takes heads of {HEAD_DIM} "
                                  f"columns, got a width of {n}")
    skv = k.shape[1]
    strides = []
    for name, t, shape in (("q", q, (b, sq, n)), ("k", k, (b, skv, n)),
                           ("v", v, (b, skv, n))):
        if t.device != q.device or t.device.type != "cuda":
            raise ValueError(f"{name} must be on the CUDA device of q, got {t.device}")
        if t.dtype != torch.bfloat16 or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected bf16 {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        sb, sr, sc = t.stride()
        if sc != 1 or sr % 8 or sb % 8 or t.data_ptr() % 16:
            raise ValueError(f"{name} rows must be 16-byte aligned with unit column "
                             f"stride, got strides {t.stride()}")
        if (shape[1] - 1) * sr + n >= 2 ** 31:
            raise ValueError(f"{name}: row offsets exceed 32 bits (strides {t.stride()})")
        strides += [sb, sr]
    if skv == 0:
        raise ValueError("flash kernel needs at least one kv row")
    return (b, n // HEAD_DIM, sq, skv), strides


def _check_table(name: str, t: torch.Tensor, shape, device) -> None:
    if t.device != device or t.dtype != torch.float32 or tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected f32 {shape} on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def flash_sm(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             scale: float) -> torch.Tensor:
    """Launch K6 (``flash_sm`` of ``csrc/flash_fwd.cu``): bf16 q [B, Sq,
    H*128], k/v [B, Skv, H*128] (rows may be column slices of wider rows)
    -> bf16 [B, Sq, H*128]."""
    (b, h, sq, skv), strides = _seqmajor_args(q, k, v)
    out = torch.empty((b, sq, h * HEAD_DIM), dtype=torch.bfloat16, device=q.device)
    _cuda.launch("flash_sm", q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, h, sq, skv, *strides, float(scale))
    return out


def flash_rope(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               ce_q: torch.Tensor, se_q: torch.Tensor, ce_k: torch.Tensor,
               se_k: torch.Tensor, scale: float) -> torch.Tensor:
    """Launch K7 (``flash_rope`` of ``csrc/flash_fwd.cu``): K6's operands
    plus the expanded RoPE tables f32 [B, Sq, 128] (q) and [B, Skv, 128] (k)."""
    (b, h, sq, skv), strides = _seqmajor_args(q, k, v)
    _check_table("ce_q", ce_q, (b, sq, HEAD_DIM), q.device)
    _check_table("se_q", se_q, (b, sq, HEAD_DIM), q.device)
    _check_table("ce_k", ce_k, (b, skv, HEAD_DIM), q.device)
    _check_table("se_k", se_k, (b, skv, HEAD_DIM), q.device)
    out = torch.empty((b, sq, h * HEAD_DIM), dtype=torch.bfloat16, device=q.device)
    _cuda.launch("flash_rope", q.data_ptr(), k.data_ptr(), v.data_ptr(), ce_q.data_ptr(),
                 se_q.data_ptr(), ce_k.data_ptr(), se_k.data_ptr(), out.data_ptr(),
                 b, h, sq, skv, *strides, float(scale))
    return out


def flash_attention_fused(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          ce: torch.Tensor, se: torch.Tensor, head_dim: int,
                          scale: Optional[float] = None,
                          rope_in_kernel: Optional[bool] = None) -> torch.Tensor:
    """Seq-major self-attention with half-split RoPE: q/k/v [B, S, H*D] (the
    projection's own layout), expanded tables ce/se [B, S, D]
    (ops/rope.expand_rope_tables) -> [B, S, H*D].

    ``rope_in_kernel`` (default: ``DIFFUSION_RS_TPU_ATTN_LAYOUT=inkernel``)
    rotates q/k inside the kernel (K7); otherwise they are rotated outside
    and K6 runs on them. Raises ``NotImplementedError`` unless head_dim is a
    multiple of 128; the caller then takes the [B, H, S, D] path."""
    if head_dim % 128 != 0:
        raise NotImplementedError("fused-RoPE kernel needs head_dim % 128 == 0")
    if q.shape[-1] % head_dim != 0:
        raise NotImplementedError("q last dim must be a head_dim multiple")
    if scale is None:
        scale = 1.0 / (head_dim ** 0.5)
    if rope_in_kernel is None:
        rope_in_kernel = os.environ.get("DIFFUSION_RS_TPU_ATTN_LAYOUT") == "inkernel"
    cpu = q.device.type == "cpu"
    if not cpu and head_dim != HEAD_DIM:
        raise NotImplementedError(f"flash kernels take head_dim {HEAD_DIM}, got {head_dim}")
    if rope_in_kernel:
        if cpu:
            return flash_rope_plain(q, k, v, ce, se, ce, se, head_dim, scale)
        return flash_rope(q, k, v, ce, se, ce, se, scale)
    qr = rope_halfsplit_seqmajor(q, ce, se, head_dim)
    kr = rope_halfsplit_seqmajor(k, ce, se, head_dim)
    if cpu:
        return flash_sm_plain(qr, kr, v, head_dim, scale)
    return flash_sm(qr, kr, v, scale)
