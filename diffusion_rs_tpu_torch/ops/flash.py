"""Blockwise flash attention (forward), port of ``ops/flash_pallas.py``.

The JAX package's ``_flash_kernel`` in bf16 mode is replaced by the
hand-written Hopper kernel ``csrc/flash_fwd.cu``: online softmax with f32
running max/sum/accumulator, QK^T and P.V on bf16 tensor cores, ragged kv
masked to -1e30, and each head's output written straight into its column
slice of ``[B, S, H*D]``.

Beside it is the plain PyTorch version, which follows the same per-kv-block
online softmax: ``l`` sums the f32 ``p`` while P.V uses ``p`` cast to the
value dtype. A CPU tensor takes the plain version; a CUDA tensor takes the
kernel or raises. The TPU tiling machinery (``DEFAULT_BLOCK_Q/K``, VMEM
planning) and the diagnostic ablation knobs are not ported.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import _cuda

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
