"""FLUX multi-axis rotary position embedding (port of ``ops/rope.py``):
per-axis (cos, sin) tables concatenated along the frequency axis, applied to
interleaved pairs of the head dim, all in f32; and the half-split form
(pairs ``(i, i + D/2)``) that runs on q/k projections re-laid by
``models/optimize.rope_halfsplit_permute``, with the expanded tables the
fused-RoPE flash kernel reads.

:func:`qk_norm_rope` is a FLUX block's attention prologue in the default
(interleaved) layout: head split, QK-RMSNorm, the joint [txt; img]
concatenation, RoPE and the contiguous [B, H, S, D] operands, in one launch
of ``csrc/qk_norm_rope.cu`` on the card; :func:`qk_norm_rope_plain` is its
plain composition, which the CPU runs."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from . import _cuda
from .norms import rms_norm

HEAD_DIM = 128  # the kernel's head dim


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


def qk_norm_rope_plain(streams, cos: torch.Tensor, sin: torch.Tensor, n_heads: int,
                       eps: float = 1e-6):
    """The plain composition of :func:`qk_norm_rope`: per stream the head
    split and :func:`~.norms.rms_norm` of q and k, the streams concatenated
    along the sequence (the first stream's rows first), :func:`apply_rope`
    on q and k, and contiguous q, k, v [B, H, S, D]."""
    def heads(t):
        b, s, _ = t.shape
        return t.reshape(b, s, n_heads, -1).transpose(1, 2)

    qs, ks, vs = [], [], []
    for qc, kc, vc, q_scale, k_scale in streams:
        qs.append(rms_norm(heads(qc), q_scale, eps))
        ks.append(rms_norm(heads(kc), k_scale, eps))
        vs.append(heads(vc))
    q, k, v = (torch.cat(t, dim=2) if len(t) > 1 else t[0] for t in (qs, ks, vs))
    return (apply_rope(q, cos, sin).contiguous(), apply_rope(k, cos, sin).contiguous(),
            v.contiguous())


def qk_norm_rope(streams, cos: torch.Tensor, sin: torch.Tensor, n_heads: int,
                 eps: float = 1e-6):
    """A FLUX block's attention prologue in the interleaved-RoPE layout.

    ``streams``: one (a single block) or two (a double block: txt, then
    img) tuples ``(q, k, v, q_scale, k_scale)`` of q/k/v columns [B, S_x,
    H*D] (contiguous linear outputs or column slices of a fused projection)
    and the stream's QK-RMSNorm scales [D]; cos/sin [B or 1, S, D/2] over
    the joint rows. Returns q, k, v [B, H, S, D] contiguous, RMS-normed and
    rotated (q, k).

    On the card it launches ``qk_norm_rope`` of ``csrc/qk_norm_rope.cu``
    (:func:`qk_norm_rope_cuda`; v equal to :func:`qk_norm_rope_plain`'s, q
    and k too but where the sum of squares' order moves 1 / rms by an f32
    ulp) and raises on operands it cannot take: another head dim, dtype or
    layout, or an operand that requires grad under grad mode. A caller
    that runs attention without the kernels (a training step) takes
    :func:`qk_norm_rope_plain` itself, as models/flux.py does. On the CPU,
    the plain composition."""
    if streams[0][0].is_cuda:
        return qk_norm_rope_cuda(streams, cos, sin, n_heads, eps)
    return qk_norm_rope_plain(streams, cos, sin, n_heads, eps)


def _check_columns(name: str, t: torch.Tensor, shape, device) -> Tuple[int, int]:
    """Raise unless ``t`` is [B, S, H*128] with unit column stride on
    ``device`` and its 16-byte rows start 16-byte aligned; returns its batch
    and row strides (the batch stride 0 for one sample)."""
    if tuple(t.shape) != shape or t.device != device or t.dtype != torch.bfloat16:
        raise ValueError(f"qk_norm_rope: {name} is {t.dtype} {tuple(t.shape)} on {t.device}, "
                         f"expected bfloat16 {shape} on {device}")
    sb = t.stride(0) if shape[0] > 1 else 0
    if t.stride(2) != 1 or t.data_ptr() % 16 or sb % 8 or t.stride(1) % 8:
        raise ValueError(f"qk_norm_rope: {name} needs unit column stride, a 16-byte aligned "
                         f"base and batch / row strides in multiples of 8 elements (strides "
                         f"{t.stride()}, base {t.data_ptr():#x})")
    return sb, t.stride(1)


def qk_norm_rope_cuda(streams, cos: torch.Tensor, sin: torch.Tensor, n_heads: int,
                      eps: float = 1e-6):
    """Launch ``qk_norm_rope`` (``csrc/qk_norm_rope.cu``) on :func:`qk_norm_rope`'s
    operands, bf16 and f32 tables, head dim 128, on one card. Raises before
    any launch on operands the kernel does not take: ``NotImplementedError``
    for another head dim, ``ValueError`` for another dtype, shape or layout
    (the kernel reads the columns, scales and tables 16 bytes at a time,
    so each base is 16-byte aligned), ``RuntimeError`` for an operand that
    requires grad under grad mode (:func:`._cuda.check_no_grad`)."""
    if len(streams) not in (1, 2):
        raise ValueError(f"qk_norm_rope: one or two streams, got {len(streams)}")
    q0 = streams[0][0]
    if q0.shape[-1] != n_heads * HEAD_DIM:
        raise NotImplementedError(f"qk_norm_rope kernel takes head_dim {HEAD_DIM}, got "
                                  f"{q0.shape[-1] / n_heads:g}")
    b, n, device = q0.shape[0], n_heads * HEAD_DIM, q0.device
    rows = [stream[0].shape[1] for stream in streams]
    s = sum(rows)
    args, strides = [], []
    for i, ((qc, kc, vc, q_scale, k_scale), s_x) in enumerate(zip(streams, rows)):
        for name, t in (("q", qc), ("k", kc), ("v", vc)):
            strides += _check_columns(f"stream {i} {name}", t, (b, s_x, n), device)
        for name, w in (("q_scale", q_scale), ("k_scale", k_scale)):
            if (tuple(w.shape) != (HEAD_DIM,) or w.stride(0) != 1 or w.device != device
                    or w.dtype != torch.bfloat16 or w.data_ptr() % 16):
                raise ValueError(f"qk_norm_rope: stream {i} {name} must be a contiguous "
                                 f"bfloat16 [{HEAD_DIM}] on {device} at a 16-byte aligned "
                                 f"base, got {w.dtype} {tuple(w.shape)} on {w.device} "
                                 f"(base {w.data_ptr():#x})")
        args += [qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), q_scale.data_ptr(),
                 k_scale.data_ptr()]
    if len(streams) == 1:  # the second stream's pointers are not read (0 rows)
        args, strides, rows = args * 2, strides * 2, rows + [0]
    if (cos.dim() != 3 or cos.shape[0] not in (1, b)
            or tuple(cos.shape[1:]) != (s, HEAD_DIM // 2) or sin.shape != cos.shape
            or not cos.device == sin.device == device
            or not cos.dtype == sin.dtype == torch.float32):
        raise ValueError(f"qk_norm_rope: cos / sin are {cos.dtype} {tuple(cos.shape)} / "
                         f"{sin.dtype} {tuple(sin.shape)} on {cos.device}, expected float32 "
                         f"[1 or {b}, {s}, {HEAD_DIM // 2}] on {device}")
    cos, sin = cos.contiguous(), sin.contiguous()
    if cos.data_ptr() % 16 or sin.data_ptr() % 16:
        raise ValueError(f"qk_norm_rope: cos / sin need 16-byte aligned bases (at "
                         f"{cos.data_ptr():#x} / {sin.data_ptr():#x})")
    t_sb = s * (HEAD_DIM // 2) if cos.shape[0] > 1 else 0
    q, k, v = (torch.empty((b, n_heads, s, HEAD_DIM), dtype=torch.bfloat16, device=device)
               for _ in range(3))
    _cuda.launch("qk_norm_rope", *args, cos.data_ptr(), sin.data_ptr(), q.data_ptr(),
                 k.data_ptr(), v.data_ptr(), b, n_heads, *rows, *strides, t_sb, float(eps),
                 device=device, inputs=[t for stream in streams for t in stream] + [cos, sin])
    return q, k, v
