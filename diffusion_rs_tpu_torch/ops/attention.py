"""Scaled dot-product attention, port of ``ops/attention.py``.

``sdpa_xla`` is the f32 reference (einsum, softmax, einsum) with optional
additive bias and tanh softcap; T5, CLIP and the VAE call it directly
(``impl="xla"``). ``sdpa`` / ``sdpa_merged`` dispatch the unbiased case to
the flash kernels (ops/flash.py), which is what FLUX joint attention
reaches; under sequence parallelism ``sdpa_merged(seq=...)`` takes the ring
or its gather fallback (ops/partitioned.py), and its XLA path gathers k/v
over the sp group (GSPMD's form of it in JAX), differentiably under grad
mode. ``DIFFUSION_RS_TPU_NO_FLASH`` (any non-empty value, as in JAX) sends
the automatic pick to ``sdpa_xla``: the path a training step takes, since
the hand-written kernels have no backward. The int8 modes are read from
the JAX package's environment knobs, with its parsing and defaults:
``DIFFUSION_RS_TPU_ATTN_S8`` (s8 QK^T, K9, off),
``DIFFUSION_RS_TPU_ATTN_S8PV`` (s8 P.V, K10, off) and
``DIFFUSION_RS_TPU_ATTN_MERGED`` (the kernel's head-merged output, on).
Each is read once and cached; ``<knob>.cache_clear()`` re-reads it.
"""

from __future__ import annotations

import functools
import os
from typing import Optional

import torch

from ..parallel.mesh import gather_rows
from .flash import flash_attention
from .partitioned import SeqShard, partitioned_flash


def sdpa_xla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             scale: Optional[float] = None, bias: Optional[torch.Tensor] = None,
             softcap: Optional[float] = None) -> torch.Tensor:
    """f32 attention over [B, H, S, D]; ``bias`` is additive
    [B|1, H|1, Sq, Sk]. Returns q.dtype."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    scores = torch.einsum("bhsd,bhtd->bhst", q.float(), k.float()) * scale
    if softcap is not None and softcap != 1.0:
        scores = torch.tanh(scores / softcap) * softcap
    if bias is not None:
        scores = scores + bias.float()
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhst,bhtd->bhsd", probs, v.float())
    return out.to(q.dtype)


def _env_flag(name: str) -> Optional[bool]:
    env = os.environ.get(name, "").lower()
    if env in ("0", "off", "false"):
        return False
    if env in ("1", "on", "force", "true"):
        return True
    return None


@functools.lru_cache(None)
def _no_flash() -> bool:
    """Whether DIFFUSION_RS_TPU_NO_FLASH is set (non-empty): the automatic
    pick of :func:`sdpa` / :func:`sdpa_merged` is then ``sdpa_xla``."""
    return bool(os.environ.get("DIFFUSION_RS_TPU_NO_FLASH"))


@functools.lru_cache(None)
def _s8_default() -> bool:
    """Whether the flash path runs QK^T as s8 x s8 (K9):
    DIFFUSION_RS_TPU_ATTN_S8=0/1, off by default as in JAX."""
    env = _env_flag("DIFFUSION_RS_TPU_ATTN_S8")
    return False if env is None else env


@functools.lru_cache(None)
def _s8_pv_default() -> bool:
    """Whether the flash path runs P.V as s8 x s8 (K10):
    DIFFUSION_RS_TPU_ATTN_S8PV=0/1, off by default as in JAX."""
    env = _env_flag("DIFFUSION_RS_TPU_ATTN_S8PV")
    return False if env is None else env


@functools.lru_cache(None)
def _merged_default() -> bool:
    """Whether ``sdpa_merged`` takes the kernel's head-merged output;
    DIFFUSION_RS_TPU_ATTN_MERGED=0 takes the [B, H, S, D] output and a
    transpose instead (the same values)."""
    env = os.environ.get("DIFFUSION_RS_TPU_ATTN_MERGED", "").lower()
    return env not in ("0", "off", "false")


def sdpa(q, k, v, scale: Optional[float] = None, bias=None,
         softcap: Optional[float] = None, impl: Optional[str] = None,
         s8: Optional[bool] = None, s8_pv: Optional[bool] = None):
    """``impl`` in {None (auto), "flash", "xla"}: auto takes the flash
    kernels unless a bias or softcap is given. ``s8`` / ``s8_pv`` (None: the
    environment's default) pick the int8 modes. A shape the flash kernels do
    not take (``NotImplementedError``) runs ``sdpa_xla``, as in JAX."""
    if impl is None:
        impl = "flash" if bias is None and softcap is None and not _no_flash() else "xla"
    if impl == "flash":
        s8 = _s8_default() if s8 is None else s8
        s8_pv = _s8_pv_default() if s8_pv is None else s8_pv
        try:
            return flash_attention(q, k, v, scale=scale, s8=s8, s8_pv=s8_pv)
        except NotImplementedError:
            pass
    return sdpa_xla(q, k, v, scale=scale, bias=bias, softcap=softcap)


def sdpa_merged(q, k, v, scale: Optional[float] = None,
                impl: Optional[str] = None, s8: Optional[bool] = None,
                s8_pv: Optional[bool] = None, seq: Optional[SeqShard] = None):
    """Attention returning the head-merged layout [B, H, S, D] -> [B, S, H*D];
    on the flash path the kernel writes that layout directly (unless
    DIFFUSION_RS_TPU_ATTN_MERGED=0, or the shape needs the [B, H, S, D] path).
    ``seq``: q/k/v are this rank's rows of a sequence split over a process
    group; the flash path runs :func:`partitioned_flash` (the ring), the
    XLA path attends this rank's q rows over k/v gathered from the group
    (parallel/mesh.gather_rows). ``impl`` None takes the flash path unless
    DIFFUSION_RS_TPU_NO_FLASH is set."""
    if impl is None:
        impl = "xla" if _no_flash() else "flash"
    if impl == "flash":
        s8 = _s8_default() if s8 is None else s8
        s8_pv = _s8_pv_default() if s8_pv is None else s8_pv
        if seq is not None:
            return partitioned_flash(q, k, v, seq, scale, s8, s8_pv)
        if _merged_default():
            try:
                return flash_attention(q, k, v, scale=scale, out_seqmajor=True, s8=s8,
                                       s8_pv=s8_pv)
            except NotImplementedError:
                pass
        x = sdpa(q, k, v, scale=scale, impl="flash", s8=s8, s8_pv=s8_pv)
    else:
        if seq is not None:
            k = gather_rows(k, seq.group, seq.lens, dim=2)
            v = gather_rows(v, seq.group, seq.lens, dim=2)
        x = sdpa_xla(q, k, v, scale=scale)
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)
