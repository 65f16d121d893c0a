"""Scaled dot-product attention, port of ``ops/attention.py``.

``sdpa_xla`` is the f32 reference (einsum, softmax, einsum) with optional
additive bias and tanh softcap; T5, CLIP and the VAE call it directly
(``impl="xla"``). ``sdpa`` / ``sdpa_merged`` dispatch the unbiased case to
the flash kernel (ops/flash.py), which is what FLUX joint attention reaches.
The JAX package's int8 attention modes are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from .flash import flash_attention


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


def sdpa(q, k, v, scale: Optional[float] = None, bias=None,
         softcap: Optional[float] = None, impl: Optional[str] = None):
    """``impl`` in {None (auto), "flash", "xla"}: auto takes the flash
    kernel unless a bias or softcap is given."""
    if impl is None:
        impl = "flash" if bias is None and softcap is None else "xla"
    if impl == "flash":
        return flash_attention(q, k, v, scale=scale)
    return sdpa_xla(q, k, v, scale=scale, bias=bias, softcap=softcap)


def sdpa_merged(q, k, v, scale: Optional[float] = None,
                impl: Optional[str] = None):
    """Attention returning the head-merged layout [B, H, S, D] -> [B, S, H*D];
    on the flash path the kernel writes that layout directly."""
    if impl in (None, "flash"):
        return flash_attention(q, k, v, scale=scale, out_seqmajor=True)
    x = sdpa_xla(q, k, v, scale=scale)
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)
