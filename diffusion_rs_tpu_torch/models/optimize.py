"""Load-time layout transforms on FLUX and T5 param trees (port of
``models/optimize.py``).

* :func:`fuse_flux_qkv` fuses each attention stream's q/k/v projections
  into one ``qkv`` linear (and the single blocks' q/k/v/proj_mlp into
  ``qkv_mlp``), per selected stream;
* :func:`fuse_t5` fuses T5's self-attention q|k|v into ``qkv`` and the gated
  feed-forward's wi_0|wi_1 into ``wi01``;
* :func:`rope_halfsplit_permute` re-lays the q/k projection columns and the
  QK-norm scales into the half-split RoPE convention (per head, pair
  element 2i moves to i and 2i+1 to i + D/2).

Each is exact: a fused output is the columns of the separate outputs in the
same order as the JAX package's, and the permutation leaves attention
unchanged (q.k and RMS denominators are invariant under a shared permutation
of the head dim). The models detect the fused keys; ``FluxConfig.rope_fused``
switches FLUX to half-split RoPE.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.linear import Linear
from ..quant.qtensor import QuantizedTensor, concat_n, permute_n


def _fuse_linears(lins) -> Linear:
    """Concatenate linears along their output features; raises on mixed
    dense/quantized weights, runtime LoRA terms or mixed bias presence."""
    ws = [l.w for l in lins]
    if all(isinstance(w, QuantizedTensor) for w in ws):
        w = concat_n(ws)
    elif all(isinstance(w, torch.Tensor) for w in ws):
        w = torch.cat(ws, dim=-1)
    else:
        raise ValueError("cannot fuse mixed dense/quantized linears")
    if any(l.lora is not None for l in lins):
        # concatenating would drop the runtime low-rank terms silently
        raise ValueError("cannot fuse linears carrying runtime LoRA terms")
    bs = [l.b for l in lins]
    if all(b is not None for b in bs):
        b = torch.cat(bs, dim=-1)
    elif all(b is None for b in bs):
        b = None
    else:
        raise ValueError("cannot fuse linears with mixed bias presence")
    return Linear(w=w, b=b)


def fuse_t5(params: dict) -> dict:
    """Per block: self-attention q|k|v -> ``qkv`` and wi_0|wi_1 -> ``wi01``
    (models/t5.py detects the fused keys). Returns a new tree."""
    params = dict(params)
    blocks = dict(params["blocks"])
    attn = dict(blocks["attn"])
    if "q" in attn and "qkv" not in attn:
        attn["qkv"] = _fuse_linears([attn.pop("q"), attn.pop("k"), attn.pop("v")])
        blocks["attn"] = attn
    ff = dict(blocks["ff"])
    if "wi_0" in ff and "wi01" not in ff:
        ff["wi01"] = _fuse_linears([ff.pop("wi_0"), ff.pop("wi_1")])
        blocks["ff"] = ff
    params["blocks"] = blocks
    return params


def _head_halfsplit_perm(n_heads: int, head_dim: int) -> np.ndarray:
    """Per-head column permutation 2i -> i, 2i+1 -> i + D/2 (interleaved
    RoPE pairs -> half-split pairs). ``out[j] = old[perm[j]]``."""
    base = np.empty(head_dim, np.int64)
    base[: head_dim // 2] = np.arange(0, head_dim, 2)
    base[head_dim // 2:] = np.arange(1, head_dim, 2)
    return np.concatenate([h * head_dim + base for h in range(n_heads)])


def _permute_cols(lin: Linear, perm, lo: int, hi: int, width: int) -> Linear:
    """Permute output columns [lo, hi) of a (possibly fused, quantized or
    stacked) Linear by ``perm`` (relative to ``lo``); the others stay."""
    full = np.arange(width, dtype=np.int64)
    full[lo:hi] = lo + np.asarray(perm)
    w = lin.w
    quantized = isinstance(w, QuantizedTensor)
    idx = torch.as_tensor(full, device=w.packed.device if quantized else w.device)
    w = permute_n(w, full) if quantized else w[..., idx]
    b = None if lin.b is None else lin.b[..., idx]
    lora = lin.lora
    if lora is not None:
        a, bl = lora
        lora = (a, bl[..., idx])
    return Linear(w=w, b=b, lora=lora)


def rope_halfsplit_permute(params: dict, cfg) -> dict:
    """Re-lay the q/k projection columns (and QK-norm scales) of every block
    into the half-split RoPE convention. Run after qkv fusion; the models
    switch to half-split application when ``cfg.rope_fused`` is set.
    Returns a new tree."""
    heads = cfg.num_attention_heads
    d = cfg.hidden_size // heads
    h_total = cfg.hidden_size
    perm = _head_halfsplit_perm(heads, d)
    base = perm[:d]  # within-head permutation for the norm scales

    def norm_perm(scale):
        return scale[..., torch.as_tensor(base, device=scale.device)]

    def do_attn(attn: dict) -> dict:
        attn = dict(attn)
        if "qkv" in attn:  # fused q|k|v columns
            n = 3 * h_total
            w = _permute_cols(attn["qkv"], perm, 0, h_total, n)
            attn["qkv"] = _permute_cols(w, perm, h_total, 2 * h_total, n)
        else:
            attn["q"] = _permute_cols(attn["q"], perm, 0, h_total, h_total)
            attn["k"] = _permute_cols(attn["k"], perm, 0, h_total, h_total)
        attn["q_norm"] = norm_perm(attn["q_norm"])
        attn["k_norm"] = norm_perm(attn["k_norm"])
        return attn

    params = dict(params)
    double = dict(params["double"])
    double["img_attn"] = do_attn(double["img_attn"])
    double["txt_attn"] = do_attn(double["txt_attn"])
    params["double"] = double

    single = dict(params["single"])
    if "qkv_mlp" in single:
        w = single["qkv_mlp"]
        n = w.b.shape[-1] if w.b is not None else (
            w.w.n if isinstance(w.w, QuantizedTensor) else w.w.shape[-1])
        w = _permute_cols(w, perm, 0, h_total, n)
        single["qkv_mlp"] = _permute_cols(w, perm, h_total, 2 * h_total, n)
    else:
        single["q"] = _permute_cols(single["q"], perm, 0, h_total, h_total)
        single["k"] = _permute_cols(single["k"], perm, 0, h_total, h_total)
    single["q_norm"] = norm_perm(single["q_norm"])
    single["k_norm"] = norm_perm(single["k_norm"])
    params["single"] = single
    return params


def fuse_flux_qkv(params: dict, streams=("img", "txt", "single")) -> dict:
    """A new tree with fused projections in the selected streams of
    ("img", "txt", "single"): double blocks' img_attn/txt_attn get ``qkv``
    (q|k|v) in place of q, k, v; single blocks get ``qkv_mlp``
    (q|k|v|proj_mlp) in place of all four."""
    params = dict(params)

    def fuse_attn(attn: dict) -> dict:
        if "qkv" in attn or "q" not in attn:
            return attn
        attn = dict(attn)
        attn["qkv"] = _fuse_linears([attn.pop("q"), attn.pop("k"), attn.pop("v")])
        return attn

    double = dict(params["double"])
    if "img" in streams:
        double["img_attn"] = fuse_attn(double["img_attn"])
    if "txt" in streams:
        double["txt_attn"] = fuse_attn(double["txt_attn"])
    params["double"] = double

    if "single" in streams:
        single = dict(params["single"])
        if "qkv_mlp" not in single and "q" in single:
            single["qkv_mlp"] = _fuse_linears(
                [single.pop("q"), single.pop("k"), single.pop("v"), single.pop("proj_mlp")])
        params["single"] = single
    return params
