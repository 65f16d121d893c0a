"""In-situ quantization (ISQ): quantize dense weights at load time (port of
``diffusion_rs_tpu/quant/isq.py``).

The JAX package encodes on the host in numpy (GGML bytes, then the canonical
planes). The port quantizes on the weight's own device, layer by layer,
straight to the canonical planes (quant/gguf_quants.quantize_canonical,
quant/bnb.quantize_4bit_canonical, quant/qtensor.quantize_q8_tile_tensor),
with the same operations, so the codes and planes equal the JAX package's.
Nothing moves to the host but the importance vectors' group sums.

Importance-matrix (imatrix) weighting refines a quantized tensor by
alternating weighted least squares per scale group: fit (scale, bias) in
closed form under the importance weights, reassign the codes to the refit
grid (or the nearest codebook entry), repeat (:func:`refine_with_imatrix`).
"""

from __future__ import annotations

import os
from typing import Optional, Union

import numpy as np
import torch

from ..ops.linear import Linear
from ..util.tree import stack_layers
from .bnb import quantize_4bit_canonical
from .gguf_quants import quantize_canonical
from .qtensor import (
    QuantizedTensor,
    dequantize,
    pack4_tensor,
    quantize_q8_tile_tensor,
    unpack4,
)

# The reference's CUDA-legal ISQ types (Q4_0 ... Q6K), the bnb codebook
# formats and "q8t", the int8 execution format of the s8 x s8 kernel.
SUPPORTED = (
    "q4_0", "q4_1", "q5_0", "q5_1", "q8_0",
    "q2_k", "q3_k", "q4_k", "q5_k", "q6_k",
    "nf4", "fp4", "q8t",
)

# K (input features) must divide the format's block: 256-element k-quant
# super-blocks, 32 for the legacy formats, bnb blocksize 64.
_K_DIVISOR = {
    "q4_0": 32, "q4_1": 32, "q5_0": 32, "q5_1": 32, "q8_0": 32,
    "q2_k": 256, "q3_k": 256, "q4_k": 256, "q5_k": 256, "q6_k": 256,
    "nf4": 64, "fp4": 64, "q8t": 1,
}


def _codes_of(qt: QuantizedTensor) -> torch.Tensor:
    return (unpack4(qt.packed, qt.split) if qt.bits == 4 else qt.packed).to(torch.int32)


def refine_with_imatrix(qt: QuantizedTensor, w_kmajor: torch.Tensor, importance,
                        iters: int = 2) -> QuantizedTensor:
    """Refine ``qt`` (the quantized ``w_kmajor [K, N]``) to minimize the
    importance-weighted error ``sum_k imp[k] (w[k, n] - deq[k, n])^2`` per
    column, on the weight's device. ``importance`` is the length-K
    activation second moment from an imatrix file.

    Per scale group of each column: a weighted least-squares fit of
    (scale, bias) (scale alone for bias-less and codebook formats), then the
    codes reassigned against the refit grid (rounded and clipped, or the
    nearest codebook entry); ``iters`` fits, with a reassignment between
    two. The sums over a group run in numpy's order (one term after the
    other; the importance weights' own sums in numpy on the host), so the
    result matches the JAX package's to the last bit unless a code sits on
    a tie that another order breaks otherwise."""
    w = w_kmajor.float()
    dev = w.device
    k, n = qt.shape
    if tuple(w.shape) != (k, n):
        raise ValueError(f"weight {tuple(w.shape)} does not match {qt.shape}")
    imp = np.maximum(np.asarray(importance, np.float32).reshape(k), 1e-12)
    g = qt.group
    groups = k // g
    sw = torch.from_numpy(imp.reshape(groups, g, 1).sum(axis=1)).to(dev)  # [groups, 1]
    wt = torch.from_numpy(imp.reshape(groups, g)).to(dev)[:, :, None]
    cb = None if qt.codebook is None else qt.codebook.float().reshape(-1)
    q = _codes_of(qt).float().reshape(groups, g, n)
    y = w.reshape(groups, g, n)
    has_bias = qt.bias is not None
    lo, hi = (0, 15) if qt.bits == 4 else (-128, 127)
    scale = qt.scale.float().clone()
    bias = qt.bias.float().clone() if has_bias else None

    for it in range(iters):
        c = cb[q.long()] if cb is not None else q
        # group sums, term by term: sq = sum wt c, sqq = sum wt c c,
        # sqy = sum wt c y, sy = sum wt y
        wc = wt[:, 0] * c[:, 0]
        sq, sqq, sqy, sy = wc, wc * c[:, 0], wc * y[:, 0], wt[:, 0] * y[:, 0]
        for j in range(1, g):
            wc = wt[:, j] * c[:, j]
            sqq = sqq + wc * c[:, j]
            sqy = sqy + wc * y[:, j]
            if has_bias:
                sq = sq + wc
                sy = sy + wt[:, j] * y[:, j]
        one = torch.ones_like(sqq)
        if has_bias:
            denom = sw * sqq - sq * sq
            ok = denom.abs() > 1e-20
            s_new = torch.where(ok, (sw * sqy - sq * sy) / torch.where(ok, denom, one), scale)
            b_new = torch.where(ok, (sy - s_new * sq) / sw, bias)
            scale, bias = s_new, b_new
        else:
            ok = sqq > 1e-20
            scale = torch.where(ok, sqy / torch.where(ok, sqq, one), scale)
        del c, wc
        if it == iters - 1:
            break
        s_b = scale.reshape(groups, 1, n)
        safe = torch.where(s_b.abs() > 1e-20, s_b, torch.ones_like(s_b))
        ratio = (y - bias.reshape(groups, 1, n) if has_bias else y) / safe
        if cb is not None:  # nearest of the 16 entries, the first on a tie
            best = (ratio - cb[0]).abs()
            q = torch.zeros_like(ratio)
            for i in range(1, 16):
                d = (ratio - cb[i]).abs()
                closer = d < best
                best = torch.where(closer, d, best)
                q.masked_fill_(closer, float(i))
                del d, closer
            del best
        else:
            q = torch.clamp(torch.round(ratio), lo, hi)
        del ratio

    codes = q.reshape(k, n)
    packed = (pack4_tensor(codes.to(torch.uint8), qt.split) if qt.bits == 4
              else codes.to(torch.int8))
    return QuantizedTensor(packed=packed, scale=scale, bias=bias, codebook=qt.codebook,
                           kind=qt.kind, bits=qt.bits, group=qt.group, split=qt.split,
                           shape=qt.shape, out_dtype=qt.out_dtype)


def isq_quantize_weight(w_kmajor: Union[torch.Tensor, np.ndarray], target: str,
                        imatrix=None) -> QuantizedTensor:
    """Quantize a dense K-major ``[K, N]`` weight to ``target`` on its device.

    ``imatrix``: an optional length-K importance vector; with it the result
    is refined to minimize the importance-weighted error."""
    if target not in SUPPORTED:
        raise ValueError(f"ISQ target {target!r} not in {SUPPORTED}")
    w = torch.as_tensor(w_kmajor)
    if target in ("nf4", "fp4"):
        qt = quantize_4bit_canonical(w, target, blocksize=64)
    elif target == "q8t":
        qt = quantize_q8_tile_tensor(w)
    else:
        qt = quantize_canonical(w, target)
    if imatrix is not None:
        qt = refine_with_imatrix(qt, w, imatrix)
    return qt


def _imatrix_lookup(imatrix, names, layer: Optional[int], k: int):
    """The importance vector of a param path, or None (absent, or not of
    length K). Keys are dotted paths; stacked blocks use
    ``prefix.{layer}.rest`` (``double.3.img_attn.q``); a ``.weight`` suffix
    is accepted (llama.cpp names carry it)."""
    if not imatrix:
        return None
    dotted = ".".join(names)
    cands = [dotted, dotted + ".weight"]
    if layer is not None:
        per_layer = ".".join(names[:1] + [str(layer)] + names[1:])
        cands = [per_layer, per_layer + ".weight"] + cands
    for c in cands:
        v = imatrix.get(c)
        if v is not None and np.asarray(v).size == k:
            return np.asarray(v, np.float32)
    return None


def isq_tree(params, target: str, min_features: Optional[int] = None, imatrix=None):
    """Quantize every dense Linear of a param tree whose weight is at least
    ``min_features`` on both dims and whose K the format's block divides
    (embedders and norms stay dense). ``min_features`` defaults to
    DIFFUSION_RS_TPU_ISQ_MIN, else 512, read when called.

    A Linear already quantized in another format is requantized from its
    f32 dequantization; one already in ``target`` is left as it is.
    Stacked ``[L, K, N]`` weights are quantized layer by layer into stacked
    planes. ``imatrix`` maps dotted param paths to importance vectors
    (io/imatrix.load_imatrix). Returns a new tree; Linears it does not
    quantize are the input's own objects, and the input keeps its tensors."""
    if min_features is None:
        min_features = int(os.environ.get("DIFFUSION_RS_TPU_ISQ_MIN", "512"))
    divisor = _K_DIVISOR.get(target, 256)

    def quantize(layer_w, stack: Optional[int], device, names, k, b):
        if stack is None:
            imp = _imatrix_lookup(imatrix, names, None, k)
            return Linear(w=isq_quantize_weight(layer_w(None), target, imatrix=imp), b=b)
        stacked = stack_layers(
            lambda i: isq_quantize_weight(layer_w(i), target,
                                          imatrix=_imatrix_lookup(imatrix, names, i, k)),
            stack, device)
        return Linear(w=stacked, b=b)

    def visit(node: Linear, names):
        w = node.w
        if isinstance(w, torch.Tensor) and w.dim() >= 2:
            k, n = w.shape[-2], w.shape[-1]
            if k >= min_features and n >= min_features and k % divisor == 0:
                stack = w.shape[0] if w.dim() == 3 else None
                return quantize(lambda i: w if i is None else w[i], stack, w.device, names, k,
                                node.b)
        elif isinstance(w, QuantizedTensor) and w.kind != target:
            # a pre-quantized weight of another format: requantize from its
            # f32 dequantization, one layer at a time
            k, n = w.shape
            if k >= min_features and n >= min_features and k % divisor == 0:
                stack = w.packed.shape[0] if w.packed.dim() == 3 else None

                def layer_w(i):
                    qt = w if i is None else w.map(lambda t: t[i])
                    return dequantize(qt, torch.float32)

                return quantize(layer_w, stack, w.packed.device, names, k, node.b)
        return node

    def walk(node, names):
        if isinstance(node, Linear):
            return visit(node, [x for x in names if x and x != "w"])
        if isinstance(node, dict):
            return {key: walk(v, names + [str(key)]) for key, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, names + [str(i)]) for i, v in enumerate(node))
        return node

    return walk(params, [])
