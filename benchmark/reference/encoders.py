"""The text encoders in plain float32: T5-XXL v1.1's encoder (RMS norms,
unscaled attention with the bidirectional relative-position bucket bias of
block 0, gated GELU-tanh feed-forward; pad tokens attended, as the published
encoder runs them without a mask) and CLIP-L's text tower (pre-LayerNorm
blocks with a causal mask, quick GELU, pooled at the largest token id)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .common import Precision, attention, layer_norm, linear, rms_norm


def t5_buckets(n: int, num_buckets: int, max_distance: int, device) -> torch.Tensor:
    ctx = torch.arange(n, device=device)[:, None]
    mem = torch.arange(n, device=device)[None, :]
    rel = mem - ctx
    nb = num_buckets // 2
    out = (rel > 0).long() * nb
    a = rel.abs()
    max_exact = nb // 2
    large = max_exact + (torch.log(a.float().clamp_min(1) / max_exact)
                         / math.log(max_distance / max_exact) * (nb - max_exact)).long()
    large = large.clamp_max(nb - 1)
    return out + torch.where(a < max_exact, a, large)


def t5_encode(cfg: dict, p: dict, ids: torch.Tensor, prec: Precision) -> torch.Tensor:
    """ids [B, S] -> [B, S, d_model]."""
    t = cfg["text_encoder_2"]
    eps = t.get("layer_norm_epsilon", 1e-6)
    b, s = ids.shape
    h, dk = t["num_heads"], t["d_kv"]
    st = prec.store
    x = p["shared"][ids].float()
    bias = p["rel_bias"].float()[t5_buckets(s, t["relative_attention_num_buckets"],
                                            t["relative_attention_max_distance"],
                                            ids.device)].permute(2, 0, 1)[None]
    blk = p["blocks"]

    def split(z):
        return z.view(b, s, h, dk).transpose(1, 2)

    for i in range(t["num_layers"]):
        n = st(rms_norm(x, blk["attn_norm"][i], eps))
        a = attention(split(linear(n, blk["attn"]["q"], prec, i)),
                      split(linear(n, blk["attn"]["k"], prec, i)),
                      split(linear(n, blk["attn"]["v"], prec, i)), prec, scale=1.0, bias=bias)
        x = st(x + linear(a.transpose(1, 2).reshape(b, s, h * dk), blk["attn"]["o"], prec, i))
        n = st(rms_norm(x, blk["ff_norm"][i], eps))
        gate = st(F.gelu(linear(n, blk["ff"]["wi_0"], prec, i), approximate="tanh"))
        x = st(x + linear(st(gate * linear(n, blk["ff"]["wi_1"], prec, i)), blk["ff"]["wo"],
                          prec, i))
    return st(rms_norm(x, p["final_norm"], eps))


def clip_pooled(cfg: dict, p: dict, ids: torch.Tensor, prec: Precision) -> torch.Tensor:
    """ids [B, S] -> the pooled output [B, hidden] at argmax(id)."""
    c = cfg["text_encoder"]
    b, s = ids.shape
    h = c["num_attention_heads"]
    dk = c["hidden_size"] // h
    st = prec.store
    x = st(p["token_emb"][ids].float() + p["pos_emb"][:s].float())
    mask = torch.full((s, s), float("-inf"), device=ids.device).triu(1)[None, None]
    blk = p["blocks"]

    def split(z):
        return z.view(b, s, h, dk).transpose(1, 2)

    for i in range(c["num_hidden_layers"]):
        n = st(layer_norm(x, blk["ln1"]["w"][i], blk["ln1"]["b"][i], 1e-5))
        a = attention(split(linear(n, blk["attn"]["q"], prec, i)),
                      split(linear(n, blk["attn"]["k"], prec, i)),
                      split(linear(n, blk["attn"]["v"], prec, i)), prec, bias=mask)
        x = st(x + linear(a.transpose(1, 2).reshape(b, s, h * dk), blk["attn"]["out"], prec, i))
        n = st(layer_norm(x, blk["ln2"]["w"][i], blk["ln2"]["b"][i], 1e-5))
        f = linear(n, blk["mlp"]["fc1"], prec, i)
        x = st(x + linear(st(f * torch.sigmoid(1.702 * f)), blk["mlp"]["fc2"], prec, i))
    x = st(layer_norm(x, p["final_ln"]["w"], p["final_ln"]["b"], 1e-5))
    return x[torch.arange(b, device=ids.device), ids.argmax(-1)]
