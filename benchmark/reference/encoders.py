"""The text encoders in plain PyTorch: T5-XXL v1.1's encoder (RMS norms,
unscaled attention with the bidirectional relative-position bucket bias of
block 0, gated GELU-tanh feed-forward; pad tokens attended, as the published
encoder runs them without a mask), in the precision the configuration
states for it, and CLIP-L's text tower (pre-LayerNorm blocks with a causal
mask, quick GELU, pooled at the largest token id) in float32."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .common import Precision, attention, dequant, layer_norm, linear


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
    """ids [B, S] -> [B, S, d_model], in the precision the configuration
    states for the encoder: every activation rounded to its activation dtype
    where a bfloat16 encoder keeps one (each norm's output, each product's
    output, the residual stream), each nf4 weight decoded to that dtype (as
    bitsandbytes' nf4 linear decodes it before the product), products,
    attention scores and softmax in float32. Unscaled attention over seeded
    planes reaches scores of several hundred, so that which key wins depends
    on the last bits of q and k: a float32 encoder is then another function
    than the stated one, and flips whole rows of its output against it."""
    t = cfg["text_encoder_2"]
    act = getattr(torch, cfg["formats"]["activations"])
    eps = t.get("layer_norm_epsilon", 1e-6)
    b, s = ids.shape
    h, dk = t["num_heads"], t["d_kv"]
    x = p["shared"][ids].float()
    bias = p["rel_bias"].float()[t5_buckets(s, t["relative_attention_num_buckets"],
                                            t["relative_attention_max_distance"],
                                            ids.device)].permute(2, 0, 1)[None]
    blk = p["blocks"]

    def r(z):
        """A value as the configuration keeps it (and as the control keeps it)."""
        return prec.store(z.to(act).float())

    def norm(z, w):
        z = z * (1.0 / torch.sqrt(z.square().mean(-1, keepdim=True) + eps))
        return r(r(z) * w.float())

    def lin(z, name, i):
        w = blk[name[0]][name[1]].w
        return r(prec.product_in(z) @ dequant(w, i).to(act).float())

    def split(z):
        return z.view(b, s, h, dk).transpose(1, 2)

    for i in range(t["num_layers"]):
        n = norm(x, blk["attn_norm"][i])
        q, k, v = (split(lin(n, ("attn", c), i)) for c in "qkv")
        sc = torch.einsum("bhsd,bhtd->bhst", prec.product_in(q), prec.product_in(k)) + bias
        a = r(torch.einsum("bhst,bhtd->bhsd", prec.product_in(torch.softmax(sc, dim=-1)),
                           prec.product_in(v)))
        x = r(x + lin(a.transpose(1, 2).reshape(b, s, h * dk), ("attn", "o"), i))
        n = norm(x, blk["ff_norm"][i])
        gate = r(F.gelu(lin(n, ("ff", "wi_0"), i), approximate="tanh"))
        x = r(x + lin(r(gate * lin(n, ("ff", "wi_1"), i)), ("ff", "wo"), i))
    return norm(x, p["final_norm"])


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
