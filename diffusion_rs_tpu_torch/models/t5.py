"""T5 encoder (port of ``models/t5.py``): RMS-style layer norms with f32
variance, gated gelu_new feed-forward, relative-position-bucket bias built
once from the block-0 embedding, unscaled attention scores in f32, and the
f16 overflow clamp. Blocks take separate q/k/v and wi_0/wi_1 projections or
the fused ``qkv`` / ``wi01`` ones of models/optimize.fuse_t5.

Under ``tp`` (a rank's cut tree, parallel/sharding.py) each rank attends
with its own heads (``num_heads / tp``) and their columns of the position
bias; ``o`` and ``wo`` are row-parallel. ``wi01``, whole on every rank as
in the JAX package, gives every rank the whole ``gate * up``, which ``wo``
cuts to its rows (ops/linear.linear)."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
import torch.nn.functional as F

from ..ops import linear, rms_norm, sdpa
from ..ops.linear import tp_size
from ..util.tree import take_layer

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 4096
    d_kv: int = 64
    d_ff: int = 10240
    num_layers: int = 24
    num_heads: int = 64
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    gated_act: bool = True
    act: str = "gelu_new"  # "gelu_new" | "relu" | "silu"

    @staticmethod
    def from_json(d: dict) -> "T5Config":
        """text_encoder_2/config.json (transformers T5EncoderModel)."""
        ff = d.get("feed_forward_proj", "relu")
        act = ff.removeprefix("gated-")
        act = {"gelu": "gelu_new", "gelu_new": "gelu_new", "relu": "relu",
               "silu": "silu", "gelu_pytorch_tanh": "gelu_new"}.get(act, act)
        return T5Config(
            vocab_size=d["vocab_size"],
            d_model=d["d_model"],
            d_kv=d["d_kv"],
            d_ff=d["d_ff"],
            num_layers=d["num_layers"],
            num_heads=d["num_heads"],
            relative_attention_num_buckets=d["relative_attention_num_buckets"],
            relative_attention_max_distance=d.get("relative_attention_max_distance", 128),
            layer_norm_epsilon=d.get("layer_norm_epsilon", 1e-6),
            gated_act=ff.startswith("gated-") or d.get("is_gated_act", False),
            act=act,
        )


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "gelu_new":
        return F.gelu(x, approximate="tanh")
    if name == "relu":
        return F.relu(x)
    if name == "silu":
        return F.silu(x)
    raise ValueError(f"unknown activation {name}")


def relative_position_buckets(q_len: int, kv_len: int, num_buckets: int,
                              max_distance: int, device="cpu") -> torch.Tensor:
    """Bidirectional bucket table [q_len, kv_len] int32: half the buckets for
    j > i, log-spaced beyond max_exact."""
    ctx = torch.arange(q_len, dtype=torch.int32, device=device)[:, None]
    mem = torch.arange(kv_len, dtype=torch.int32, device=device)[None, :]
    rel = mem - ctx
    nb = num_buckets // 2
    base = torch.where(rel > 0, nb, 0)
    n = rel.abs()
    max_exact = nb // 2
    is_small = n < max_exact
    log_range = torch.log(torch.tensor(max_distance / max_exact,
                                       dtype=torch.float32, device=device))
    log_big = max_exact + (
        torch.log(n.float() / max_exact) / log_range * (nb - max_exact)
    ).to(torch.int32)
    big = torch.minimum(log_big, torch.tensor(nb - 1, dtype=torch.int32, device=device))
    return (base + torch.where(is_small, n, big)).to(torch.int32)


def position_bias(p: Params, cfg: T5Config, q_len: int, kv_len: int) -> torch.Tensor:
    """[1, H, q_len, kv_len] additive bias from the block-0 embedding."""
    buckets = relative_position_buckets(
        q_len, kv_len, cfg.relative_attention_num_buckets,
        cfg.relative_attention_max_distance, device=p["rel_bias"].device,
    )
    return p["rel_bias"][buckets.long()].permute(2, 0, 1)[None]


def _clamp_f16(x: torch.Tensor) -> torch.Tensor:
    """f16 overflow guard; bf16/f32 pass through untouched."""
    if x.dtype == torch.float16:
        lim = 64504.0
        return torch.clamp(x, -lim, lim)
    return x


def t5_block(bp: Params, x: torch.Tensor, bias: torch.Tensor, cfg: T5Config):
    b, s, _ = x.shape
    h, dk = cfg.num_heads // tp_size(bp["attn"]["o"]), cfg.d_kv  # this rank's heads

    def split(t):
        return t.reshape(b, s, h, dk).transpose(1, 2)

    normed = rms_norm(x, bp["attn_norm"], cfg.layer_norm_epsilon)
    if "qkv" in bp["attn"]:  # fused q|k|v (models/optimize.fuse_t5)
        q, k, v = (split(t) for t in torch.chunk(linear(normed, bp["attn"]["qkv"]), 3, dim=-1))
    else:
        q = split(linear(normed, bp["attn"]["q"]))
        k = split(linear(normed, bp["attn"]["k"]))
        v = split(linear(normed, bp["attn"]["v"]))
    # T5 attention scores are unscaled (the 1/sqrt(d) is folded into weights).
    attn = sdpa(q, k, v, scale=1.0, bias=bias, impl="xla")
    attn = attn.transpose(1, 2).reshape(b, s, h * dk)
    x = _clamp_f16(x + linear(attn, bp["attn"]["o"]))

    normed = rms_norm(x, bp["ff_norm"], cfg.layer_norm_epsilon)
    if cfg.gated_act:
        if "wi01" in bp["ff"]:  # fused wi_0|wi_1
            gate, up = torch.chunk(linear(normed, bp["ff"]["wi01"]), 2, dim=-1)
            gate = _act(cfg.act, gate)
        else:
            gate = _act(cfg.act, linear(normed, bp["ff"]["wi_0"]))
            up = linear(normed, bp["ff"]["wi_1"])
        ff = linear(gate * up, bp["ff"]["wo"])
    else:
        ff = linear(_act(cfg.act, linear(normed, bp["ff"]["wi"])), bp["ff"]["wo"])
    return _clamp_f16(x + ff)


def t5_encode(params: Params, cfg: T5Config, input_ids: torch.Tensor,
              mask_pads: bool = False) -> torch.Tensor:
    """Embed -> blocks -> final RMSNorm. ``mask_pads`` masks pad keys (id 0)
    out of attention; the default leaves them attended, like the reference."""
    x = params["shared"][input_ids.long()]
    s = x.shape[1]
    bias = position_bias(params, cfg, s, s).float()
    tp = params["blocks"]["attn"]["o"].tp
    if tp is not None:  # this rank's heads' columns
        n = cfg.num_heads // tp.size
        bias = bias[:, tp.rank * n:(tp.rank + 1) * n]
    if mask_pads:
        key_is_pad = (input_ids == 0)[:, None, None, :]
        bias = bias + torch.where(key_is_pad, -1e9, 0.0).float()
    for i in range(cfg.num_layers):
        x = t5_block(take_layer(params["blocks"], i), x, bias, cfg)
    return rms_norm(x, params["final_norm"], cfg.layer_norm_epsilon)
