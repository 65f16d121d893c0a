"""CLIP-L text encoder (port of ``models/clip.py``): token + position
embeddings, pre-LayerNorm blocks with a causal additive mask and f32
attention, quick-gelu MLP, EOS pooling at argmax(token id)."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from ..ops import layer_norm, linear, sdpa
from ..util.tree import take_layer

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ClipTextConfig:
    vocab_size: int = 49408
    projection_dim: int = 768
    intermediate_size: int = 3072
    max_position_embeddings: int = 77
    num_hidden_layers: int = 12
    num_attention_heads: int = 12

    @staticmethod
    def from_json(d: dict) -> "ClipTextConfig":
        """text_encoder/config.json (transformers CLIPTextModel)."""
        return ClipTextConfig(
            vocab_size=d["vocab_size"],
            projection_dim=d.get("hidden_size", d.get("projection_dim", 768)),
            intermediate_size=d["intermediate_size"],
            max_position_embeddings=d["max_position_embeddings"],
            num_hidden_layers=d["num_hidden_layers"],
            num_attention_heads=d["num_attention_heads"],
        )

    @property
    def head_dim(self) -> int:
        return self.projection_dim // self.num_attention_heads


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def causal_mask(seq_len: int, device="cpu") -> torch.Tensor:
    """Additive [1, 1, S, S] mask: 0 on/below the diagonal, -3.4e38 above."""
    i = torch.arange(seq_len, device=device)[:, None]
    j = torch.arange(seq_len, device=device)[None, :]
    zero = torch.zeros((), dtype=torch.float32, device=device)
    neg = torch.full((), -3.4e38, dtype=torch.float32, device=device)
    return torch.where(j > i, neg, zero)[None, None]


def clip_block(bp: Params, x: torch.Tensor, mask: torch.Tensor, cfg: ClipTextConfig):
    b, s, _ = x.shape
    h, hd = cfg.num_attention_heads, cfg.head_dim

    def split(t):
        return t.reshape(b, s, h, hd).transpose(1, 2)

    res = x
    y = layer_norm(x, bp["ln1"]["w"], bp["ln1"]["b"], eps=1e-5)
    q = split(linear(y, bp["attn"]["q"]))
    k = split(linear(y, bp["attn"]["k"]))
    v = split(linear(y, bp["attn"]["v"]))
    attn = sdpa(q, k, v, bias=mask, impl="xla")
    attn = attn.transpose(1, 2).reshape(b, s, h * hd)
    x = res + linear(attn, bp["attn"]["out"])

    res = x
    y = layer_norm(x, bp["ln2"]["w"], bp["ln2"]["b"], eps=1e-5)
    y = linear(quick_gelu(linear(y, bp["mlp"]["fc1"])), bp["mlp"]["fc2"])
    return res + y


def clip_encode(params: Params, cfg: ClipTextConfig,
                input_ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (hidden [B, S, D], pooled [B, D]); pooled is the final-LN
    hidden state at argmax(input_ids) (the EOS token has the largest id)."""
    b, s = input_ids.shape
    ids = input_ids.long()
    x = params["token_emb"][ids] + params["pos_emb"][:s]
    mask = causal_mask(s, device=x.device)
    for i in range(cfg.num_hidden_layers):
        x = clip_block(take_layer(params["blocks"], i), x, mask, cfg)
    x = layer_norm(x, params["final_ln"]["w"], params["final_ln"]["b"], eps=1e-5)
    eos_idx = torch.argmax(ids, dim=-1)
    pooled = x[torch.arange(b, device=x.device), eos_idx]
    return x, pooled
