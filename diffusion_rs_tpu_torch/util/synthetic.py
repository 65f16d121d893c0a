"""Synthetic weights at real shapes (random values, made from a seed).

Every tensor is drawn on the target device from a seeded
``torch.Generator``, so a full-size FLUX q8t checkpoint (~12 GB of int8
planes) is made on the card in seconds with no host pool. The layouts and
value scales follow the JAX package's ``util/synthetic.py`` and the dense
``init_*_params`` factories of its models; the values themselves differ
(another generator).
"""

from __future__ import annotations

import zlib
from typing import Optional

import torch

from ..models.clip import ClipTextConfig
from ..models.flux import FluxConfig
from ..models.t5 import T5Config
from ..models.vae import VAEConfig
from ..ops.conv import Conv
from ..ops.linear import Linear
from ..quant.bnb import NF4_CODEBOOK
from ..quant.qtensor import QuantizedTensor, choose_split
from .device import resolve_device


def _gen(seed: int, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def _gguf_scales(gen, shape, base: float, device) -> torch.Tensor:
    """Per-group scales around ``base``, rounded through f16 as GGUF stores
    its block scales."""
    u = torch.rand(shape, generator=gen, dtype=torch.float32, device=device)
    return (base * (0.5 + u)).half().float()


def random_qtensor(gen: torch.Generator, k: int, n: int, kind: str = "nf4",
                   group: int = 64, stack: Optional[int] = None,
                   device="cuda") -> QuantizedTensor:
    """Random quantized ``[K, N]`` weight (optionally stacked ``[L, K, N]``)
    whose dequantized values have ~1/sqrt(K) scale. ``kind`` is "q8t"
    (int8, one scale per K-tile), "q8_0" / "q4_0" (GGUF's 32-wide groups:
    int8 codes, or unsigned 4-bit codes with bias = -8 * scale; f16-rounded
    scales that differ per group) or a 4-bit codebook kind ("nf4")."""
    device = resolve_device(device)
    split = choose_split(k)
    lead = () if stack is None else (stack,)
    if kind in ("q8_0", "q4_0"):
        if k % 32:
            raise ValueError(f"{kind} needs K % 32 == 0, got K={k}")
        shape = lead + (k // 32, n)
        if kind == "q8_0":
            packed = torch.randint(-128, 128, lead + (k, n), generator=gen,
                                   dtype=torch.int8, device=device)
            scale = _gguf_scales(gen, shape, 2.0 * k ** -0.5 / 127.0, device)
            bias, bits = None, 8
        else:
            packed = torch.randint(0, 256, lead + (k // 2, n), generator=gen,
                                   dtype=torch.uint8, device=device)
            scale = _gguf_scales(gen, shape, 2.0 * k ** -0.5 / 8.0, device)
            bias, bits = scale * -8.0, 4
        return QuantizedTensor(packed=packed, scale=scale, bias=bias, codebook=None,
                               kind=kind, bits=bits, group=32, split=split,
                               shape=(k, n), out_dtype="bfloat16")
    if kind == "q8t":
        g = min(256, k)
        while k % g:
            g //= 2
        packed = torch.randint(-128, 128, lead + (k, n), generator=gen,
                               dtype=torch.int8, device=device)
        scale = torch.full(lead + (k // g, n), 2.0 * k ** -0.5 / 127.0,
                           dtype=torch.float32, device=device)
        return QuantizedTensor(packed=packed, scale=scale, bias=None,
                               codebook=None, kind="q8t", bits=8, group=g,
                               split=split, shape=(k, n), out_dtype="bfloat16")
    packed = torch.randint(0, 256, lead + (k // 2, n), generator=gen,
                           dtype=torch.uint8, device=device)
    scale = torch.full(lead + (k // group, n), 2.0 * k ** -0.5,
                       dtype=torch.float32, device=device)
    cb = torch.as_tensor(NF4_CODEBOOK, device=device)
    if stack is not None:
        cb = cb[None].repeat(stack, 1)
    return QuantizedTensor(packed=packed, scale=scale, bias=None, codebook=cb,
                           kind=kind, bits=4, group=group, split=split,
                           shape=(k, n), out_dtype="bfloat16")


def _normal(gen, shape, std, dtype, device):
    return (torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device) * std).to(dtype)


def _dense_linear(gen, k_in: int, n_out: int, dtype, device, stack=None,
                  bias: bool = True) -> Linear:
    """A dense Linear ``[K, N]`` (or stacked ``[L, K, N]``) with normal
    weights of std 1/sqrt(K), drawn one layer at a time (no f32 copy of the
    whole stack), and a zero bias."""
    w = torch.empty(((stack,) if stack else ()) + (k_in, n_out), dtype=dtype, device=device)
    for i in range(stack or 1):
        dst = w[i] if stack else w
        dst.copy_(torch.randn((k_in, n_out), generator=gen, dtype=torch.float32,
                              device=device) * k_in ** -0.5)
    b = None
    if bias:
        b = torch.zeros(((stack,) if stack else ()) + (n_out,), dtype=dtype, device=device)
    return Linear(w=w, b=b)


def init_flux_params(seed: int, cfg: FluxConfig, dtype=torch.bfloat16, device="cuda"):
    """Dense FLUX params with the tree schema of the JAX package's
    ``init_flux_params`` (models/flux.py) and of a dense checkpoint's load:
    separate q/k/v projections, stacked [L, ...] blocks, normal weights of
    std 1/sqrt(K), zero biases, QK-norm scales ones. Made on ``device``."""
    device = resolve_device(device)
    gen = _gen(seed, device)
    h, m, hd = cfg.hidden_size, cfg.mlp_size, cfg.head_dim
    L, S = cfg.num_layers, cfg.num_single_layers

    def lin(k_in, n_out, stack=None):
        return _dense_linear(gen, k_in, n_out, dtype, device, stack)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    def attn(stack):
        return {"q": lin(h, h, stack), "k": lin(h, h, stack), "v": lin(h, h, stack),
                "proj": lin(h, h, stack), "q_norm": ones(stack, hd), "k_norm": ones(stack, hd)}

    params = {
        "img_in": lin(cfg.in_channels, h),
        "txt_in": lin(cfg.joint_attention_dim, h),
        "time_in": {"in": lin(256, h), "out": lin(h, h)},
        "vector_in": {"in": lin(cfg.pooled_projection_dim, h), "out": lin(h, h)},
        "double": {
            "img_mod": lin(h, 6 * h, L),
            "txt_mod": lin(h, 6 * h, L),
            "img_attn": attn(L),
            "txt_attn": attn(L),
            "img_mlp": {"in": lin(h, m, L), "out": lin(m, h, L)},
            "txt_mlp": {"in": lin(h, m, L), "out": lin(m, h, L)},
        },
        "single": {
            "q": lin(h, h, S), "k": lin(h, h, S), "v": lin(h, h, S),
            "q_norm": ones(S, hd), "k_norm": ones(S, hd),
            "proj_mlp": lin(h, m, S),
            "linear2": lin(h + m, h, S),
            "mod": lin(h, 3 * h, S),
        },
        "final": {"mod": lin(h, 2 * h), "proj": lin(h, cfg.in_channels)},
    }
    if cfg.guidance_embeds:
        params["guidance_in"] = {"in": lin(256, h), "out": lin(h, h)}
    return params


def init_t5_params(seed: int, cfg: T5Config, dtype=torch.bfloat16, device="cuda"):
    """Dense T5 encoder params with the tree schema of the JAX package's
    ``init_t5_params`` (models/t5.py): stacked bias-free block linears of
    std 1/sqrt(K), unit-normal embedding and relative-position bias, norm
    scales ones. Made on ``device``."""
    device = resolve_device(device)
    gen = _gen(seed, device)
    L = cfg.num_layers
    inner = cfg.num_heads * cfg.d_kv

    def lin(k_in, n_out):
        return _dense_linear(gen, k_in, n_out, dtype, device, stack=L, bias=False)

    ff = ({"wi_0": lin(cfg.d_model, cfg.d_ff), "wi_1": lin(cfg.d_model, cfg.d_ff),
           "wo": lin(cfg.d_ff, cfg.d_model)}
          if cfg.gated_act
          else {"wi": lin(cfg.d_model, cfg.d_ff), "wo": lin(cfg.d_ff, cfg.d_model)})
    return {
        "shared": _normal(gen, (cfg.vocab_size, cfg.d_model), 1.0, dtype, device),
        "rel_bias": _normal(gen, (cfg.relative_attention_num_buckets, cfg.num_heads), 1.0,
                            dtype, device),
        "blocks": {
            "attn": {"q": lin(cfg.d_model, inner), "k": lin(cfg.d_model, inner),
                     "v": lin(cfg.d_model, inner), "o": lin(inner, cfg.d_model)},
            "attn_norm": torch.ones((L, cfg.d_model), dtype=dtype, device=device),
            "ff": ff,
            "ff_norm": torch.ones((L, cfg.d_model), dtype=dtype, device=device),
        },
        "final_norm": torch.ones((cfg.d_model,), dtype=dtype, device=device),
    }


def init_flux_params_quantized(seed: int, cfg: FluxConfig, dtype=torch.bfloat16,
                               kind: str = "q8t", device="cuda",
                               layout: str = "diffusers"):
    """FLUX params with every linear quantized; norm scales ones, biases zeros.

    ``layout="diffusers"`` gives separate q/k/v (and proj_mlp) projections;
    ``layout="bfl"`` gives the fused tree a BFL checkpoint loads into
    (io/builders.py): ``qkv`` [H, 3H] in both attention streams and the
    single blocks' ``qkv_mlp`` [H, 3H + mlp]."""
    if layout not in ("diffusers", "bfl"):
        raise ValueError(f"layout must be 'diffusers' or 'bfl', got {layout!r}")
    device = resolve_device(device)
    gen = _gen(seed, device)
    h, m, hd = cfg.hidden_size, cfg.mlp_size, cfg.head_dim

    def qlin(k_in, n_out, stack=None):
        b = torch.zeros((n_out,) if stack is None else (stack, n_out),
                        dtype=dtype, device=device)
        return Linear(w=random_qtensor(gen, k_in, n_out, kind=kind, stack=stack,
                                       device=device), b=b)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    def attn(stack):
        proj = ({"qkv": qlin(h, 3 * h, stack)} if layout == "bfl" else
                {"q": qlin(h, h, stack), "k": qlin(h, h, stack), "v": qlin(h, h, stack)})
        return {**proj, "proj": qlin(h, h, stack),
                "q_norm": ones(stack, hd), "k_norm": ones(stack, hd)}

    L, S = cfg.num_layers, cfg.num_single_layers

    def single_proj():
        if layout == "bfl":
            return {"qkv_mlp": qlin(h, 3 * h + m, S)}
        return {"q": qlin(h, h, S), "k": qlin(h, h, S), "v": qlin(h, h, S),
                "proj_mlp": qlin(h, m, S)}

    params = {
        "img_in": qlin(cfg.in_channels, h),
        "txt_in": qlin(cfg.joint_attention_dim, h),
        "time_in": {"in": qlin(256, h), "out": qlin(h, h)},
        "vector_in": {"in": qlin(cfg.pooled_projection_dim, h), "out": qlin(h, h)},
        "double": {
            "img_mod": qlin(h, 6 * h, L),
            "txt_mod": qlin(h, 6 * h, L),
            "img_attn": attn(L),
            "txt_attn": attn(L),
            "img_mlp": {"in": qlin(h, m, L), "out": qlin(m, h, L)},
            "txt_mlp": {"in": qlin(h, m, L), "out": qlin(m, h, L)},
        },
        "single": {
            **single_proj(),
            "q_norm": ones(S, hd), "k_norm": ones(S, hd),
            "linear2": qlin(h + m, h, S),
            "mod": qlin(h, 3 * h, S),
        },
        "final": {"mod": qlin(h, 2 * h), "proj": qlin(h, cfg.in_channels)},
    }
    if cfg.guidance_embeds:
        params["guidance_in"] = {"in": qlin(256, h), "out": qlin(h, h)}
    return params


def init_t5_params_quantized(seed: int, cfg: T5Config, dtype=torch.bfloat16,
                             kind: str = "nf4", device="cuda"):
    """T5 encoder params with every block linear quantized; embedding,
    relative-position bias and norms dense."""
    device = resolve_device(device)
    gen = _gen(seed, device)
    L = cfg.num_layers
    inner = cfg.num_heads * cfg.d_kv

    def qlin(k_in, n_out):
        return Linear(w=random_qtensor(gen, k_in, n_out, kind=kind, stack=L,
                                       device=device))

    ff = (
        {"wi_0": qlin(cfg.d_model, cfg.d_ff), "wi_1": qlin(cfg.d_model, cfg.d_ff),
         "wo": qlin(cfg.d_ff, cfg.d_model)}
        if cfg.gated_act
        else {"wi": qlin(cfg.d_model, cfg.d_ff), "wo": qlin(cfg.d_ff, cfg.d_model)}
    )
    ones = torch.ones((L, cfg.d_model), dtype=dtype, device=device)
    return {
        "shared": _normal(gen, (cfg.vocab_size, cfg.d_model), cfg.d_model ** -0.5,
                          dtype, device),
        "rel_bias": _normal(gen, (cfg.relative_attention_num_buckets, cfg.num_heads),
                            1.0, dtype, device),
        "blocks": {
            "attn": {"q": qlin(cfg.d_model, inner), "k": qlin(cfg.d_model, inner),
                     "v": qlin(cfg.d_model, inner), "o": qlin(inner, cfg.d_model)},
            "attn_norm": ones,
            "ff": ff,
            "ff_norm": ones.clone(),
        },
        "final_norm": torch.ones((cfg.d_model,), dtype=dtype, device=device),
    }


def init_clip_params(seed: int, cfg: ClipTextConfig, dtype=torch.bfloat16,
                     device="cuda"):
    """Dense CLIP text-encoder params (stacked [L, ...] blocks)."""
    device = resolve_device(device)
    gen = _gen(seed, device)
    L, d = cfg.num_hidden_layers, cfg.projection_dim

    def lin(k_in, n_out):
        return Linear(w=_normal(gen, (L, k_in, n_out), k_in ** -0.5, dtype, device),
                      b=torch.zeros((L, n_out), dtype=dtype, device=device))

    def ln():
        return {"w": torch.ones((L, d), dtype=dtype, device=device),
                "b": torch.zeros((L, d), dtype=dtype, device=device)}

    return {
        "token_emb": _normal(gen, (cfg.vocab_size, d), 0.02, dtype, device),
        "pos_emb": _normal(gen, (cfg.max_position_embeddings, d), 0.02, dtype, device),
        "blocks": {
            "ln1": ln(),
            "attn": {"q": lin(d, d), "k": lin(d, d), "v": lin(d, d), "out": lin(d, d)},
            "ln2": ln(),
            "mlp": {"fc1": lin(d, cfg.intermediate_size),
                    "fc2": lin(cfg.intermediate_size, d)},
        },
        "final_ln": {"w": torch.ones((d,), dtype=dtype, device=device),
                     "b": torch.zeros((d,), dtype=dtype, device=device)},
    }


def _vae_makers(gen, dtype, device):
    """The VAE factories' layer makers, drawing from ``gen`` in call order:
    conv, resnet and mid block (HWIO filters, zero biases, unit norms)."""

    def conv(kh, kw, cin, cout):
        return Conv(w=_normal(gen, (kh, kw, cin, cout), (kh * kw * cin) ** -0.5,
                              dtype, device),
                    b=torch.zeros((cout,), dtype=dtype, device=device))

    def lin(cin, cout):
        return Linear(w=_normal(gen, (cin, cout), cin ** -0.5, dtype, device),
                      b=torch.zeros((cout,), dtype=dtype, device=device))

    def gn(c):
        return {"w": torch.ones((c,), dtype=dtype, device=device),
                "b": torch.zeros((c,), dtype=dtype, device=device)}

    def res(cin, cout):
        return {"norm1": gn(cin), "conv1": conv(3, 3, cin, cout),
                "norm2": gn(cout), "conv2": conv(3, 3, cout, cout),
                "shortcut": None if cin == cout else conv(1, 1, cin, cout)}

    def mid(c, attn: bool):
        return {
            "res1": res(c, c),
            "attn": {"norm": gn(c), "q": lin(c, c), "k": lin(c, c), "v": lin(c, c),
                     "out": lin(c, c)} if attn else None,
            "res2": res(c, c),
        }

    return conv, gn, res, mid


def init_vae_decoder_params(seed: int, cfg: VAEConfig, dtype=torch.bfloat16,
                            device="cuda"):
    """Dense VAE decoder params (HWIO filters, NHWC activations)."""
    device = resolve_device(device)
    conv, gn, res, mid_block = _vae_makers(_gen(seed, device), dtype, device)
    boc = cfg.block_out_channels
    c = boc[-1]
    mid = mid_block(c, cfg.mid_block_add_attention)
    up = []
    for i, cout in enumerate(reversed(boc)):
        resnets = []
        for _ in range(cfg.layers_per_block + 1):
            resnets.append(res(c, cout))
            c = cout
        up.append({"resnets": resnets,
                   "upsample": conv(3, 3, cout, cout) if i != len(boc) - 1 else None})
    decoder = {
        "conv_in": conv(3, 3, cfg.latent_channels, boc[-1]),
        "mid": mid,
        "up": up,
        "norm_out": gn(boc[0]),
        "conv_out": conv(3, 3, boc[0], cfg.out_channels),
    }
    return {
        "decoder": decoder,
        "post_quant_conv": conv(1, 1, cfg.latent_channels, cfg.latent_channels)
        if cfg.use_post_quant_conv else None,
    }


def init_vae_encoder_params(seed: int, cfg: VAEConfig, dtype=torch.bfloat16,
                            device="cuda"):
    """Dense VAE encoder params and ``quant_conv`` (HWIO filters, NHWC
    activations), from a generator of their own: merged with
    :func:`init_vae_decoder_params`'s, they leave the decoder's draws as
    they were."""
    device = resolve_device(device)
    conv, gn, res, mid_block = _vae_makers(_gen(seed, device), dtype, device)
    boc = cfg.block_out_channels
    conv_in = conv(3, 3, cfg.in_channels, boc[0])
    down = []
    c = boc[0]
    for i, cout in enumerate(boc):
        resnets = []
        for _ in range(cfg.layers_per_block):
            resnets.append(res(c, cout))
            c = cout
        down.append({"resnets": resnets,
                     "downsample": conv(3, 3, cout, cout) if i != len(boc) - 1 else None})
    encoder = {
        "conv_in": conv_in,
        "down": down,
        "mid": mid_block(c, cfg.mid_block_add_attention),
        "norm_out": gn(c),
        "conv_out": conv(3, 3, c, 2 * cfg.latent_channels),
    }
    return {
        "encoder": encoder,
        "quant_conv": conv(1, 1, 2 * cfg.latent_channels, 2 * cfg.latent_channels)
        if cfg.use_quant_conv else None,
    }


class WordTokenizer:
    """Deterministic stand-in tokenizer for synthetic-weight runs: each word
    maps to ``crc32(word) % (vocab - 2) + 1`` (stable across processes)."""

    class _Enc:
        def __init__(self, ids):
            self.ids = ids

    def __init__(self, vocab_size: int):
        self.vocab = vocab_size

    def encode_batch(self, prompts):
        return [
            self._Enc([zlib.crc32(w.encode()) % (self.vocab - 2) + 1
                       for w in p.split()])
            for p in prompts
        ]
