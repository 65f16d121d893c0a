"""Synthetic weights at real shapes (random values, made from a seed).

Every tensor is drawn on the target device from a seeded
``torch.Generator``, so a full-size FLUX q8t checkpoint (~12 GB of int8
planes) is made on the card in seconds with no host pool. The layouts and
value scales follow the JAX package's ``util/synthetic.py`` and the dense
``init_*_params`` factories of its models; the values themselves differ
(another generator).
"""

from __future__ import annotations

import json
import zlib
from pathlib import Path
from typing import Optional

import torch

from ..models.clip import ClipTextConfig
from ..models.flux import FluxConfig
from ..models.t5 import T5Config
from ..models.vae import VAEConfig
from ..io.safetensors import save_safetensors
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


def write_diffusers_dir(root, cfgs: dict, seed: int) -> None:
    """A diffusers-layout FLUX.1-dev directory at the widths of ``cfgs``: random
    bf16 weights (normal, std 1/sqrt(K) for linears) named as the published
    checkpoint names them, with its configs (dev: guidance embedder, dynamic
    shift) and small tokenizer files (a character BPE for CLIP, a word-level
    T5 tokenizer; ids stay inside the vocabularies)."""
    from tokenizers import Tokenizer, models, pre_tokenizers

    root = Path(root)
    gen = torch.Generator().manual_seed(seed)
    fc, tc, cc, vc = cfgs["flux_cfg"], cfgs["t5_cfg"], cfgs["clip_cfg"], cfgs["vae_cfg"]
    for d in ("scheduler", "text_encoder", "text_encoder_2", "tokenizer", "tokenizer_2",
              "transformer", "vae"):
        (root / d).mkdir(parents=True, exist_ok=True)

    def normal(shape, std):
        return (torch.randn(shape, generator=gen) * std).to(torch.bfloat16)

    def ones(n):
        return torch.ones(n, dtype=torch.bfloat16)

    def zeros(n):
        return torch.zeros(n, dtype=torch.bfloat16)

    def lin(t, name, n_out, n_in, bias=True):
        t[f"{name}.weight"] = normal((n_out, n_in), n_in ** -0.5)
        if bias:
            t[f"{name}.bias"] = zeros(n_out)

    def save(path, t, config=None):
        save_safetensors(str(root / path), t)
        if config is not None:
            (root / Path(path).parent / "config.json").write_text(json.dumps(config))

    (root / "model_index.json").write_text(json.dumps({"_class_name": "FluxPipeline"}))
    (root / "scheduler/scheduler_config.json").write_text(json.dumps({
        "_class_name": "FlowMatchEulerDiscreteScheduler", "base_image_seq_len": 256,
        "base_shift": 0.5, "max_image_seq_len": 4096, "max_shift": 1.15, "shift": 3.0,
        "use_dynamic_shifting": True}))
    d, L = cc.projection_dim, cc.num_hidden_layers
    t = {"text_model.embeddings.token_embedding.weight": normal((cc.vocab_size, d), 0.02),
         "text_model.embeddings.position_embedding.weight":
             normal((cc.max_position_embeddings, d), 0.02),
         "text_model.final_layer_norm.weight": ones(d),
         "text_model.final_layer_norm.bias": zeros(d)}
    for i in range(L):
        p = f"text_model.encoder.layers.{i}"
        for stub in ("q_proj", "k_proj", "v_proj", "out_proj"):
            lin(t, f"{p}.self_attn.{stub}", d, d)
        lin(t, f"{p}.mlp.fc1", cc.intermediate_size, d)
        lin(t, f"{p}.mlp.fc2", d, cc.intermediate_size)
        for ln in ("layer_norm1", "layer_norm2"):
            t[f"{p}.{ln}.weight"], t[f"{p}.{ln}.bias"] = ones(d), zeros(d)
    save("text_encoder/model.safetensors", t, {
        "vocab_size": cc.vocab_size, "hidden_size": d, "intermediate_size": cc.intermediate_size,
        "max_position_embeddings": cc.max_position_embeddings, "num_hidden_layers": L,
        "num_attention_heads": cc.num_attention_heads, "hidden_act": "quick_gelu"})
    dm, inner = tc.d_model, tc.num_heads * tc.d_kv
    t = {"shared.weight": normal((tc.vocab_size, dm), 1.0),
         "encoder.final_layer_norm.weight": ones(dm),
         "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight":
             normal((tc.relative_attention_num_buckets, tc.num_heads), 1.0)}
    for i in range(tc.num_layers):
        p = f"encoder.block.{i}.layer"
        for k in "qkv":
            lin(t, f"{p}.0.SelfAttention.{k}", inner, dm, bias=False)
        lin(t, f"{p}.0.SelfAttention.o", dm, inner, bias=False)
        t[f"{p}.0.layer_norm.weight"] = ones(dm)
        lin(t, f"{p}.1.DenseReluDense.wi_0", tc.d_ff, dm, bias=False)
        lin(t, f"{p}.1.DenseReluDense.wi_1", tc.d_ff, dm, bias=False)
        lin(t, f"{p}.1.DenseReluDense.wo", dm, tc.d_ff, bias=False)
        t[f"{p}.1.layer_norm.weight"] = ones(dm)
    save("text_encoder_2/model.safetensors", t, {
        "vocab_size": tc.vocab_size, "d_model": dm, "d_kv": tc.d_kv, "d_ff": tc.d_ff,
        "num_layers": tc.num_layers, "num_heads": tc.num_heads,
        "relative_attention_num_buckets": tc.relative_attention_num_buckets,
        "relative_attention_max_distance": tc.relative_attention_max_distance,
        "layer_norm_epsilon": tc.layer_norm_epsilon, "feed_forward_proj": "gated-gelu"})
    chars = {chr(c): i for i, c in enumerate(range(32, 127))}
    (root / "tokenizer/vocab.json").write_text(json.dumps(chars))
    (root / "tokenizer/merges.txt").write_text("#version: 0.2\n")
    words = ["<pad>", "</s>", "<unk>", "a", "photo", "of", "cat", "on", "the", "table"]
    tok = Tokenizer(models.WordLevel({w: i for i, w in enumerate(words)}, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    (root / "tokenizer_2/tokenizer.json").write_text(tok.to_str())
    h, m = fc.hidden_size, fc.mlp_size
    t = {}
    tops = {"x_embedder": (h, fc.in_channels), "context_embedder": (h, fc.joint_attention_dim),
            "time_text_embed.timestep_embedder.linear_1": (h, 256),
            "time_text_embed.timestep_embedder.linear_2": (h, h),
            "time_text_embed.text_embedder.linear_1": (h, fc.pooled_projection_dim),
            "time_text_embed.text_embedder.linear_2": (h, h),
            "time_text_embed.guidance_embedder.linear_1": (h, 256),
            "time_text_embed.guidance_embedder.linear_2": (h, h),
            "norm_out.linear": (2 * h, h), "proj_out": (fc.in_channels, h)}
    for name, (o, n) in tops.items():
        lin(t, name, o, n)
    for i in range(fc.num_layers):
        p = f"transformer_blocks.{i}"
        for name, (o, n) in {
                "norm1.linear": (6 * h, h), "norm1_context.linear": (6 * h, h),
                "attn.to_q": (h, h), "attn.to_k": (h, h), "attn.to_v": (h, h),
                "attn.to_out.0": (h, h), "attn.add_q_proj": (h, h), "attn.add_k_proj": (h, h),
                "attn.add_v_proj": (h, h), "attn.to_add_out": (h, h),
                "ff.net.0.proj": (m, h), "ff.net.2": (h, m),
                "ff_context.net.0.proj": (m, h), "ff_context.net.2": (h, m)}.items():
            lin(t, f"{p}.{name}", o, n)
        for k in ("norm_q", "norm_k", "norm_added_q", "norm_added_k"):
            t[f"{p}.attn.{k}.weight"] = ones(fc.head_dim)
    for i in range(fc.num_single_layers):
        p = f"single_transformer_blocks.{i}"
        for name, (o, n) in {"attn.to_q": (h, h), "attn.to_k": (h, h), "attn.to_v": (h, h),
                             "proj_mlp": (m, h), "proj_out": (h, h + m),
                             "norm.linear": (3 * h, h)}.items():
            lin(t, f"{p}.{name}", o, n)
        for k in ("norm_q", "norm_k"):
            t[f"{p}.attn.{k}.weight"] = ones(fc.head_dim)
    save("transformer/diffusion_pytorch_model.safetensors", t, {
        "in_channels": fc.in_channels, "pooled_projection_dim": fc.pooled_projection_dim,
        "joint_attention_dim": fc.joint_attention_dim,
        "num_attention_heads": fc.num_attention_heads, "attention_head_dim": fc.head_dim,
        "axes_dims_rope": list(fc.axes_dim), "num_layers": fc.num_layers,
        "num_single_layers": fc.num_single_layers, "guidance_embeds": fc.guidance_embeds})
    t = {}

    def conv(p, cout, cin, k):
        t[f"{p}.weight"] = normal((cout, cin, k, k), (cin * k * k) ** -0.5)
        t[f"{p}.bias"] = zeros(cout)

    def gn(p, c):
        t[f"{p}.weight"], t[f"{p}.bias"] = ones(c), zeros(c)

    def resnet(p, cin, cout):
        gn(f"{p}.norm1", cin)
        conv(f"{p}.conv1", cout, cin, 3)
        gn(f"{p}.norm2", cout)
        conv(f"{p}.conv2", cout, cout, 3)
        if cin != cout:
            conv(f"{p}.conv_shortcut", cout, cin, 1)

    def mid(p, c):
        resnet(f"{p}.resnets.0", c, c)
        resnet(f"{p}.resnets.1", c, c)
        gn(f"{p}.attentions.0.group_norm", c)
        for k in ("to_q", "to_k", "to_v", "to_out.0"):
            lin(t, f"{p}.attentions.0.{k}", c, c)

    boc, lpb = vc.block_out_channels, vc.layers_per_block
    conv("encoder.conv_in", boc[0], vc.in_channels, 3)
    c = boc[0]
    for i, cout in enumerate(boc):
        for j in range(lpb):
            resnet(f"encoder.down_blocks.{i}.resnets.{j}", c, cout)
            c = cout
        if i != len(boc) - 1:
            conv(f"encoder.down_blocks.{i}.downsamplers.0.conv", c, c, 3)
    mid("encoder.mid_block", c)
    gn("encoder.conv_norm_out", c)
    conv("encoder.conv_out", 2 * vc.latent_channels, c, 3)
    conv("decoder.conv_in", boc[-1], vc.latent_channels, 3)
    mid("decoder.mid_block", boc[-1])
    c = boc[-1]
    for i, cout in enumerate(reversed(boc)):
        for j in range(lpb + 1):
            resnet(f"decoder.up_blocks.{i}.resnets.{j}", c, cout)
            c = cout
        if i != len(boc) - 1:
            conv(f"decoder.up_blocks.{i}.upsamplers.0.conv", c, c, 3)
    gn("decoder.conv_norm_out", boc[0])
    conv("decoder.conv_out", vc.out_channels, boc[0], 3)
    save("vae/diffusion_pytorch_model.safetensors", t, {
        "_class_name": "AutoencoderKL", "in_channels": vc.in_channels,
        "out_channels": vc.out_channels, "block_out_channels": list(boc),
        "layers_per_block": lpb, "latent_channels": vc.latent_channels,
        "norm_num_groups": vc.norm_num_groups, "scaling_factor": vc.scaling_factor,
        "shift_factor": vc.shift_factor, "mid_block_add_attention": vc.mid_block_add_attention,
        "use_quant_conv": vc.use_quant_conv, "use_post_quant_conv": vc.use_post_quant_conv})
