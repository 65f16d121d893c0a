"""Checkpoint key mapping: VarStore -> the port's param trees (port of
``diffusion_rs_tpu/io/builders.py``).

Key names follow the diffusers checkpoint layouts (FluxTransformer2D, T5
encoder, CLIPTextModel, AutoencoderKL) and, for FLUX, the original
Black-Forest-Labs names that single-file GGUF transformers use. Per-layer
trees are stacked along a leading ``[L, ...]`` axis on the store's device
(``util.tree.stack_layers``), the layout the models index with
``take_layer``; QuantizedTensor leaves stack their packed/scale/bias planes.
"""

from __future__ import annotations

import dataclasses

import torch

from ..models.clip import ClipTextConfig
from ..models.flux import FluxConfig
from ..models.t5 import T5Config
from ..models.vae import VAEConfig
from ..ops.linear import Linear
from ..quant.qtensor import QuantizedTensor, concat_n, slice_n
from ..util.tree import stack_layers
from .varstore import VarStore

# ---------------------------------------------------------------------------
# FLUX
# ---------------------------------------------------------------------------


def is_bfl_naming(store: VarStore) -> bool:
    """Original BFL tensor names (city96-style FLUX GGUF files and BFL
    safetensors): double_blocks.N.img_attn.qkv..., single_blocks.N.linear1...,
    final_layer.* -- vs the diffusers transformer_blocks.* tree."""
    return ("double_blocks.0.img_mod.lin.weight" in store
            or "single_blocks.0.linear1.weight" in store)


def flux_config_from_bfl(store: VarStore, base: FluxConfig = None) -> FluxConfig:
    """A FluxConfig from a BFL-named store (single-file GGUF transformers ship
    no config.json): layer counts from key scans, in_channels/hidden from
    img_in's [out, in] shape, heads from the QK-norm scale length, guidance
    from the presence of guidance_in. Other fields (axes_dim, ...) come from
    ``base``."""
    n_double = 0
    while f"double_blocks.{n_double}.img_mod.lin.weight" in store:
        n_double += 1
    n_single = 0
    while f"single_blocks.{n_single}.linear2.weight" in store:
        n_single += 1
    e = store.raw_entry("img_in.weight")
    h, in_ch = e.shape[-2], e.shape[-1]  # torch [out, in]
    te = store.raw_entry("txt_in.weight")
    qn = store.raw_entry("double_blocks.0.img_attn.norm.query_norm.scale")
    return dataclasses.replace(
        base or FluxConfig(),
        in_channels=in_ch,
        joint_attention_dim=te.shape[-1],
        num_layers=n_double,
        num_single_layers=n_single,
        guidance_embeds="guidance_in.in_layer.weight" in store,
        hidden_size=h,
        num_attention_heads=h // qn.shape[-1],
    )


def _swap_scale_shift_n(lin: Linear, h: int) -> Linear:
    """BFL's final AdaLN emits (shift, scale); the canonical tree follows the
    diffusers (scale, shift) order, so the output halves swap. Exact for
    dense and quantized weights (column slices)."""
    w = lin.w
    if isinstance(w, QuantizedTensor):
        w = concat_n([slice_n(w, h, 2 * h), slice_n(w, 0, h)])
    else:
        w = torch.cat([w[..., h:], w[..., :h]], dim=-1)
    b = lin.b
    if b is not None:
        b = torch.cat([b[..., h:], b[..., :h]], dim=-1)
    return Linear(w=w, b=b)


def _build_flux_params_bfl(store: VarStore, cfg: FluxConfig, dtype, dequantize: bool):
    """BFL weight paths. The fused projections map onto the model's fused
    layouts directly: double ``img_attn.qkv`` -> "qkv" (q|k|v columns),
    single ``linear1`` -> "qkv_mlp" (q|k|v|mlp columns)."""
    v = store.pp("")

    def lin(p, bias=True):
        return v.pp(p).linear(bias=bias, dtype=dtype, dequantize_to_dense=dequantize)

    def mlp_embedder(p):
        return {"in": lin(f"{p}.in_layer"), "out": lin(f"{p}.out_layer")}

    def attn(p):
        return {"qkv": lin(f"{p}.qkv"), "proj": lin(f"{p}.proj"),
                "q_norm": v.get(f"{p}.norm.query_norm.scale", dtype),
                "k_norm": v.get(f"{p}.norm.key_norm.scale", dtype)}

    def double(i):
        p = f"double_blocks.{i}"
        return {
            "img_mod": lin(f"{p}.img_mod.lin"),
            "txt_mod": lin(f"{p}.txt_mod.lin"),
            "img_attn": attn(f"{p}.img_attn"),
            "txt_attn": attn(f"{p}.txt_attn"),
            "img_mlp": {"in": lin(f"{p}.img_mlp.0"), "out": lin(f"{p}.img_mlp.2")},
            "txt_mlp": {"in": lin(f"{p}.txt_mlp.0"), "out": lin(f"{p}.txt_mlp.2")},
        }

    def single(i):
        p = f"single_blocks.{i}"
        return {
            "qkv_mlp": lin(f"{p}.linear1"),
            "linear2": lin(f"{p}.linear2"),
            "q_norm": v.get(f"{p}.norm.query_norm.scale", dtype),
            "k_norm": v.get(f"{p}.norm.key_norm.scale", dtype),
            "mod": lin(f"{p}.modulation.lin"),
        }

    params = {
        "img_in": lin("img_in"),
        "txt_in": lin("txt_in"),
        "time_in": mlp_embedder("time_in"),
        "vector_in": mlp_embedder("vector_in"),
        "double": stack_layers(double, cfg.num_layers, store.device),
        "single": stack_layers(single, cfg.num_single_layers, store.device),
        "final": {
            "mod": _swap_scale_shift_n(lin("final_layer.adaLN_modulation.1"),
                                       cfg.hidden_size),
            "proj": lin("final_layer.linear"),
        },
    }
    if cfg.guidance_embeds:
        params["guidance_in"] = mlp_embedder("guidance_in")
    return params


def build_flux_params(store: VarStore, cfg: FluxConfig, dtype=torch.bfloat16,
                      dequantize: bool = False):
    """diffusers FluxTransformer2D weight paths; BFL-named stores (single-file
    GGUF) dispatch to the BFL key map."""
    if is_bfl_naming(store):
        return _build_flux_params_bfl(store, cfg, dtype, dequantize)
    v = store.pp("")

    def lin(p, bias=True):
        return v.pp(p).linear(bias=bias, dtype=dtype, dequantize_to_dense=dequantize)

    def mlp_embedder(p):
        return {"in": lin(f"{p}.linear_1"), "out": lin(f"{p}.linear_2")}

    def attn(p, ctx: bool):
        if not ctx:
            return {"q": lin(f"{p}.to_q"), "k": lin(f"{p}.to_k"), "v": lin(f"{p}.to_v"),
                    "proj": lin(f"{p}.to_out.0"),
                    "q_norm": v.get(f"{p}.norm_q.weight", dtype),
                    "k_norm": v.get(f"{p}.norm_k.weight", dtype)}
        return {"q": lin(f"{p}.add_q_proj"), "k": lin(f"{p}.add_k_proj"),
                "v": lin(f"{p}.add_v_proj"), "proj": lin(f"{p}.to_add_out"),
                "q_norm": v.get(f"{p}.norm_added_q.weight", dtype),
                "k_norm": v.get(f"{p}.norm_added_k.weight", dtype)}

    def double(i):
        p = f"transformer_blocks.{i}"
        return {
            "img_mod": lin(f"{p}.norm1.linear"),
            "txt_mod": lin(f"{p}.norm1_context.linear"),
            "img_attn": attn(f"{p}.attn", ctx=False),
            "txt_attn": attn(f"{p}.attn", ctx=True),
            "img_mlp": {"in": lin(f"{p}.ff.net.0.proj"), "out": lin(f"{p}.ff.net.2")},
            "txt_mlp": {"in": lin(f"{p}.ff_context.net.0.proj"),
                        "out": lin(f"{p}.ff_context.net.2")},
        }

    def single(i):
        p = f"single_transformer_blocks.{i}"
        return {
            "q": lin(f"{p}.attn.to_q"), "k": lin(f"{p}.attn.to_k"),
            "v": lin(f"{p}.attn.to_v"),
            "q_norm": v.get(f"{p}.attn.norm_q.weight", dtype),
            "k_norm": v.get(f"{p}.attn.norm_k.weight", dtype),
            "proj_mlp": lin(f"{p}.proj_mlp"),
            "linear2": lin(f"{p}.proj_out"),
            "mod": lin(f"{p}.norm.linear"),
        }

    params = {
        "img_in": lin("x_embedder"),
        "txt_in": lin("context_embedder"),
        "time_in": mlp_embedder("time_text_embed.timestep_embedder"),
        "vector_in": mlp_embedder("time_text_embed.text_embedder"),
        "double": stack_layers(double, cfg.num_layers, store.device),
        "single": stack_layers(single, cfg.num_single_layers, store.device),
        "final": {"mod": lin("norm_out.linear"), "proj": lin("proj_out")},
    }
    if cfg.guidance_embeds:
        params["guidance_in"] = mlp_embedder("time_text_embed.guidance_embedder")
    return params


# ---------------------------------------------------------------------------
# T5
# ---------------------------------------------------------------------------


def build_t5_params(store: VarStore, cfg: T5Config, dtype=torch.bfloat16,
                    dequantize: bool = False):
    """T5 encoder: shared embedding (whichever copy the checkpoint has),
    stacked blocks, final norm; the relative-position bias stays f32."""
    v = store.pp("")
    for name in ("shared.weight", "encoder.embed_tokens.weight",
                 "decoder.embed_tokens.weight"):
        if name in store:
            shared = v.get(name, dtype)
            break
    else:
        raise KeyError("no T5 token embedding (shared / embed_tokens) in the store")

    def lin(p):
        return v.pp(p).linear(bias=False, dtype=dtype, dequantize_to_dense=dequantize)

    def block(i):
        p = f"encoder.block.{i}.layer"
        ff_p = f"{p}.1.DenseReluDense"
        ff = ({"wi_0": lin(f"{ff_p}.wi_0"), "wi_1": lin(f"{ff_p}.wi_1"),
               "wo": lin(f"{ff_p}.wo")}
              if cfg.gated_act else {"wi": lin(f"{ff_p}.wi"), "wo": lin(f"{ff_p}.wo")})
        return {
            "attn": {k: lin(f"{p}.0.SelfAttention.{k}") for k in "qkvo"},
            "attn_norm": v.get(f"{p}.0.layer_norm.weight", dtype),
            "ff": ff,
            "ff_norm": v.get(f"{p}.1.layer_norm.weight", dtype),
        }

    return {
        "shared": shared,
        "rel_bias": v.get(
            "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight",
            torch.float32),
        "blocks": stack_layers(block, cfg.num_layers, store.device),
        "final_norm": v.get("encoder.final_layer_norm.weight", dtype),
    }


# ---------------------------------------------------------------------------
# CLIP
# ---------------------------------------------------------------------------


def build_clip_params(store: VarStore, cfg: ClipTextConfig, dtype=torch.bfloat16):
    """transformers CLIPTextModel paths."""
    v = store.pp("text_model")

    def ln(p):
        return {"w": v.get(f"{p}.weight", dtype), "b": v.get(f"{p}.bias", dtype)}

    def lin(p):
        return v.pp(p).linear(bias=True, dtype=dtype)

    def block(i):
        p = f"encoder.layers.{i}"
        return {
            "ln1": ln(f"{p}.layer_norm1"),
            "attn": {"q": lin(f"{p}.self_attn.q_proj"), "k": lin(f"{p}.self_attn.k_proj"),
                     "v": lin(f"{p}.self_attn.v_proj"),
                     "out": lin(f"{p}.self_attn.out_proj")},
            "ln2": ln(f"{p}.layer_norm2"),
            "mlp": {"fc1": lin(f"{p}.mlp.fc1"), "fc2": lin(f"{p}.mlp.fc2")},
        }

    return {
        "token_emb": v.get("embeddings.token_embedding.weight", dtype),
        "pos_emb": v.get("embeddings.position_embedding.weight", dtype),
        "blocks": stack_layers(block, cfg.num_hidden_layers, store.device),
        "final_ln": ln("final_layer_norm"),
    }


# ---------------------------------------------------------------------------
# VAE
# ---------------------------------------------------------------------------


def build_vae_params(store: VarStore, cfg: VAEConfig, dtype=torch.bfloat16):
    """diffusers AutoencoderKL paths: the encoder and decoder towers and
    the optional ``quant_conv`` / ``post_quant_conv``."""
    v = store.pp("")

    def gn(p):
        return {"w": v.get(f"{p}.weight", dtype), "b": v.get(f"{p}.bias", dtype)}

    def conv(p):
        return v.pp(p).conv2d(dtype)

    def resnet(p):
        return {
            "norm1": gn(f"{p}.norm1"), "conv1": conv(f"{p}.conv1"),
            "norm2": gn(f"{p}.norm2"), "conv2": conv(f"{p}.conv2"),
            "shortcut": conv(f"{p}.conv_shortcut")
            if f"{p}.conv_shortcut.weight" in store else None,
        }

    def mid(p):
        attn = None
        if cfg.mid_block_add_attention:
            a = f"{p}.attentions.0"
            attn = {
                "norm": gn(f"{a}.group_norm"),
                "q": v.pp(f"{a}.to_q").conv2d_as_linear(dtype),
                "k": v.pp(f"{a}.to_k").conv2d_as_linear(dtype),
                "v": v.pp(f"{a}.to_v").conv2d_as_linear(dtype),
                "out": v.pp(f"{a}.to_out.0").conv2d_as_linear(dtype),
            }
        return {"res1": resnet(f"{p}.resnets.0"), "attn": attn,
                "res2": resnet(f"{p}.resnets.1")}

    n_levels = len(cfg.block_out_channels)
    down = []
    for i in range(n_levels):
        p = f"encoder.down_blocks.{i}"
        down.append({
            "resnets": [resnet(f"{p}.resnets.{j}") for j in range(cfg.layers_per_block)],
            "downsample": conv(f"{p}.downsamplers.0.conv") if i != n_levels - 1 else None,
        })
    up = []
    for i in range(n_levels):
        p = f"decoder.up_blocks.{i}"
        up.append({
            "resnets": [resnet(f"{p}.resnets.{j}") for j in range(cfg.layers_per_block + 1)],
            "upsample": conv(f"{p}.upsamplers.0.conv") if i != n_levels - 1 else None,
        })
    return {
        "encoder": {
            "conv_in": conv("encoder.conv_in"),
            "down": down,
            "mid": mid("encoder.mid_block"),
            "norm_out": gn("encoder.conv_norm_out"),
            "conv_out": conv("encoder.conv_out"),
        },
        "decoder": {
            "conv_in": conv("decoder.conv_in"),
            "mid": mid("decoder.mid_block"),
            "up": up,
            "norm_out": gn("decoder.conv_norm_out"),
            "conv_out": conv("decoder.conv_out"),
        },
        "quant_conv": conv("quant_conv") if "quant_conv.weight" in store else None,
        "post_quant_conv": conv("post_quant_conv")
        if "post_quant_conv.weight" in store else None,
    }
