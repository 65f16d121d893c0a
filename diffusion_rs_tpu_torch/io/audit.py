"""Checkpoint key and shape inventories, and the audit against them (the
port's own copy of ``diffusion_rs_tpu/io/audit.py``).

The inventories are the authoritative tensor lists (every key and shape) of
the checkpoints the reference loads, written independently of
io/builders.py: the FLUX transformer in the diffusers layout
(``FluxTransformer2DModel``) and the BFL single-file layout (city96 GGUF,
BFL safetensors), the diffusers ``AutoencoderKL``, and T5 / CLIP as the
``transformers`` classes save them (cross-checked against the fixtures in
tests/key_inventories/). :func:`audit_keys` holds a key -> shape mapping
(:func:`store_shapes` of a VarStore) against an inventory: missing keys,
unexpected keys and shape mismatches. A wrong key in a builder would
otherwise load garbage silently on a real checkpoint.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

Shape = Tuple[int, ...]


# ---------------------------------------------------------------------------
# FLUX transformer (diffusers FluxTransformer2DModel checkpoint layout)
# ---------------------------------------------------------------------------


def expected_flux_keys(cfg) -> Dict[str, Shape]:
    """Full key->shape inventory for a diffusers-layout FLUX transformer.

    Derived from the checkpoint structure the reference's VarBuilder paths
    traverse (models/flux/model.rs:709-788) at the given config. Weights are
    torch-layout ``[out, in]``.
    """
    H = cfg.hidden_size
    D = H // cfg.num_attention_heads
    mlp = int(getattr(cfg, "mlp_size", 4 * H))
    inv: Dict[str, Shape] = {}

    def lin(p: str, out: int, in_: int):
        inv[f"{p}.weight"] = (out, in_)
        inv[f"{p}.bias"] = (out,)

    lin("x_embedder", H, cfg.in_channels)
    lin("context_embedder", H, cfg.joint_attention_dim)
    lin("time_text_embed.timestep_embedder.linear_1", H, 256)
    lin("time_text_embed.timestep_embedder.linear_2", H, H)
    lin("time_text_embed.text_embedder.linear_1", H, cfg.pooled_projection_dim)
    lin("time_text_embed.text_embedder.linear_2", H, H)
    if cfg.guidance_embeds:
        lin("time_text_embed.guidance_embedder.linear_1", H, 256)
        lin("time_text_embed.guidance_embedder.linear_2", H, H)

    for i in range(cfg.num_layers):
        p = f"transformer_blocks.{i}"
        lin(f"{p}.norm1.linear", 6 * H, H)
        lin(f"{p}.norm1_context.linear", 6 * H, H)
        for q in ("to_q", "to_k", "to_v"):
            lin(f"{p}.attn.{q}", H, H)
        for q in ("add_q_proj", "add_k_proj", "add_v_proj"):
            lin(f"{p}.attn.{q}", H, H)
        inv[f"{p}.attn.norm_q.weight"] = (D,)
        inv[f"{p}.attn.norm_k.weight"] = (D,)
        inv[f"{p}.attn.norm_added_q.weight"] = (D,)
        inv[f"{p}.attn.norm_added_k.weight"] = (D,)
        lin(f"{p}.attn.to_out.0", H, H)
        lin(f"{p}.attn.to_add_out", H, H)
        lin(f"{p}.ff.net.0.proj", mlp, H)
        lin(f"{p}.ff.net.2", H, mlp)
        lin(f"{p}.ff_context.net.0.proj", mlp, H)
        lin(f"{p}.ff_context.net.2", H, mlp)

    for i in range(cfg.num_single_layers):
        p = f"single_transformer_blocks.{i}"
        lin(f"{p}.norm.linear", 3 * H, H)
        for q in ("to_q", "to_k", "to_v"):
            lin(f"{p}.attn.{q}", H, H)
        inv[f"{p}.attn.norm_q.weight"] = (D,)
        inv[f"{p}.attn.norm_k.weight"] = (D,)
        lin(f"{p}.proj_mlp", mlp, H)
        lin(f"{p}.proj_out", H, H + mlp)

    lin("norm_out.linear", 2 * H, H)
    lin("proj_out", cfg.in_channels, H)
    return inv


def expected_flux_keys_bfl(cfg) -> Dict[str, Shape]:
    """BFL single-file naming (city96 GGUF / black-forest-labs safetensors):
    fused qkv / linear1 projections, final_layer AdaLN. Matches the layout
    _build_flux_params_bfl consumes (io/builders.py)."""
    H = cfg.hidden_size
    D = H // cfg.num_attention_heads
    mlp = int(getattr(cfg, "mlp_size", 4 * H))
    inv: Dict[str, Shape] = {}

    def lin(p: str, out: int, in_: int):
        inv[f"{p}.weight"] = (out, in_)
        inv[f"{p}.bias"] = (out,)

    lin("img_in", H, cfg.in_channels)
    lin("txt_in", H, cfg.joint_attention_dim)
    for emb, in_ in (
        ("time_in", 256),
        ("vector_in", cfg.pooled_projection_dim),
    ) + ((("guidance_in", 256),) if cfg.guidance_embeds else ()):
        lin(f"{emb}.in_layer", H, in_)
        lin(f"{emb}.out_layer", H, H)

    for i in range(cfg.num_layers):
        p = f"double_blocks.{i}"
        lin(f"{p}.img_mod.lin", 6 * H, H)
        lin(f"{p}.txt_mod.lin", 6 * H, H)
        for s in ("img", "txt"):
            lin(f"{p}.{s}_attn.qkv", 3 * H, H)
            lin(f"{p}.{s}_attn.proj", H, H)
            inv[f"{p}.{s}_attn.norm.query_norm.scale"] = (D,)
            inv[f"{p}.{s}_attn.norm.key_norm.scale"] = (D,)
            lin(f"{p}.{s}_mlp.0", mlp, H)
            lin(f"{p}.{s}_mlp.2", H, mlp)

    for i in range(cfg.num_single_layers):
        p = f"single_blocks.{i}"
        lin(f"{p}.linear1", 3 * H + mlp, H)
        lin(f"{p}.linear2", H, H + mlp)
        inv[f"{p}.norm.query_norm.scale"] = (D,)
        inv[f"{p}.norm.key_norm.scale"] = (D,)
        lin(f"{p}.modulation.lin", 3 * H, H)

    lin("final_layer.adaLN_modulation.1", 2 * H, H)
    lin("final_layer.linear", cfg.in_channels, H)
    return inv


# ---------------------------------------------------------------------------
# VAE (diffusers AutoencoderKL checkpoint layout)
# ---------------------------------------------------------------------------


def expected_vae_keys(cfg) -> Dict[str, Shape]:
    """AutoencoderKL inventory (models/vaes/vae.rs / autoencoder_kl.rs:67-88
    paths). The FLUX VAE ships with use_quant_conv=False and
    use_post_quant_conv=False, so those keys are absent unless the config
    carries them."""
    ch = list(cfg.block_out_channels)
    lpb = cfg.layers_per_block
    lat = cfg.latent_channels
    inv: Dict[str, Shape] = {}

    def conv(p: str, out: int, in_: int, k: int = 3):
        inv[f"{p}.weight"] = (out, in_, k, k)
        inv[f"{p}.bias"] = (out,)

    def norm(p: str, c: int):
        inv[f"{p}.weight"] = (c,)
        inv[f"{p}.bias"] = (c,)

    def resnet(p: str, in_: int, out: int):
        norm(f"{p}.norm1", in_)
        conv(f"{p}.conv1", out, in_)
        norm(f"{p}.norm2", out)
        conv(f"{p}.conv2", out, out)
        if in_ != out:
            conv(f"{p}.conv_shortcut", out, in_, k=1)

    def mid(p: str, c: int):
        resnet(f"{p}.resnets.0", c, c)
        resnet(f"{p}.resnets.1", c, c)
        if cfg.mid_block_add_attention:
            a = f"{p}.attentions.0"
            norm(f"{a}.group_norm", c)
            for q in ("to_q", "to_k", "to_v", "to_out.0"):
                inv[f"{a}.{q}.weight"] = (c, c)
                inv[f"{a}.{q}.bias"] = (c,)

    # encoder: channel doubles at each down block entry
    conv("encoder.conv_in", ch[0], 3)
    prev = ch[0]
    for i, c in enumerate(ch):
        p = f"encoder.down_blocks.{i}"
        for j in range(lpb):
            resnet(f"{p}.resnets.{j}", prev if j == 0 else c, c)
        prev = c
        if i != len(ch) - 1:
            conv(f"{p}.downsamplers.0.conv", c, c)
    mid("encoder.mid_block", ch[-1])
    norm("encoder.conv_norm_out", ch[-1])
    conv("encoder.conv_out", 2 * lat, ch[-1])

    # decoder: reversed channels, layers_per_block+1 resnets per level
    rev = list(reversed(ch))
    conv("decoder.conv_in", rev[0], lat)
    mid("decoder.mid_block", rev[0])
    prev = rev[0]
    for i, c in enumerate(rev):
        p = f"decoder.up_blocks.{i}"
        for j in range(lpb + 1):
            resnet(f"{p}.resnets.{j}", prev if j == 0 else c, c)
        prev = c
        if i != len(rev) - 1:
            conv(f"{p}.upsamplers.0.conv", c, c)
    norm("decoder.conv_norm_out", rev[-1])
    conv("decoder.conv_out", 3, rev[-1])

    if getattr(cfg, "use_quant_conv", False):
        conv("quant_conv", 2 * lat, 2 * lat, k=1)
    if getattr(cfg, "use_post_quant_conv", False):
        conv("post_quant_conv", lat, lat, k=1)
    return inv


# ---------------------------------------------------------------------------
# Text encoders
# ---------------------------------------------------------------------------


def expected_t5_keys(cfg) -> Dict[str, Shape]:
    """T5EncoderModel checkpoint inventory (models/t5/mod.rs:633-656 paths).

    Cross-validated against the transformers-generated fixture
    tests/key_inventories/t5_xxl.json (tools/gen_key_inventory.py) — real
    checkpoints keep the tied embedding as ``shared.weight`` only.
    """
    d = cfg.d_model
    inner = cfg.num_heads * cfg.d_kv
    inv: Dict[str, Shape] = {"shared.weight": (cfg.vocab_size, d)}
    for i in range(cfg.num_layers):
        p = f"encoder.block.{i}.layer"
        for q, shape in (
            ("q", (inner, d)), ("k", (inner, d)), ("v", (inner, d)),
            ("o", (d, inner)),
        ):
            inv[f"{p}.0.SelfAttention.{q}.weight"] = shape
        inv[f"{p}.0.layer_norm.weight"] = (d,)
        if i == 0:
            inv[f"{p}.0.SelfAttention.relative_attention_bias.weight"] = (
                cfg.relative_attention_num_buckets, cfg.num_heads,
            )
        ff = f"{p}.1.DenseReluDense"
        if cfg.gated_act:
            inv[f"{ff}.wi_0.weight"] = (cfg.d_ff, d)
            inv[f"{ff}.wi_1.weight"] = (cfg.d_ff, d)
        else:
            inv[f"{ff}.wi.weight"] = (cfg.d_ff, d)
        inv[f"{ff}.wo.weight"] = (d, cfg.d_ff)
        inv[f"{p}.1.layer_norm.weight"] = (d,)
    inv["encoder.final_layer_norm.weight"] = (d,)
    return inv


def expected_clip_keys(cfg) -> Dict[str, Shape]:
    """CLIPTextModel checkpoint inventory (models/clip/text.rs paths).

    Cross-validated against tests/key_inventories/clip_l.json.
    """
    h = cfg.projection_dim  # ClipTextConfig stores hidden_size here
    inv: Dict[str, Shape] = {
        "text_model.embeddings.token_embedding.weight": (cfg.vocab_size, h),
        "text_model.embeddings.position_embedding.weight": (
            cfg.max_position_embeddings, h,
        ),
    }

    def wb(p: str, out: int, in_: int = None):
        inv[f"{p}.weight"] = (out,) if in_ is None else (out, in_)
        inv[f"{p}.bias"] = (out,)

    for i in range(cfg.num_hidden_layers):
        p = f"text_model.encoder.layers.{i}"
        wb(f"{p}.layer_norm1", h)
        for q in ("q_proj", "k_proj", "v_proj", "out_proj"):
            wb(f"{p}.self_attn.{q}", h, h)
        wb(f"{p}.layer_norm2", h)
        wb(f"{p}.mlp.fc1", cfg.intermediate_size, h)
        wb(f"{p}.mlp.fc2", h, cfg.intermediate_size)
    wb("text_model.final_layer_norm", h)
    return inv


# ---------------------------------------------------------------------------
# Audit
# ---------------------------------------------------------------------------

# Buffers real checkpoints may carry that no loader should consume.
IGNORABLE_KEYS = frozenset({
    "text_model.embeddings.position_ids",  # old-transformers CLIP buffer
})


@dataclass
class AuditReport:
    missing: List[str] = field(default_factory=list)       # expected, absent
    unexpected: List[str] = field(default_factory=list)    # present, not expected
    shape_mismatch: List[Tuple[str, Shape, Shape]] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not (self.missing or self.unexpected or self.shape_mismatch)

    def summary(self) -> str:
        if self.ok:
            return "checkpoint matches inventory"
        parts = []
        for name, items in (
            ("missing", self.missing),
            ("unexpected", self.unexpected),
        ):
            if items:
                shown = ", ".join(items[:5]) + ("…" if len(items) > 5 else "")
                parts.append(f"{len(items)} {name} ({shown})")
        if self.shape_mismatch:
            k, want, got = self.shape_mismatch[0]
            parts.append(
                f"{len(self.shape_mismatch)} shape mismatches "
                f"(e.g. {k}: expected {want}, got {got})"
            )
        return "; ".join(parts)


def audit_keys(
    present: Dict[str, Shape], expected: Dict[str, Shape]
) -> AuditReport:
    """Compare a key->shape mapping against an inventory."""
    rep = AuditReport()
    for k, shape in expected.items():
        if k not in present:
            rep.missing.append(k)
        elif tuple(present[k]) != tuple(shape):
            rep.shape_mismatch.append((k, tuple(shape), tuple(present[k])))
    for k in present:
        if k not in expected and k not in IGNORABLE_KEYS:
            rep.unexpected.append(k)
    rep.missing.sort()
    rep.unexpected.sort()
    return rep


def store_shapes(store) -> Dict[str, Shape]:
    """Key->shape of a VarStore (raw entry shapes, no materialization)."""
    out = {}
    for k in store.keys():
        e = store.raw_entry(k)
        out[k] = tuple(e.shape)
    return out
