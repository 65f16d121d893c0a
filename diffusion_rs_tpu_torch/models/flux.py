"""FLUX.1 MMDiT (port of ``models/flux.py``).

Double-stream blocks (separate img/txt projections and MLPs, joint attention
over the concatenated sequence, 6-way AdaLN), single-stream blocks (fused
attention + MLP, 3-way AdaLN), timestep/guidance/pooled-vector embedders,
3-axis RoPE and the AdaLN final layer. Blocks loop in Python over the stacked
``[L, ...]`` block params, taking per-layer views.

Layouts: separate q/k/v projections (diffusers checkpoints) or the fused
``qkv`` / ``qkv_mlp`` projections that BFL checkpoints load into
(io/builders.py) and models/optimize.fuse_flux_qkv makes; interleaved RoPE
outside attention with the output written head-merged by the flash kernel;
and the load-time options of the JAX package: ``rope_fused`` (half-split
RoPE on q/k columns re-laid by models/optimize.rope_halfsplit_permute,
attention on seq-major [B, S, H*D] operands, DIFFUSION_RS_TPU_ATTN_LAYOUT
choosing the kernel per call) and ``grouped_qmm`` (each img/txt projection
pair of a double block as one grouped launch).

Under a mesh with an ``sp`` axis each rank runs the blocks on its own rows
of the text and of the image tokens (``S_txt / sp`` and ``S_img / sp``, its
local joint sequence ``[txt_r; img_r]``) with the matching RoPE rows, and
joint attention runs over the sp group (ops/partitioned.py); ``vec`` is
per sample and the same on every rank.

Under ``tp`` the params are a rank's cut tree (parallel/sharding.py): the
blocks run on the rank's own heads (``num_attention_heads / tp``) and MLP
columns, read off the row-parallel linears' cut (ops/linear.tp_size), and
each row-parallel linear (``proj``, the MLPs' ``out``, ``linear2``, the
embedders' ``out`` and ``final.proj``) sums its partial product over the tp
group. Under sp x tp the ring runs over sp on the local heads.

The step's plain-torch work runs inside three op-family spans, for the
profiler only (util/tracing.trace_span without NVTX): ``flux.norm_mod``
(the AdaLN modulation with its chunks, LayerNorm, scale/shift),
``flux.qk_rope`` (from the q/k/v projection's output to the attention
call: head split, QK-RMSNorm, the joint cat, RoPE, the contiguous
operands; in the default layout ops/rope.qk_norm_rope, one kernel launch
on the card, through :func:`_qk_prologue`) and ``flux.gate_act`` (GELU, the gated residual adds, the
single block's cat). The quantized linears and the attention call run
outside them, but for the modulation's linear, whose kernels a reader
tells apart by name. The fused-RoPE layouts rotate inside the attention call (K7's
pass, or ``flash_attention_fused``'s rotation under ``seqmajor``).

The forward is differentiable (a training step, dryrun.py): the collectives
under grad mode are parallel/mesh.py's conjugate pairs, and the QK-norm
scales, whole on every tp rank but applied to its own heads only, sum their
gradient over the tp group (:func:`_head_norms`).
"""

from __future__ import annotations

import dataclasses
import itertools
import os
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops import (apply_rope_halfsplit, expand_rope_tables, layer_norm, linear,
                   linear_grouped, qk_norm_rope, rms_norm, rope_tables, sdpa_merged)
from ..ops import attention
from ..ops.flash import flash_attention_fused
from ..ops.rope import HEAD_DIM, qk_norm_rope_plain
from ..ops.linear import Linear, tp_size
from ..ops.partitioned import SeqShard, partitioned_flash_rope
from ..parallel.mesh import copy_to_group, split_sizes
from ..util.tracing import trace_span
from ..util.tree import take_layer

Params = Dict[str, Any]


def _op_span(name: str):
    """A span around one family of the step's plain-torch ops
    (``flux.norm_mod``, ``flux.qk_rope``, ``flux.gate_act``), for the
    profiler only: outside a profiler it costs the check of its flag."""
    return trace_span(name, nvtx=False)


@dataclasses.dataclass(frozen=True)
class FluxConfig:
    in_channels: int = 64
    pooled_projection_dim: int = 768
    joint_attention_dim: int = 4096
    num_attention_heads: int = 24
    num_layers: int = 19
    num_single_layers: int = 38
    guidance_embeds: bool = True
    hidden_size: int = 3072
    mlp_ratio: float = 4.0
    axes_dim: Tuple[int, ...] = (16, 56, 56)
    theta: int = 10000
    # Set by the loader, never read from config.json. rope_fused: the q/k
    # projection columns were re-laid by models/optimize.
    # rope_halfsplit_permute, so blocks run half-split RoPE and seq-major
    # attention. grouped_qmm: double blocks run each img/txt projection
    # pair as one grouped call (needs fused qkv in both streams).
    rope_fused: bool = False
    grouped_qmm: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def mlp_size(self) -> int:
        return int(self.hidden_size * self.mlp_ratio)

    @staticmethod
    def from_json(d: dict) -> "FluxConfig":
        """diffusers transformer/config.json; ``attention_head_dim``,
        ``axes_dims_rope`` and ``mlp_ratio`` are honoured when present."""
        heads = d["num_attention_heads"]
        return FluxConfig(
            in_channels=d["in_channels"],
            pooled_projection_dim=d["pooled_projection_dim"],
            joint_attention_dim=d["joint_attention_dim"],
            num_attention_heads=heads,
            num_layers=d["num_layers"],
            num_single_layers=d["num_single_layers"],
            guidance_embeds=d["guidance_embeds"],
            hidden_size=heads * d.get("attention_head_dim", 128),
            mlp_ratio=float(d.get("mlp_ratio", 4.0)),
            axes_dim=tuple(d.get("axes_dims_rope", (16, 56, 56))),
        )


def timestep_embedding(t: torch.Tensor, dim: int, dtype) -> torch.Tensor:
    """Sinusoidal embedding of 1000*t, f32 math, layout [cos | sin]."""
    half = dim // 2
    t = t.float() * 1000.0
    log_base = torch.log(torch.tensor(10000.0, dtype=torch.float32, device=t.device))
    freqs = torch.exp(
        torch.arange(half, dtype=torch.float32, device=t.device) * (-log_base / half)
    )
    args = t[:, None] * freqs[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1).to(dtype)


def _mlp_embedder(p: Params, x: torch.Tensor) -> torch.Tensor:
    return linear(F.silu(linear(x, p["in"])), p["out"])


def _modulation(lin: Linear, vec: torch.Tensor, n: int):
    """AdaLN: silu(vec) -> linear -> n chunks of [B, 1, H]."""
    y = linear(F.silu(vec), lin)[:, None, :]
    return torch.chunk(y, n, dim=-1)


def _scale_shift(x, shift, scale):
    return x * (scale + 1.0) + shift


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def _head_norms(p: Params):
    """The q_norm / k_norm scales of an attention (or single block) dict.
    Each tp rank applies them to its own heads, so under grad mode their
    gradient sums over the tp group (``copy_to_group``; forward: as is)."""
    lin = p[next(k for k in ("qkv", "qkv_mlp", "q") if k in p)]
    group = None if lin.tp is None else lin.tp.group
    return copy_to_group(p["q_norm"], group), copy_to_group(p["k_norm"], group)


def _qkv_cols(p: Params, x: torch.Tensor, proj=None):
    """The q, k, v columns [B, S, H*D]: one fused ``qkv`` linear, q/k/v
    linears, or ``proj``, a fused q|k|v projection computed already (the
    grouped path)."""
    if proj is None and "qkv" in p:
        proj = linear(x, p["qkv"])
    if proj is not None:
        return torch.chunk(proj, 3, dim=-1)
    return linear(x, p["q"]), linear(x, p["k"]), linear(x, p["v"])


def _qk_prologue(streams, cos, sin, n_heads: int, cfg: FluxConfig):
    """The default layout's attention prologue (``flux.qk_rope``):
    ops/rope.qk_norm_rope, one kernel launch on the card, which raises on
    what it cannot take. Its plain composition runs instead where the
    block's attention runs without the flash kernels
    (DIFFUSION_RS_TPU_NO_FLASH, which the training step sets) or the head
    dim is not the kernel's, as :func:`_joint_attention_sm` picks its
    layout by head dim."""
    if attention._no_flash() or cfg.head_dim != HEAD_DIM:
        return qk_norm_rope_plain(streams, cos, sin, n_heads)
    return qk_norm_rope(streams, cos, sin, n_heads)


def _norm_sm(t: torch.Tensor, scale: torch.Tensor, n_heads: int) -> torch.Tensor:
    """Per-head RMSNorm of seq-major [B, S, H*D], without a head transpose."""
    b, s, _ = t.shape
    return rms_norm(t.reshape(b, s, n_heads, -1), scale).reshape(b, s, -1)


def _qkv_sm(p: Params, cols, n_heads: int):
    """The ``rope_fused`` layout's QK-RMSNorm: q/k/v stay [B, S, H*D] (the
    layout the seq-major flash kernels read), q/k per-head RMS-normed."""
    qc, kc, vc = cols
    qn, kn = _head_norms(p)
    return _norm_sm(qc, qn, n_heads), _norm_sm(kc, kn, n_heads), vc


def _joint_attention_sm(q, k, v, ce, se, head_dim: int, seq: Optional[SeqShard] = None):
    """Attention in the half-split RoPE convention on seq-major q/k/v
    [B, S, H*D] with the expanded tables ce/se (ops/rope.expand_rope_tables);
    needs params re-laid by models/optimize.rope_halfsplit_permute.

    DIFFUSION_RS_TPU_ATTN_LAYOUT, read per call: ``seqmajor`` rotates q/k
    outside and runs the seq-major kernel (K6); ``inkernel`` rotates inside
    it (K7); ``bhsd`` (the default), or a head dim the fused kernels do not
    take, rotates outside, splits heads and runs the [B, H, S, D] kernel
    (K3). Under ``seq`` every layout rotates outside and takes the ring (or
    its gather fallback), as JAX's sp rules do. With
    DIFFUSION_RS_TPU_NO_FLASH set every layout rotates outside and takes
    ``sdpa_merged``'s XLA path, as JAX's does without its flash mode. The
    [B, H, S, D] path's rotation runs inside ``flux.qk_rope``."""
    no_flash = attention._no_flash()
    if seq is not None and not no_flash:
        return partitioned_flash_rope(q, k, v, ce, se, head_dim, seq)
    layout = os.environ.get("DIFFUSION_RS_TPU_ATTN_LAYOUT", "bhsd")
    if not no_flash and head_dim % 128 == 0 and layout in ("seqmajor", "inkernel"):
        try:
            return flash_attention_fused(q, k, v, ce, se, head_dim=head_dim)
        except NotImplementedError:
            pass
    b, s, n = q.shape
    h = n // head_dim
    cos = ce[..., : head_dim // 2]
    sin = se[..., head_dim // 2:]

    def split(t):
        return t.reshape(b, s, h, head_dim).transpose(1, 2)

    with _op_span("flux.qk_rope"):
        qr = apply_rope_halfsplit(split(q), cos, sin).contiguous()
        kr = apply_rope_halfsplit(split(k), cos, sin).contiguous()
        vr = split(v).contiguous()
    return sdpa_merged(qr, kr, vr, seq=seq)


def _attend(q, k, v, cos, sin, cfg: FluxConfig, seq: Optional[SeqShard]):
    """The joint attention call on the prepared q/k/v (outside the spans)."""
    if cfg.rope_fused:
        return _joint_attention_sm(q, k, v, cos, sin, cfg.head_dim, seq)
    return sdpa_merged(q, k, v, seq=seq)


def double_block(p: Params, img, txt, vec, cos, sin, cfg: FluxConfig,
                 seq: Optional[SeqShard] = None):
    """Double-stream block; txt tokens lead in the joint sequence. With
    ``cfg.rope_fused``, (cos, sin) carry the expanded (ce, se) tables."""
    with _op_span("flux.norm_mod"):
        i_shift1, i_scale1, i_gate1, i_shift2, i_scale2, i_gate2 = _modulation(
            p["img_mod"], vec, 6)
        t_shift1, t_scale1, t_gate1, t_shift2, t_scale2, t_gate2 = _modulation(
            p["txt_mod"], vec, 6)
        img_mod = _scale_shift(layer_norm(img), i_shift1, i_scale1)
        txt_mod = _scale_shift(layer_norm(txt), t_shift1, t_scale1)
    heads = cfg.num_attention_heads // tp_size(p["img_attn"]["proj"])  # this rank's
    # grouped path: each img/txt projection pair as one grouped call, the
    # txt rows riding on the img call's grid; needs fused qkv in both streams
    grouped = cfg.grouped_qmm and "qkv" in p["img_attn"] and "qkv" in p["txt_attn"]
    if grouped:
        i_proj, t_proj = linear_grouped(
            [img_mod, txt_mod], [p["img_attn"]["qkv"], p["txt_attn"]["qkv"]])
    else:
        i_proj = t_proj = None
    i_cols = _qkv_cols(p["img_attn"], img_mod, i_proj)
    t_cols = _qkv_cols(p["txt_attn"], txt_mod, t_proj)
    with _op_span("flux.qk_rope"):
        if cfg.rope_fused:
            iq, ik, iv = _qkv_sm(p["img_attn"], i_cols, heads)
            tq, tk, tv = _qkv_sm(p["txt_attn"], t_cols, heads)
            q, k, v = (torch.cat(pair, dim=1) for pair in ((tq, iq), (tk, ik), (tv, iv)))
        else:
            q, k, v = _qk_prologue([(*t_cols, *_head_norms(p["txt_attn"])),
                                    (*i_cols, *_head_norms(p["img_attn"]))], cos, sin, heads,
                                   cfg)
    attn = _attend(q, k, v, cos, sin, cfg, seq)
    txt_len = txt.shape[1]
    txt_attn, img_attn = attn[:, :txt_len], attn[:, txt_len:]

    if grouped:
        i_p, t_p = linear_grouped([img_attn, txt_attn],
                                  [p["img_attn"]["proj"], p["txt_attn"]["proj"]])
        with _op_span("flux.gate_act"):
            img = img + i_gate1 * i_p
            txt = txt + t_gate1 * t_p
        with _op_span("flux.norm_mod"):
            img_mlp_in = _scale_shift(layer_norm(img), i_shift2, i_scale2)
            txt_mlp_in = _scale_shift(layer_norm(txt), t_shift2, t_scale2)
        i_h, t_h = linear_grouped([img_mlp_in, txt_mlp_in],
                                  [p["img_mlp"]["in"], p["txt_mlp"]["in"]])
        with _op_span("flux.gate_act"):
            i_h, t_h = _gelu(i_h), _gelu(t_h)
        img_mlp, txt_mlp = linear_grouped([i_h, t_h],
                                          [p["img_mlp"]["out"], p["txt_mlp"]["out"]])
        with _op_span("flux.gate_act"):
            return img + i_gate2 * img_mlp, txt + t_gate2 * txt_mlp

    img = _mlp_stream(p["img_attn"]["proj"], p["img_mlp"], img, img_attn,
                      i_gate1, i_shift2, i_scale2, i_gate2)
    txt = _mlp_stream(p["txt_attn"]["proj"], p["txt_mlp"], txt, txt_attn,
                      t_gate1, t_shift2, t_scale2, t_gate2)
    return img, txt


def _mlp_stream(proj: Linear, mlp: Params, x, attn, gate1, shift2, scale2, gate2):
    """One stream's attention projection, gated residual, AdaLN MLP and
    gated residual (a double block's ungrouped path)."""
    a = linear(attn, proj)
    with _op_span("flux.gate_act"):
        x = x + gate1 * a
    with _op_span("flux.norm_mod"):
        mlp_in = _scale_shift(layer_norm(x), shift2, scale2)
    h = linear(mlp_in, mlp["in"])
    with _op_span("flux.gate_act"):
        h = _gelu(h)
    out = linear(h, mlp["out"])
    with _op_span("flux.gate_act"):
        return x + gate2 * out


def single_block(p: Params, x, vec, cos, sin, cfg: FluxConfig,
                 seq: Optional[SeqShard] = None):
    """Single-stream block: a shared pre-norm feeds attention and the
    parallel MLP; their outputs concatenate into one projection. With
    ``cfg.rope_fused``, (cos, sin) carry the expanded (ce, se) tables."""
    with _op_span("flux.norm_mod"):
        shift, scale, gate = _modulation(p["mod"], vec, 3)
        x_mod = _scale_shift(layer_norm(x), shift, scale)
    tp = tp_size(p["linear2"])  # this rank's heads and their width
    h = cfg.hidden_size // tp
    heads = cfg.num_attention_heads // tp
    if "qkv_mlp" in p:
        # fused q|k|v|mlp projection (BFL linear1)
        fused = linear(x_mod, p["qkv_mlp"])
        cols = (fused[..., 0:h], fused[..., h:2 * h], fused[..., 2 * h:3 * h])
        mlp_h = fused[..., 3 * h:]
    else:
        cols = _qkv_cols(p, x_mod)
        mlp_h = linear(x_mod, p["proj_mlp"])
    with _op_span("flux.qk_rope"):
        if cfg.rope_fused:
            q, k, v = _qkv_sm(p, cols, heads)
        else:
            q, k, v = _qk_prologue([(*cols, *_head_norms(p))], cos, sin, heads, cfg)
    with _op_span("flux.gate_act"):
        mlp = _gelu(mlp_h)
    attn = _attend(q, k, v, cos, sin, cfg, seq)
    with _op_span("flux.gate_act"):
        cat = torch.cat([attn, mlp], dim=-1)
    out = linear(cat, p["linear2"])
    with _op_span("flux.gate_act"):
        return x + gate * out


def final_layer(p: Params, x, vec):
    """AdaLN-final then patch projection; chunk order is (scale, shift)."""
    with _op_span("flux.norm_mod"):
        y = linear(F.silu(vec), p["mod"])
        scale, shift = torch.chunk(y[:, None, :], 2, dim=-1)
        x = layer_norm(x) * (scale + 1.0) + shift
    return linear(x, p["proj"])


def compute_pe(cfg: FluxConfig, txt_ids: torch.Tensor, img_ids: torch.Tensor):
    """RoPE tables for the joint sequence, computed once per generation."""
    ids = torch.cat([txt_ids, img_ids], dim=1)
    return rope_tables(ids, cfg.axes_dim, cfg.theta)


def conditioning_vector(params: Params, cfg: FluxConfig, t, y, guidance, dtype):
    """vec = time_in(t) [+ guidance_in(g)] + vector_in(y)."""
    vec = _mlp_embedder(params["time_in"], timestep_embedding(t, 256, dtype))
    if cfg.guidance_embeds:
        if guidance is None:
            raise ValueError("guidance_embeds model requires a guidance value")
        vec = vec + _mlp_embedder(params["guidance_in"],
                                  timestep_embedding(guidance, 256, dtype))
    return vec + _mlp_embedder(params["vector_in"], y)


def flux_forward(params: Params, cfg: FluxConfig, img: torch.Tensor,
                 txt: torch.Tensor, t: torch.Tensor, y: torch.Tensor,
                 guidance: Optional[torch.Tensor] = None,
                 txt_ids: Optional[torch.Tensor] = None,
                 img_ids: Optional[torch.Tensor] = None,
                 pe=None, mesh=None, blocks=None) -> torch.Tensor:
    """Full MMDiT forward. img [B, S_img, in_channels] packed patches,
    txt [B, S_txt, joint_attention_dim], t [B], y [B, pooled_dim].

    ``mesh`` (parallel.make_mesh) with sp > 1: ``img`` holds this rank's
    rows of the image tokens (parallel.sequence_sharding), ``txt`` and the
    position ids / ``pe`` the whole sequence; the result is this rank's
    image rows.

    ``blocks``: an iterator over the per-layer block params, the double
    blocks then the single blocks, taken one at a time as each block runs
    (models/flux_streaming.py streams them); None takes views of the
    stacked ``params["double"]`` / ``params["single"]``."""
    dtype = img.dtype
    if pe is None:
        pe = compute_pe(cfg, txt_ids, img_ids)
    cos, sin = pe
    if cfg.rope_fused:
        # expanded once; the blocks take (ce, se) through the (cos, sin) slots
        cos, sin = expand_rope_tables(cos, sin)
    seq = None
    if mesh is not None and mesh.shape["sp"] > 1:
        txt, cos, sin, seq = _shard_sequence(mesh, img, txt, cos, sin)
    txt_h = linear(txt, params["txt_in"])
    img_h = linear(img, params["img_in"])
    vec = conditioning_vector(params, cfg, t, y, guidance, dtype)
    if blocks is None:
        blocks = itertools.chain(
            (take_layer(params["double"], i) for i in range(cfg.num_layers)),
            (take_layer(params["single"], i) for i in range(cfg.num_single_layers)))
    txt_len = txt_h.shape[1]
    for _ in range(cfg.num_layers):
        img_h, txt_h = double_block(next(blocks), img_h, txt_h, vec, cos, sin, cfg, seq)
    x = torch.cat([txt_h, img_h], dim=1)
    for _ in range(cfg.num_single_layers):
        x = single_block(next(blocks), x, vec, cos, sin, cfg, seq)
    return final_layer(params["final"], x[:, txt_len:], vec)


def _shard_sequence(mesh, img, txt, cos, sin):
    """This sp rank's text rows and RoPE rows (its text rows, then its image
    rows), and the :class:`SeqShard` of the local joint sequences. Text and
    image split separately (``torch.tensor_split``), so that every rank runs
    the same linears on the same row count when sp divides both."""
    sp, r = mesh.shape["sp"], mesh.coords["sp"]
    n_txt = txt.shape[1]
    n_img = cos.shape[1] - n_txt
    txt_sizes, img_sizes = split_sizes(n_txt, sp), split_sizes(n_img, sp)
    if img.shape[1] != img_sizes[r]:
        raise ValueError(f"sp rank {r} holds {img.shape[1]} image rows, expected "
                         f"{img_sizes[r]} of {n_img}")

    def rows(t):
        return torch.cat([torch.tensor_split(t[:, :n_txt], sp, dim=1)[r],
                          torch.tensor_split(t[:, n_txt:], sp, dim=1)[r]], dim=1)

    seq = SeqShard(mesh.groups["sp"], [a + b for a, b in zip(txt_sizes, img_sizes)])
    return torch.tensor_split(txt, sp, dim=1)[r], rows(cos), rows(sin), seq
