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

from ..ops import (apply_rope, apply_rope_halfsplit, expand_rope_tables, layer_norm,
                   linear, linear_grouped, rms_norm, rope_tables, sdpa_merged)
from ..ops import attention
from ..ops.flash import flash_attention_fused
from ..ops.linear import Linear, tp_size
from ..ops.partitioned import SeqShard, partitioned_flash_rope
from ..parallel.mesh import copy_to_group, split_sizes
from ..util.tree import take_layer

Params = Dict[str, Any]


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


def _split_heads(t: torch.Tensor, n_heads: int) -> torch.Tensor:
    b, s, _ = t.shape
    return t.reshape(b, s, n_heads, -1).transpose(1, 2)


def _head_norms(p: Params):
    """The q_norm / k_norm scales of an attention (or single block) dict.
    Each tp rank applies them to its own heads, so under grad mode their
    gradient sums over the tp group (``copy_to_group``; forward: as is)."""
    lin = p[next(k for k in ("qkv", "qkv_mlp", "q") if k in p)]
    group = None if lin.tp is None else lin.tp.group
    return copy_to_group(p["q_norm"], group), copy_to_group(p["k_norm"], group)


def _qkv(p: Params, x: torch.Tensor, n_heads: int, proj=None):
    """Project (one fused ``qkv`` linear, or q/k/v), split heads to
    [B, H, S, D], QK-RMSNorm. ``proj`` is a fused q|k|v projection computed
    already (the grouped path)."""
    if proj is None and "qkv" in p:
        proj = linear(x, p["qkv"])
    if proj is not None:
        qc, kc, vc = torch.chunk(proj, 3, dim=-1)
    else:
        qc, kc, vc = linear(x, p["q"]), linear(x, p["k"]), linear(x, p["v"])
    qn, kn = _head_norms(p)
    q = rms_norm(_split_heads(qc, n_heads), qn)
    k = rms_norm(_split_heads(kc, n_heads), kn)
    return q, k, _split_heads(vc, n_heads)


def _joint_attention(q, k, v, cos, sin, seq: Optional[SeqShard] = None):
    """RoPE + attention; the flash kernel writes the head-merged
    [B, S, H*D] layout directly. ``seq``: the rows are this rank's of a
    sequence split over the sp group."""
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    return sdpa_merged(q.contiguous(), k.contiguous(), v.contiguous(), seq=seq)


def _norm_sm(t: torch.Tensor, scale: torch.Tensor, n_heads: int) -> torch.Tensor:
    """Per-head RMSNorm of seq-major [B, S, H*D], without a head transpose."""
    b, s, _ = t.shape
    return rms_norm(t.reshape(b, s, n_heads, -1), scale).reshape(b, s, -1)


def _qkv_sm(p: Params, x: torch.Tensor, n_heads: int, proj=None):
    """Seq-major :func:`_qkv`: q/k/v stay [B, S, H*D] (the layout the
    seq-major flash kernels read), q/k per-head RMS-normed."""
    if proj is None and "qkv" in p:
        proj = linear(x, p["qkv"])
    if proj is not None:
        qc, kc, vc = torch.chunk(proj, 3, dim=-1)
    else:
        qc, kc, vc = linear(x, p["q"]), linear(x, p["k"]), linear(x, p["v"])
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
    ``sdpa_merged``'s XLA path, as JAX's does without its flash mode."""
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

    qr = apply_rope_halfsplit(split(q), cos, sin)
    kr = apply_rope_halfsplit(split(k), cos, sin)
    return sdpa_merged(qr.contiguous(), kr.contiguous(), split(v).contiguous(), seq=seq)


def double_block(p: Params, img, txt, vec, cos, sin, cfg: FluxConfig,
                 seq: Optional[SeqShard] = None):
    """Double-stream block; txt tokens lead in the joint sequence. With
    ``cfg.rope_fused``, (cos, sin) carry the expanded (ce, se) tables."""
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
    if cfg.rope_fused:
        iq, ik, iv = _qkv_sm(p["img_attn"], img_mod, heads, proj=i_proj)
        tq, tk, tv = _qkv_sm(p["txt_attn"], txt_mod, heads, proj=t_proj)
        q = torch.cat([tq, iq], dim=1)
        k = torch.cat([tk, ik], dim=1)
        v = torch.cat([tv, iv], dim=1)
        attn = _joint_attention_sm(q, k, v, cos, sin, cfg.head_dim, seq)
    else:
        iq, ik, iv = _qkv(p["img_attn"], img_mod, heads, proj=i_proj)
        tq, tk, tv = _qkv(p["txt_attn"], txt_mod, heads, proj=t_proj)
        q = torch.cat([tq, iq], dim=2)
        k = torch.cat([tk, ik], dim=2)
        v = torch.cat([tv, iv], dim=2)
        attn = _joint_attention(q, k, v, cos, sin, seq)
    txt_len = txt.shape[1]
    txt_attn, img_attn = attn[:, :txt_len], attn[:, txt_len:]

    if grouped:
        i_p, t_p = linear_grouped([img_attn, txt_attn],
                                  [p["img_attn"]["proj"], p["txt_attn"]["proj"]])
        img = img + i_gate1 * i_p
        txt = txt + t_gate1 * t_p
        img_mlp_in = _scale_shift(layer_norm(img), i_shift2, i_scale2)
        txt_mlp_in = _scale_shift(layer_norm(txt), t_shift2, t_scale2)
        i_h, t_h = linear_grouped([img_mlp_in, txt_mlp_in],
                                  [p["img_mlp"]["in"], p["txt_mlp"]["in"]])
        img_mlp, txt_mlp = linear_grouped([_gelu(i_h), _gelu(t_h)],
                                          [p["img_mlp"]["out"], p["txt_mlp"]["out"]])
        return img + i_gate2 * img_mlp, txt + t_gate2 * txt_mlp

    img = img + i_gate1 * linear(img_attn, p["img_attn"]["proj"])
    img_mlp_in = _scale_shift(layer_norm(img), i_shift2, i_scale2)
    img_mlp = linear(_gelu(linear(img_mlp_in, p["img_mlp"]["in"])), p["img_mlp"]["out"])
    img = img + i_gate2 * img_mlp

    txt = txt + t_gate1 * linear(txt_attn, p["txt_attn"]["proj"])
    txt_mlp_in = _scale_shift(layer_norm(txt), t_shift2, t_scale2)
    txt_mlp = linear(_gelu(linear(txt_mlp_in, p["txt_mlp"]["in"])), p["txt_mlp"]["out"])
    txt = txt + t_gate2 * txt_mlp
    return img, txt


def single_block(p: Params, x, vec, cos, sin, cfg: FluxConfig,
                 seq: Optional[SeqShard] = None):
    """Single-stream block: a shared pre-norm feeds attention and the
    parallel MLP; their outputs concatenate into one projection. With
    ``cfg.rope_fused``, (cos, sin) carry the expanded (ce, se) tables."""
    shift, scale, gate = _modulation(p["mod"], vec, 3)
    x_mod = _scale_shift(layer_norm(x), shift, scale)
    tp = tp_size(p["linear2"])  # this rank's heads and their width
    h = cfg.hidden_size // tp
    heads = cfg.num_attention_heads // tp
    if cfg.rope_fused:
        if "qkv_mlp" in p:
            fused = linear(x_mod, p["qkv_mlp"])
            qn, kn = _head_norms(p)
            q = _norm_sm(fused[..., 0:h], qn, heads)
            k = _norm_sm(fused[..., h:2 * h], kn, heads)
            v = fused[..., 2 * h:3 * h]
            mlp = _gelu(fused[..., 3 * h:])
        else:
            q, k, v = _qkv_sm(p, x_mod, heads)
            mlp = _gelu(linear(x_mod, p["proj_mlp"]))
        attn = _joint_attention_sm(q, k, v, cos, sin, cfg.head_dim, seq)
    else:
        if "qkv_mlp" in p:
            # fused q|k|v|mlp projection (BFL linear1)
            fused = linear(x_mod, p["qkv_mlp"])
            qn, kn = _head_norms(p)
            q = rms_norm(_split_heads(fused[..., 0:h], heads), qn)
            k = rms_norm(_split_heads(fused[..., h:2 * h], heads), kn)
            v = _split_heads(fused[..., 2 * h:3 * h], heads)
            mlp = _gelu(fused[..., 3 * h:])
        else:
            q, k, v = _qkv(p, x_mod, heads)
            mlp = _gelu(linear(x_mod, p["proj_mlp"]))
        attn = _joint_attention(q, k, v, cos, sin, seq)
    out = linear(torch.cat([attn, mlp], dim=-1), p["linear2"])
    return x + gate * out


def final_layer(p: Params, x, vec):
    """AdaLN-final then patch projection; chunk order is (scale, shift)."""
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
