"""FLUX.1 MMDiT in plain float32 (Black Forest Labs' FLUX.1 as published:
19 double-stream blocks with joint attention over [txt; img], 38
single-stream blocks with the parallel MLP, 6-way and 3-way AdaLN, QK
RMSNorm, 3-axis interleaved RoPE, timestep / guidance / pooled-text
embedders and the AdaLN output layer). Weights are dequantized block by
block from the raw planes, so that the reference fits beside the program."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .common import Precision, attention, layer_norm, linear, rms_norm


def timestep_embedding(t: torch.Tensor, dim: int = 256) -> torch.Tensor:
    """Sinusoidal embedding of 1000 t, [cos | sin]."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float64,
                                                        device=t.device) / half)
    args = t.double()[:, None] * 1000.0 * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1).float()


def rope_tables(ids: torch.Tensor, axes_dim, theta: float = 10000.0):
    """ids [B, n, 3] -> cos, sin [B, n, sum(axes_dim) / 2]."""
    cs, ss = [], []
    for ax, dim in enumerate(axes_dim):
        inv = theta ** (-torch.arange(0, dim, 2, dtype=torch.float64, device=ids.device) / dim)
        f = ids[..., ax:ax + 1].double() * inv
        cs.append(torch.cos(f))
        ss.append(torch.sin(f))
    return torch.cat(cs, -1).float(), torch.cat(ss, -1).float()


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate interleaved pairs (2i, 2i+1) of x [B, H, S, D]."""
    b, h, s, d = x.shape
    x0, x1 = x.view(b, h, s, d // 2, 2).unbind(-1)
    c, sn = cos[:, None], sin[:, None]
    return torch.stack([c * x0 - sn * x1, sn * x0 + c * x1], -1).view(b, h, s, d)


def img_ids(h2: int, w2: int, device) -> torch.Tensor:
    r = torch.arange(h2, device=device, dtype=torch.float32)[:, None].expand(h2, w2)
    c = torch.arange(w2, device=device, dtype=torch.float32)[None, :].expand(h2, w2)
    return torch.stack([torch.zeros_like(r), r, c], -1).view(1, h2 * w2, 3)


class Flux:
    def __init__(self, cfg: dict, planes: dict, prec: Precision):
        self.p = planes
        self.prec = prec
        self.heads = cfg["num_attention_heads"]
        self.L, self.S = cfg["num_layers"], cfg["num_single_layers"]
        self.guidance = cfg["guidance_embeds"]
        self.axes = cfg["axes_dims_rope"]

    def lin(self, x, lin, i=None):
        return linear(x, lin, self.prec, i)

    def heads_of(self, t):
        b, s, n = t.shape
        return t.view(b, s, self.heads, n // self.heads).transpose(1, 2)

    def qkv(self, a, x, i):
        st = self.prec.store
        q = st(rms_norm(self.heads_of(self.lin(x, a["q"], i)), a["q_norm"][i]))
        k = st(rms_norm(self.heads_of(self.lin(x, a["k"], i)), a["k_norm"][i]))
        return q, k, self.heads_of(self.lin(x, a["v"], i))

    def attend(self, q, k, v, cos, sin):
        st = self.prec.store
        o = attention(st(rope(q, cos, sin)), st(rope(k, cos, sin)), v, self.prec)
        b, h, s, d = o.shape
        return o.transpose(1, 2).reshape(b, s, h * d)

    def mlp_embed(self, p, x):
        return self.lin(self.prec.store(F.silu(self.lin(x, p["in"]))), p["out"])

    def forward(self, img, txt, t, y, g, cos, sin):
        """img [B, S_img, 64], txt [B, S_txt, 4096], t [B], y [B, 768]."""
        p = self.p
        st = self.prec.store
        img = self.lin(img, p["img_in"])
        txt = self.lin(txt, p["txt_in"])
        vec = self.mlp_embed(p["time_in"], timestep_embedding(t))
        if self.guidance:
            vec = vec + self.mlp_embed(p["guidance_in"], timestep_embedding(g))
        vec = st(vec + self.mlp_embed(p["vector_in"], y))
        sv = st(F.silu(vec))
        n_txt = txt.shape[1]
        d = p["double"]
        for i in range(self.L):
            im = self.lin(sv, d["img_mod"], i)[:, None].chunk(6, -1)
            tm = self.lin(sv, d["txt_mod"], i)[:, None].chunk(6, -1)
            ix = st(layer_norm(img) * (1 + im[1]) + im[0])
            tx = st(layer_norm(txt) * (1 + tm[1]) + tm[0])
            iq, ik, iv = self.qkv(d["img_attn"], ix, i)
            tq, tk, tv = self.qkv(d["txt_attn"], tx, i)
            a = self.attend(torch.cat([tq, iq], 2), torch.cat([tk, ik], 2),
                            torch.cat([tv, iv], 2), cos, sin)
            ta, ia = a[:, :n_txt], a[:, n_txt:]
            img = st(img + im[2] * self.lin(ia, d["img_attn"]["proj"], i))
            h = st(layer_norm(img) * (1 + im[4]) + im[3])
            img = st(img + im[5] * self.lin(
                st(F.gelu(self.lin(h, d["img_mlp"]["in"], i), approximate="tanh")),
                d["img_mlp"]["out"], i))
            txt = st(txt + tm[2] * self.lin(ta, d["txt_attn"]["proj"], i))
            h = st(layer_norm(txt) * (1 + tm[4]) + tm[3])
            txt = st(txt + tm[5] * self.lin(
                st(F.gelu(self.lin(h, d["txt_mlp"]["in"], i), approximate="tanh")),
                d["txt_mlp"]["out"], i))
        x = torch.cat([txt, img], 1)
        s = p["single"]
        for i in range(self.S):
            shift, scale, gate = self.lin(sv, s["mod"], i)[:, None].chunk(3, -1)
            xm = st(layer_norm(x) * (1 + scale) + shift)
            q, k, v = self.qkv(s, xm, i)
            a = self.attend(q, k, v, cos, sin)
            mlp = st(F.gelu(self.lin(xm, s["proj_mlp"], i), approximate="tanh"))
            x = st(x + gate * self.lin(torch.cat([a, mlp], -1), s["linear2"], i))
        x = x[:, n_txt:]
        scale, shift = self.lin(sv, p["final"]["mod"])[:, None].chunk(2, -1)
        return self.lin(st(layer_norm(x) * (1 + scale) + shift), p["final"]["proj"])
