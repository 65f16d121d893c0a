"""The FLUX VAE decoder (diffusers AutoencoderKL, 16 latent channels) in
plain float32, NCHW: conv_in, the mid block (resnet, single-head spatial
attention, resnet), the up tower of resnets with nearest 2x upsampling,
GroupNorm + SiLU + conv_out."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import Precision, attention, conv, linear


def _gn(x, p, groups):
    return F.group_norm(x, groups, p["w"].float(), p["b"].float(), eps=1e-6)


def _res(p, x, groups, prec):
    h = conv(F.silu(_gn(x, p["norm1"], groups)), p["conv1"], prec, padding=1)
    h = conv(F.silu(_gn(h, p["norm2"], groups)), p["conv2"], prec, padding=1)
    if p.get("shortcut") is not None:
        x = conv(x, p["shortcut"], prec)
    return prec.store_nchw(x + h)


def _attn(p, x, groups, prec):
    b, c, h, w = x.shape
    t = _gn(x, p["norm"], groups).flatten(2).transpose(1, 2)  # [B, HW, C]
    q, k, v = (linear(t, p[n], prec)[:, None] for n in ("q", "k", "v"))
    a = attention(q, k, v, prec)[:, 0]
    return prec.store_nchw(x + linear(a, p["out"], prec).transpose(1, 2).reshape(b, c, h, w))


def decode(cfg: dict, p: dict, z: torch.Tensor, prec: Precision) -> torch.Tensor:
    """Scaled latent NCHW [B, 16, h, w] -> image NCHW in about [-1, 1]."""
    g = cfg["vae"]["norm_num_groups"]
    d = p["decoder"]
    h = conv(z, d["conv_in"], prec, padding=1)
    h = _res(d["mid"]["res1"], h, g, prec)
    if d["mid"].get("attn") is not None:
        h = _attn(d["mid"]["attn"], h, g, prec)
    h = _res(d["mid"]["res2"], h, g, prec)
    for up in d["up"]:
        for r in up["resnets"]:
            h = _res(r, h, g, prec)
        if up.get("upsample") is not None:
            h = conv(F.interpolate(h, scale_factor=2.0, mode="nearest"), up["upsample"], prec,
                     padding=1)
    return conv(F.silu(_gn(h, d["norm_out"], g)), d["conv_out"], prec, padding=1)
