"""AutoencoderKL (port of ``models/vae.py``), all channels-last (NHWC).

Decoder: conv_in -> mid (resnet, spatial attention, resnet) -> up tower of
resnets with nearest-2x upsampling -> GroupNorm/SiLU/conv_out, and the
spatially tiled decode with feathered seams. Encoder: conv_in -> down tower
of resnets with the stride-2 downsample padded right and bottom -> mid ->
GroupNorm/SiLU/conv_out -> optional quant conv, giving the mean|logvar
moments; the diagonal Gaussian's sample or mode; and the tiled encode,
whose moments are feathered in latent space before one global sample.
Scale/shift factors are applied by the caller."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ..ops import group_norm, sdpa
from ..ops.conv import conv2d, upsample_nearest_2x
from ..ops.linear import linear

Params = Dict[str, Any]

_PAD1 = ((1, 1), (1, 1))


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    block_out_channels: tuple = (128, 256, 512, 512)
    layers_per_block: int = 2
    latent_channels: int = 16
    norm_num_groups: int = 32
    scaling_factor: float = 0.3611
    shift_factor: float = 0.1159
    mid_block_add_attention: bool = True
    use_quant_conv: bool = False
    use_post_quant_conv: bool = False

    @staticmethod
    def from_json(d: dict) -> "VAEConfig":
        """vae/config.json (diffusers AutoencoderKL)."""
        return VAEConfig(
            in_channels=d["in_channels"],
            out_channels=d["out_channels"],
            block_out_channels=tuple(d["block_out_channels"]),
            layers_per_block=d["layers_per_block"],
            latent_channels=d["latent_channels"],
            norm_num_groups=d["norm_num_groups"],
            scaling_factor=d.get("scaling_factor", 0.18215),
            shift_factor=d.get("shift_factor", 0.0) or 0.0,
            mid_block_add_attention=d.get("mid_block_add_attention", True),
            use_quant_conv=d.get("use_quant_conv", True),
            use_post_quant_conv=d.get("use_post_quant_conv", True),
        )


def _resnet(p: Params, x: torch.Tensor, groups: int) -> torch.Tensor:
    """norm1-silu-conv1-norm2-silu-conv2 + (1x1 shortcut)."""
    h = group_norm(x, groups, p["norm1"]["w"], p["norm1"]["b"])
    h = conv2d(F.silu(h), p["conv1"], padding=_PAD1)
    h = group_norm(h, groups, p["norm2"]["w"], p["norm2"]["b"])
    h = conv2d(F.silu(h), p["conv2"], padding=_PAD1)
    if p.get("shortcut") is not None:
        x = conv2d(x, p["shortcut"])
    return x + h


def _attn_block(p: Params, x: torch.Tensor, groups: int) -> torch.Tensor:
    """Single-head self-attention over the HW tokens."""
    b, h, w, c = x.shape
    y = group_norm(x, groups, p["norm"]["w"], p["norm"]["b"])
    tokens = y.reshape(b, h * w, c)
    q = linear(tokens, p["q"])[:, None]
    k = linear(tokens, p["k"])[:, None]
    v = linear(tokens, p["v"])[:, None]
    attn = sdpa(q, k, v, impl="xla")[:, 0]
    return x + linear(attn, p["out"]).reshape(b, h, w, c)


def _mid(p: Params, x: torch.Tensor, groups: int) -> torch.Tensor:
    x = _resnet(p["res1"], x, groups)
    if p.get("attn") is not None:
        x = _attn_block(p["attn"], x, groups)
    return _resnet(p["res2"], x, groups)


def vae_decode(params: Params, cfg: VAEConfig, z_nhwc: torch.Tensor) -> torch.Tensor:
    """Latent NHWC [B, h, w, latent_channels] -> NHWC image in ~[-1, 1]."""
    p = params["decoder"]
    if params.get("post_quant_conv") is not None:
        z_nhwc = conv2d(z_nhwc, params["post_quant_conv"])
    g = cfg.norm_num_groups
    h = conv2d(z_nhwc, p["conv_in"], padding=_PAD1)
    h = _mid(p["mid"], h, g)
    for up in p["up"]:
        for res in up["resnets"]:
            h = _resnet(res, h, g)
        if up.get("upsample") is not None:
            h = conv2d(upsample_nearest_2x(h), up["upsample"], padding=_PAD1)
    h = group_norm(h, g, p["norm_out"]["w"], p["norm_out"]["b"])
    return conv2d(F.silu(h), p["conv_out"], padding=_PAD1)


def _vae_scale(cfg: VAEConfig) -> int:
    """Decoder spatial upsampling factor: one 2x per stage but the last
    (FLUX: 4 stages -> 8x)."""
    return 2 ** (len(cfg.block_out_channels) - 1)


def _ramp(blend: int, device) -> torch.Tensor:
    """arange(blend) / blend in f32, divided by a tensor: PyTorch's CUDA
    division by a Python scalar multiplies by the reciprocal instead."""
    r = torch.arange(blend, dtype=torch.float32, device=device)
    return r / torch.full_like(r, blend)


def _blend_v(a: torch.Tensor, b: torch.Tensor, blend: int) -> torch.Tensor:
    """Feather the top ``blend`` pixel rows of b against the bottom of a."""
    blend = min(blend, a.shape[1], b.shape[1])
    ramp = _ramp(blend, b.device)[None, :, None, None]
    mixed = (a[:, -blend:].float() * (1.0 - ramp) + b[:, :blend].float() * ramp).to(b.dtype)
    return torch.cat([mixed, b[:, blend:]], dim=1)


def _blend_h(a: torch.Tensor, b: torch.Tensor, blend: int) -> torch.Tensor:
    """Feather the left ``blend`` pixel columns of b against the right of a."""
    blend = min(blend, a.shape[2], b.shape[2])
    ramp = _ramp(blend, b.device)[None, None, :, None]
    mixed = (a[:, :, -blend:].float() * (1.0 - ramp) + b[:, :, :blend].float() * ramp).to(b.dtype)
    return torch.cat([mixed, b[:, :, blend:]], dim=2)


def _stitch(rows, blend: int, limit: int) -> torch.Tensor:
    """A grid of overlapping NHWC tiles (rows of columns) -> one map: each
    tile feathered over ``blend`` pixels against the tile above, then the
    tile to the left, cut to ``limit`` x ``limit`` and concatenated."""
    out_rows = []
    for i, row in enumerate(rows):
        parts = []
        for j, t in enumerate(row):
            if i > 0:
                t = _blend_v(rows[i - 1][j], t, blend)
            if j > 0:
                t = _blend_h(row[j - 1], t, blend)
            parts.append(t[:, :limit, :limit, :])
        out_rows.append(torch.cat(parts, dim=2))
    return torch.cat(out_rows, dim=1)


def _decode_tile(params: Params, cfg: VAEConfig, z: torch.Tensor) -> torch.Tensor:
    """One tile's decode: the seam through which callers see the tiles."""
    return vae_decode(params, cfg, z)


def vae_decode_tiled(params: Params, cfg: VAEConfig, z_nhwc: torch.Tensor,
                     tile: int = 128, overlap: int = 16) -> torch.Tensor:
    """Spatially tiled decode: latent tiles of ``tile`` x ``tile`` with
    ``overlap`` latent pixels of overlap, each decoded on its own (GroupNorm
    statistics per tile), the seams feathered linearly over ``overlap * f``
    pixels, first against the tile above, then against the tile to the
    left, and the result cropped to ``h * f`` x ``w * f``. A latent that fits
    one tile takes :func:`vae_decode` unchanged. Peak memory is one tile's
    decoder temporaries plus the decoded tiles."""
    b, h, w, _ = z_nhwc.shape
    if h <= tile and w <= tile:
        return vae_decode(params, cfg, z_nhwc)
    f = _vae_scale(cfg)
    overlap = max(1, min(overlap, tile // 2))
    stride = tile - overlap
    blend = overlap * f
    limit = stride * f
    rows = [[_decode_tile(params, cfg, z_nhwc[:, i:i + tile, j:j + tile, :])
             for j in range(0, w, stride)] for i in range(0, h, stride)]
    return _stitch(rows, blend, limit)[:, : h * f, : w * f, :]


def _encode_moments(params: Params, cfg: VAEConfig, x_nhwc: torch.Tensor) -> torch.Tensor:
    """Encoder tower up to (and including) the quant conv: the
    [B, h, w, 2 * latent_channels] mean|logvar moment plane."""
    p = params["encoder"]
    g = cfg.norm_num_groups
    h = conv2d(x_nhwc, p["conv_in"], padding=_PAD1)
    for down in p["down"]:
        for res in down["resnets"]:
            h = _resnet(res, h, g)
        if down.get("downsample") is not None:
            h = conv2d(h, down["downsample"], stride=2, padding=((0, 1), (0, 1)))
    h = _mid(p["mid"], h, g)
    h = group_norm(h, g, p["norm_out"]["w"], p["norm_out"]["b"])
    h = conv2d(F.silu(h), p["conv_out"], padding=_PAD1)
    if params.get("quant_conv") is not None:
        h = conv2d(h, params["quant_conv"])
    return h


def _gaussian_sample(h: torch.Tensor, eps: Optional[torch.Tensor]) -> torch.Tensor:
    """The diagonal Gaussian over the moments ``h``: ``mean + std * eps`` when
    a standard-normal draw ``eps`` of the mean's shape is given (cast to the
    mean's dtype, as JAX draws it), else the mode (the mean). std is
    exp(0.5 * logvar) in f32, cast back."""
    mean, logvar = torch.chunk(h, 2, dim=-1)
    if eps is None:
        return mean
    std = torch.exp(0.5 * logvar.float()).to(mean.dtype)
    return mean + std * eps.to(mean.dtype)


def vae_encode(params: Params, cfg: VAEConfig, x_nhwc: torch.Tensor,
               eps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Image NHWC in [-1, 1] -> latent NHWC [B, H/f, W/f, latent_channels]:
    a sample when the standard-normal draw ``eps`` is given, else the
    distribution's mode."""
    return _gaussian_sample(_encode_moments(params, cfg, x_nhwc), eps)


def vae_encode_tiled(params: Params, cfg: VAEConfig, x_nhwc: torch.Tensor,
                     eps: Optional[torch.Tensor] = None, tile: int = 1024,
                     overlap: int = 128) -> torch.Tensor:
    """Spatially tiled encode, the mirror of :func:`vae_decode_tiled`.
    ``tile`` and ``overlap`` are pixel sizes, rounded down to the encoder's
    stride f (overlap at least f, at most half a tile). Each tile's moments
    are computed on their own (GroupNorm statistics per tile), feathered over
    ``overlap / f`` latent pixels against the tile above, then the tile to
    the left, cropped to H/f x W/f and sampled once with ``eps``, so a
    tiling changes the moments and never the draw. An image that fits one
    tile takes :func:`vae_encode` unchanged."""
    b, h, w, _ = x_nhwc.shape
    if h <= tile and w <= tile:
        return vae_encode(params, cfg, x_nhwc, eps)
    f = _vae_scale(cfg)
    tile -= tile % f
    overlap = max(f, min(overlap - overlap % f, tile // 2))
    stride = tile - overlap
    blend = overlap // f
    limit = stride // f
    rows = [[_encode_moments(params, cfg, x_nhwc[:, i:i + tile, j:j + tile, :])
             for j in range(0, w, stride)] for i in range(0, h, stride)]
    return _gaussian_sample(_stitch(rows, blend, limit)[:, : h // f, : w // f, :], eps)
