"""Text-to-image in plain float32 (T5 in the precision the configuration
states, encoders.t5_encode), for one request: tokenize, T5 + CLIP encode,
the seed's latent noise, the flow-match Euler loop over the
configuration's sigma schedule, the VAE decode and the u8 conversion.

It works out everything the port derives from a request again: the token
ids (the benchmark's tokenizer), the noise (the port's documented draw: a
float32 ``torch.randn`` of [1, 16, 2 ceil(H/16), 2 ceil(W/16)] from a
``torch.Generator`` on the device seeded with the request's seed), the
schedule, the RoPE tables and the dequantized weights."""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.harness.planes import WordTokenizer

from .common import Precision, strict_float32
from .encoders import clip_pooled, t5_encode
from .flux import Flux, img_ids, rope_tables
from .vae import decode


def sigmas(cfg: dict, height: int, width: int, steps: int) -> np.ndarray:
    """FlowMatchEulerDiscrete sigmas 1 -> 0 (steps + 1 values, float32)."""
    sc = cfg["scheduler"]
    s = np.linspace(1.0, 0.0, steps + 1)
    if sc.get("use_dynamic_shifting", False):
        seq = ((height + 15) // 16) * ((width + 15) // 16)
        m = (sc["max_shift"] - sc["base_shift"]) / (sc["max_image_seq_len"]
                                                    - sc["base_image_seq_len"])
        mu = seq * m + sc["base_shift"] - m * sc["base_image_seq_len"]
        e = math.exp(mu)
        with np.errstate(divide="ignore"):
            out = e / (e + (1.0 / s - 1.0))
        out[s == 0.0] = 0.0
    else:
        sh = sc.get("shift", 1.0)
        out = sh * s / (1.0 + (sh - 1.0) * s)
    return out.astype(np.float32)


def noise(seed: int, height: int, width: int, device) -> torch.Tensor:
    h, w = (height + 15) // 16 * 2, (width + 15) // 16 * 2
    gen = torch.Generator(device=device).manual_seed(int(seed))
    return torch.randn((1, 16, h, w), generator=gen, dtype=torch.float32, device=device)


def token_ids(cfg: dict, prompt: str, device):
    g = cfg["generation"]
    t5 = WordTokenizer(cfg["text_encoder_2"]["vocab_size"]).ids(prompt)
    n = g["max_sequence_length"]
    if len(t5) > n:
        raise ValueError(f"prompt of {len(t5)} T5 tokens over {n}")
    t5_ids = torch.zeros((1, n), dtype=torch.long, device=device)
    t5_ids[0, :len(t5)] = torch.tensor(t5, dtype=torch.long)
    clip = WordTokenizer(cfg["text_encoder"]["vocab_size"]).ids(prompt)
    clip = clip[:cfg["text_encoder"]["max_position_embeddings"]]
    return t5_ids, torch.tensor([clip], dtype=torch.long, device=device)


def to_u8(img_nchw: torch.Tensor) -> np.ndarray:
    """[-1, 1] -> u8 NHWC: (clamp + 1) * 127.5, truncated."""
    x = ((img_nchw.clamp(-1.0, 1.0) + 1.0) * 127.5).clamp(0, 255)
    return x.to(torch.uint8).permute(0, 2, 3, 1).cpu().numpy()[0]


def latent(cfg: dict, planes: dict, prompt: str, seed: int, height: int, width: int,
           device, prec: Precision = None, z: torch.Tensor = None) -> torch.Tensor:
    """The request's packed latent after the Euler loop, [1, S_img, 64] f32,
    from the initial noise ``z`` [1, 16, h, w] (None: the seed's)."""
    prec = prec or Precision("float32")
    g = cfg["generation"]
    with strict_float32():
        t5_ids, clip_ids = token_ids(cfg, prompt, device)
        txt = t5_encode(cfg, planes["t5"], t5_ids, prec)
        y = clip_pooled(cfg, planes["clip"], clip_ids, prec)
        z = noise(seed, height, width, device) if z is None else z
        _, c, lh, lw = z.shape
        x = z.view(1, c, lh // 2, 2, lw // 2, 2).permute(0, 2, 4, 1, 3, 5).reshape(
            1, lh // 2 * (lw // 2), c * 4)
        ids = torch.cat([torch.zeros((1, txt.shape[1], 3), device=device),
                         img_ids(lh // 2, lw // 2, device)], 1)
        cos, sin = rope_tables(ids, cfg["axes_dims_rope"])
        model = Flux(cfg, planes["flux"], prec)
        gv = torch.full((1,), float(g["guidance_scale"]), device=device)
        sig = sigmas(cfg, height, width, g["num_steps"])
        for i in range(len(sig) - 1):
            t = torch.full((1,), float(sig[i]), device=device)
            v = model.forward(x, txt, t, y, gv, cos, sin)
            x = x + v * float(sig[i + 1] - sig[i])
        return x


def decode_u8(cfg: dict, planes: dict, x: torch.Tensor, height: int, width: int,
              prec: Precision = None) -> np.ndarray:
    """Packed latent [1, S_img, 64] -> the u8 image [H, W, 3]."""
    prec = prec or Precision("float32")
    lh, lw = (height + 15) // 16 * 2, (width + 15) // 16 * 2
    c = x.shape[-1] // 4
    with strict_float32():
        lat = x.view(1, lh // 2, lw // 2, c, 2, 2).permute(0, 3, 1, 4, 2, 5).reshape(
            1, c, lh, lw)
        v = cfg["vae"]
        return to_u8(decode(cfg, planes["vae"], lat / v["scaling_factor"] + v["shift_factor"],
                            prec))


def image(cfg: dict, planes: dict, prompt: str, seed: int, height: int, width: int,
          device, prec: Precision = None):
    """The request's packed latent [S_img, 64] f32 and u8 image [H, W, 3]."""
    x = latent(cfg, planes, prompt, seed, height, width, device, prec)
    return x[0], decode_u8(cfg, planes, x, height, width, prec)
