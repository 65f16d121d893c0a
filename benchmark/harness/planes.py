"""The benchmark's weights: raw planes drawn on the device from the run's seed.

A frozen copy of the port's synthetic draws (the layouts and value scales of
``util/synthetic.py``), made in a few large calls: every quantized code of a
component comes from one ``randint`` into a flat buffer, every dense leaf
from one ``randn`` scaled per leaf, and the leaves are views into those
buffers. Scales, biases and norm weights are constants, as in the synthetic
factories. Nothing here imports the program: ``harness/port.py`` wraps these
planes in the port's containers, and ``reference/`` dequantizes the same
planes on its own.

The tree mirrors the port's parameter schema (diffusers layout: separate
q/k/v, stacked ``[L, ...]`` blocks), with the leaf types below.
"""

from __future__ import annotations

import dataclasses
import math
import zlib
from typing import Optional

import torch

# bitsandbytes' NF4 table (QLoRA, Dettmers et al. 2023)
NF4_CODEBOOK = (
    -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
    -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
    0.07958029955625534, 0.16093020141124725, 0.24611230194568634, 0.33791524171829224,
    0.44070982933044434, 0.5626170039176941, 0.7229568362236023, 1.0,
)
NF4_GROUP = 64


@dataclasses.dataclass
class Q8:
    """q8t: int8 codes ``[.., K, N]``, one f32 scale per (K-tile, column)."""

    codes: torch.Tensor
    scale: torch.Tensor
    group: int


@dataclasses.dataclass
class NF4:
    """bnb nf4: 4-bit codes nibble-packed ``[.., K/2, N]`` (split-block: in
    each ``split`` run of k, packed row r holds k-row r low and r + split/2
    high), one f32 scale per (64-row group, column), the 16-entry table."""

    packed: torch.Tensor
    scale: torch.Tensor
    codebook: torch.Tensor
    group: int
    split: int


@dataclasses.dataclass
class Lin:
    """A linear ``y = x @ w + b``, w ``[.., K, N]`` (dense, Q8 or NF4)."""

    w: object
    b: Optional[torch.Tensor] = None


@dataclasses.dataclass
class Cv:
    """A convolution, filter HWIO."""

    w: torch.Tensor
    b: Optional[torch.Tensor] = None


def split_of(k: int) -> int:
    for s in (256, 128, 64, 32, 16, 8, 4, 2):
        if k % s == 0:
            return s
    return k


def q8_group(k: int) -> int:
    g = min(256, k)
    while k % g:
        g //= 2
    return g


@dataclasses.dataclass
class _Pending:
    kind: str          # "s8", "u8" (codes) or "normal" (dense)
    shape: tuple
    std: float = 1.0


class _Draws:
    """Collects pending leaves, then fills them from one flat buffer per kind."""

    def __init__(self, dtype):
        self.dtype = dtype
        self.pending = []

    def take(self, kind, shape, std=1.0):
        p = _Pending(kind, tuple(shape), std)
        self.pending.append(p)
        return p

    def fill(self, tree, gen, device):
        totals = {}
        for p in self.pending:
            totals[p.kind] = totals.get(p.kind, 0) + math.prod(p.shape)
        flat, used = {}, {k: 0 for k in totals}
        for kind in sorted(totals):
            n = totals[kind]
            if kind == "s8":
                flat[kind] = torch.randint(-128, 128, (n,), generator=gen, dtype=torch.int8,
                                           device=device)
            elif kind == "u8":
                flat[kind] = torch.randint(0, 256, (n,), generator=gen, dtype=torch.uint8,
                                           device=device)
            else:
                flat[kind] = torch.randn((n,), generator=gen, dtype=torch.float32,
                                         device=device)

        def resolve(node):
            if isinstance(node, _Pending):
                n = math.prod(node.shape)
                t = flat[node.kind][used[node.kind]:used[node.kind] + n].view(node.shape)
                used[node.kind] += n
                if node.kind == "normal":
                    t = (t * node.std).to(self.dtype)
                return t
            if isinstance(node, dict):
                return {k: resolve(v) for k, v in node.items()}
            if isinstance(node, list):
                return [resolve(v) for v in node]
            if dataclasses.is_dataclass(node):
                return dataclasses.replace(node, **{
                    f.name: resolve(getattr(node, f.name)) for f in dataclasses.fields(node)})
            return node

        out = resolve(tree)
        del flat
        return out


def _qlin(d: _Draws, fmt: str, k: int, n: int, stack=None, bias=True, device="cuda"):
    lead = () if stack is None else (stack,)
    b = torch.zeros(lead + (n,), dtype=d.dtype, device=device) if bias else None
    if fmt == "q8t":
        g = q8_group(k)
        scale = torch.full(lead + (k // g, n), 2.0 * k ** -0.5 / 127.0, dtype=torch.float32,
                           device=device)
        return Lin(Q8(d.take("s8", lead + (k, n)), scale, g), b)
    if fmt == "nf4":
        cb = torch.tensor(NF4_CODEBOOK, dtype=torch.float32, device=device)
        if stack is not None:
            cb = cb[None].repeat(stack, 1)
        scale = torch.full(lead + (k // NF4_GROUP, n), 2.0 * k ** -0.5, dtype=torch.float32,
                           device=device)
        return Lin(NF4(d.take("u8", lead + (k // 2, n)), scale, cb, NF4_GROUP, split_of(k)), b)
    raise ValueError(f"unknown weight format {fmt!r}")


def flux_planes(cfg: dict, seed: int, device) -> dict:
    """FLUX transformer, every linear in ``cfg["formats"]["flux_linears"]``;
    norm scales ones, biases zeros."""
    d = _Draws(torch.bfloat16)
    fmt = cfg["formats"]["flux_linears"]
    h = cfg["num_attention_heads"] * cfg["attention_head_dim"]
    m = int(h * cfg.get("mlp_ratio", 4.0))
    hd = cfg["attention_head_dim"]
    L, S = cfg["num_layers"], cfg["num_single_layers"]

    def q(k, n, stack=None):
        return _qlin(d, fmt, k, n, stack, device=device)

    def ones(*shape):
        return torch.ones(shape, dtype=torch.bfloat16, device=device)

    def attn(st):
        return {"q": q(h, h, st), "k": q(h, h, st), "v": q(h, h, st), "proj": q(h, h, st),
                "q_norm": ones(st, hd), "k_norm": ones(st, hd)}

    tree = {
        "img_in": q(cfg["in_channels"], h),
        "txt_in": q(cfg["joint_attention_dim"], h),
        "time_in": {"in": q(256, h), "out": q(h, h)},
        "vector_in": {"in": q(cfg["pooled_projection_dim"], h), "out": q(h, h)},
        "double": {
            "img_mod": q(h, 6 * h, L), "txt_mod": q(h, 6 * h, L),
            "img_attn": attn(L), "txt_attn": attn(L),
            "img_mlp": {"in": q(h, m, L), "out": q(m, h, L)},
            "txt_mlp": {"in": q(h, m, L), "out": q(m, h, L)},
        },
        "single": {
            "q": q(h, h, S), "k": q(h, h, S), "v": q(h, h, S),
            "q_norm": ones(S, hd), "k_norm": ones(S, hd),
            "proj_mlp": q(h, m, S), "linear2": q(h + m, h, S), "mod": q(h, 3 * h, S),
        },
        "final": {"mod": q(h, 2 * h), "proj": q(h, cfg["in_channels"])},
    }
    if cfg["guidance_embeds"]:
        tree["guidance_in"] = {"in": q(256, h), "out": q(h, h)}
    return d.fill(tree, torch.Generator(device=device).manual_seed(seed), device)


def t5_planes(cfg: dict, seed: int, device) -> dict:
    """T5 encoder: block linears in ``cfg["formats"]["t5_linears"]`` (no
    biases), embedding and relative-position bias dense, norms ones."""
    t = cfg["text_encoder_2"]
    d = _Draws(torch.bfloat16)
    fmt = cfg["formats"]["t5_linears"]
    L, dm = t["num_layers"], t["d_model"]
    inner = t["num_heads"] * t["d_kv"]

    def q(k, n):
        return _qlin(d, fmt, k, n, stack=L, bias=False, device=device)

    tree = {
        "shared": d.take("normal", (t["vocab_size"], dm), dm ** -0.5),
        "rel_bias": d.take("normal", (t["relative_attention_num_buckets"], t["num_heads"])),
        "blocks": {
            "attn": {"q": q(dm, inner), "k": q(dm, inner), "v": q(dm, inner),
                     "o": q(inner, dm)},
            "attn_norm": torch.ones((L, dm), dtype=torch.bfloat16, device=device),
            "ff": {"wi_0": q(dm, t["d_ff"]), "wi_1": q(dm, t["d_ff"]), "wo": q(t["d_ff"], dm)},
            "ff_norm": torch.ones((L, dm), dtype=torch.bfloat16, device=device),
        },
        "final_norm": torch.ones((dm,), dtype=torch.bfloat16, device=device),
    }
    return d.fill(tree, torch.Generator(device=device).manual_seed(seed), device)


def clip_planes(cfg: dict, seed: int, device) -> dict:
    """CLIP-L text encoder, dense bf16."""
    c = cfg["text_encoder"]
    d = _Draws(torch.bfloat16)
    L, dm, ff = c["num_hidden_layers"], c["hidden_size"], c["intermediate_size"]

    def lin(k, n):
        return Lin(d.take("normal", (L, k, n), k ** -0.5),
                   torch.zeros((L, n), dtype=torch.bfloat16, device=device))

    def ln(*lead):
        return {"w": torch.ones(lead + (dm,), dtype=torch.bfloat16, device=device),
                "b": torch.zeros(lead + (dm,), dtype=torch.bfloat16, device=device)}

    tree = {
        "token_emb": d.take("normal", (c["vocab_size"], dm), 0.02),
        "pos_emb": d.take("normal", (c["max_position_embeddings"], dm), 0.02),
        "blocks": {
            "ln1": ln(L),
            "attn": {"q": lin(dm, dm), "k": lin(dm, dm), "v": lin(dm, dm), "out": lin(dm, dm)},
            "ln2": ln(L),
            "mlp": {"fc1": lin(dm, ff), "fc2": lin(ff, dm)},
        },
        "final_ln": ln(),
    }
    return d.fill(tree, torch.Generator(device=device).manual_seed(seed), device)


def vae_decoder_planes(cfg: dict, seed: int, device) -> dict:
    """The VAE decoder (HWIO filters, zero biases, unit norms), dense bf16."""
    v = cfg["vae"]
    d = _Draws(torch.bfloat16)

    def conv(kh, kw, cin, cout):
        return Cv(d.take("normal", (kh, kw, cin, cout), (kh * kw * cin) ** -0.5),
                  torch.zeros((cout,), dtype=torch.bfloat16, device=device))

    def gn(c):
        return {"w": torch.ones((c,), dtype=torch.bfloat16, device=device),
                "b": torch.zeros((c,), dtype=torch.bfloat16, device=device)}

    def lin(c):
        return Lin(d.take("normal", (c, c), c ** -0.5),
                   torch.zeros((c,), dtype=torch.bfloat16, device=device))

    def res(cin, cout):
        return {"norm1": gn(cin), "conv1": conv(3, 3, cin, cout), "norm2": gn(cout),
                "conv2": conv(3, 3, cout, cout),
                "shortcut": None if cin == cout else conv(1, 1, cin, cout)}

    boc = list(v["block_out_channels"])
    c = boc[-1]
    mid = {"res1": res(c, c),
           "attn": {"norm": gn(c), "q": lin(c), "k": lin(c), "v": lin(c), "out": lin(c)}
           if v.get("mid_block_add_attention", True) else None,
           "res2": res(c, c)}
    up = []
    for i, cout in enumerate(reversed(boc)):
        resnets = []
        for _ in range(v["layers_per_block"] + 1):
            resnets.append(res(c, cout))
            c = cout
        up.append({"resnets": resnets,
                   "upsample": conv(3, 3, cout, cout) if i != len(boc) - 1 else None})
    tree = {"decoder": {"conv_in": conv(3, 3, v["latent_channels"], boc[-1]), "mid": mid,
                        "up": up, "norm_out": gn(boc[0]),
                        "conv_out": conv(3, 3, boc[0], v["out_channels"])},
            "post_quant_conv": None}
    return d.fill(tree, torch.Generator(device=device).manual_seed(seed), device)


def model_planes(cfg: dict, seed: int, device) -> dict:
    """Every component's planes from one run seed (each component its own
    generator, seeded from the run seed and the component's index)."""
    base = (int(seed) * 4) % (1 << 62)
    return {"flux": flux_planes(cfg, base, device),
            "t5": t5_planes(cfg, base + 1, device),
            "clip": clip_planes(cfg, base + 2, device),
            "vae": vae_decoder_planes(cfg, base + 3, device)}


class WordTokenizer:
    """The synthetic-weight runs' tokenizer (frozen copy of the port's): each
    word maps to ``crc32(word) % (vocab - 2) + 1``."""

    class _Enc:
        def __init__(self, ids):
            self.ids = ids

    def __init__(self, vocab_size: int):
        self.vocab = vocab_size

    def ids(self, prompt: str):
        return [zlib.crc32(w.encode()) % (self.vocab - 2) + 1 for w in prompt.split()]

    def encode_batch(self, prompts):
        return [self._Enc(self.ids(p)) for p in prompts]
